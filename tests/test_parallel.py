"""Multi-chip sharding: the encode step under shard_map on the virtual
8-device CPU mesh must execute and produce frames byte-identical to the
single-device pipeline."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from zigflac_tpu.metadata import StreamInfo
from zigflac_tpu.models.pipeline import DevicePipeline
from zigflac_tpu.parallel.mesh import default_mesh, encode_compact_sharded
from zigflac_tpu.utils.config import EncoderConfig

from conftest import make_signal


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU mesh")
    return default_mesh(jax.devices())


def test_sharded_matches_single(rng, mesh):
    """The production SPMD program (encode_compact_sharded) produces frame
    bytes identical to the single-device pipeline, with per-shard metadata
    rows and the global-overflow collective all agreeing."""
    B = 256
    ndev = mesh.devices.size
    nf = 2 * ndev
    cfg = EncoderConfig(block_size=B, channels="stereo_auto")
    samples = make_signal(rng, nf * B, channels=2, depth=16, kind="mixed")
    frames = samples.reshape(2, nf, B).transpose(1, 0, 2)
    info = StreamInfo(44100, 2, 16, nf * B, B, B)

    stream, meta, frame_cap = encode_compact_sharded(
        jnp.asarray(frames),
        jnp.asarray(np.arange(nf, dtype=np.int64)),
        cfg,
        depth=16,
        sample_rate=44100,
        tier=0,
        deposit="segsum",
        mesh=mesh,
    )
    meta_np = np.asarray(meta)
    per_shard = meta_np.shape[1] - 3
    assert meta_np.shape[0] == ndev and per_shard == nf // ndev
    assert (meta_np[:, -2] == 0).all() and (meta_np[:, -1] == 0).all()

    from zigflac_tpu.models.pipeline import _collect_aligned

    sharded = b""
    sizes = []
    for s in range(ndev):
        got = _collect_aligned((stream[s], meta[s, :-1]), per_shard, frame_cap)
        assert got is not None
        sharded += got[0]
        sizes.extend(got[1].tolist())

    import os

    os.environ["ZIGFLAC_MESH"] = "0"
    try:
        pipe = DevicePipeline(cfg, 16, batch_size=nf)
        assert pipe._mesh is None
        single = pipe.encode_frames(frames, 0, info)
    finally:
        del os.environ["ZIGFLAC_MESH"]
    assert sharded == b"".join(single)
    assert sizes == [len(b) for b in single]


def test_sharded_overflow_stays_sharded(rng, mesh):
    """Incompressible (tier-1) content on the mesh path: overflowing shards
    re-encode through the capacity ladder individually — the batch is never
    de-sharded — and bytes still match golden exactly."""
    import io

    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.models import pipeline as pl
    from zigflac_tpu.wav import write_wav

    B = 1024
    cfg = EncoderConfig(block_size=B, channels="stereo_auto")
    nf = 2 * mesh.devices.size
    # full-scale noise: every frame needs verbatim subframes, which
    # out-size the tier-0 compact stream budget on every shard (B is
    # large enough that the ALIGN_W group-padding slack in the budget
    # stays small relative to the frames)
    samples = make_signal(rng, nf * B, channels=2, depth=16, kind="noise")
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.int32), 44100, 16)
    wav_bytes = buf.getvalue()

    calls = []
    real_overflow = pl.DevicePipeline._encode_overflow

    def spy(self, chunk, nreal, fns, c, Bv, info):
        calls.append(chunk.shape[0])
        return real_overflow(self, chunk, nreal, fns, c, Bv, info)

    pipe = pl.DevicePipeline(cfg, 16)
    assert pipe._mesh is not None
    per_shard_max = -(-nf // pipe._mesh.devices.size)
    try:
        pl.DevicePipeline._encode_overflow = spy
        sharded = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    finally:
        pl.DevicePipeline._encode_overflow = real_overflow
    golden = encode_wav_bytes(wav_bytes, config=cfg, backend="golden")
    assert sharded == golden
    assert calls, "tier-1 content should have tripped the ladder"
    assert all(n <= per_shard_max for n in calls), (
        f"overflow re-encode de-sharded the batch: {calls}"
    )


def test_sharded_ragged_batch_with_partial_overflow(rng, mesh):
    """A production-shaped worst case on the mesh: a
    frame count NOT divisible by the mesh size (exercising the pad at
    DevicePipeline.dispatch_batch) where only SOME shards carry
    incompressible rows — those shards alone must re-encode through the
    ladder (including any shard whose rows are partly batch padding), and
    the assembled stream must be byte-identical to single-device and
    golden."""
    import io
    import os

    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.models import pipeline as pl
    from zigflac_tpu.wav import write_wav

    B = 1024
    cfg = EncoderConfig(block_size=B, channels="stereo_auto")
    ndev = mesh.devices.size
    # nf chosen so bucket = next_pow2(nf) > nf: the batch gets padding rows
    nf = 2 * ndev + 3
    # tonal head, full-scale-noise tail: the LAST shards (including the one
    # sharing rows with the batch padding, which repeats the final noise
    # frame) overflow tier 0; the head shards must NOT re-encode
    tonal = make_signal(rng, (nf - ndev) * B, channels=2, depth=16,
                        kind="mixed")
    noise = make_signal(rng, ndev * B, channels=2, depth=16, kind="noise")
    samples = np.concatenate([tonal, noise], axis=1)
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.int32), 44100, 16)
    wav_bytes = buf.getvalue()

    calls = []
    real_overflow = pl.DevicePipeline._encode_overflow

    def spy(self, chunk, nreal, fns, c, Bv, info):
        calls.append((chunk.shape[0], nreal))
        return real_overflow(self, chunk, nreal, fns, c, Bv, info)

    pipe = pl.DevicePipeline(cfg, 16)
    assert pipe._mesh is not None
    bucket = 1 << (nf - 1).bit_length()
    per_shard = bucket // ndev
    try:
        pl.DevicePipeline._encode_overflow = spy
        sharded = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    finally:
        pl.DevicePipeline._encode_overflow = real_overflow
    golden = encode_wav_bytes(wav_bytes, config=cfg, backend="golden")
    assert sharded == golden
    assert calls, "noise shards should have tripped the ladder"
    # every ladder re-encode stayed shard-sized, and at least the head
    # shard (pure tonal rows) never re-encoded
    assert all(n == per_shard for n, _ in calls), calls
    assert len(calls) < -(-nf // per_shard), (
        f"every shard re-encoded ({calls}); the partial-overflow case "
        "degenerated to a whole-batch ladder"
    )

    os.environ["ZIGFLAC_MESH"] = "0"
    try:
        assert pl.DevicePipeline(cfg, 16)._mesh is None
        single = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    finally:
        del os.environ["ZIGFLAC_MESH"]
    assert sharded == single


def test_graft_entry_compiles(mesh):
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    words, total_bits, crcs = out
    assert np.asarray(total_bits).min() > 0


def test_graft_dryrun_multichip(mesh):
    import sys, os

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as ge

    ge.dryrun_multichip(min(len(jax.devices()), 8))


def test_product_pipeline_shards_by_default(rng, mesh):
    """DevicePipeline auto-shards over all local devices: encode_wav_bytes
    on the virtual 8-CPU mesh is byte-identical to forced single-device
    (ZIGFLAC_MESH=0) and to golden."""
    import io
    import os

    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.models.pipeline import DevicePipeline as DP
    from zigflac_tpu.wav import write_wav

    B = 512
    cfg = EncoderConfig(block_size=B)
    samples = make_signal(rng, 11 * B + 100, channels=2, depth=16, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.int32), 44100, 16)
    wav_bytes = buf.getvalue()

    pipe = DP(cfg, 16)
    assert pipe._mesh is not None and pipe._mesh.devices.size >= 2

    sharded = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    golden = encode_wav_bytes(wav_bytes, config=cfg, backend="golden")
    assert sharded == golden

    os.environ["ZIGFLAC_MESH"] = "0"
    try:
        assert DP(cfg, 16)._mesh is None
        single = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    finally:
        del os.environ["ZIGFLAC_MESH"]
    assert sharded == single


def test_product_pipeline_shards_lpc(rng, mesh):
    """LPC mode through the auto-sharded production pipeline: the
    host-derived coefficient arrays ride the mesh as frame-sharded
    program inputs (mesh._sharded_compact_fn n_lpc_args path) and the
    bytes match golden exactly."""
    import io

    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.models.pipeline import DevicePipeline as DP
    from zigflac_tpu.wav import write_wav

    B = 512
    cfg = EncoderConfig(block_size=B, prediction="lpc", lpc_order=4)
    samples = make_signal(rng, 9 * B, channels=2, depth=16, kind="sine")
    buf = io.BytesIO()
    write_wav(buf, samples.astype(np.int32), 44100, 16)
    wav_bytes = buf.getvalue()

    assert DP(cfg, 16)._mesh is not None
    sharded = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
    golden = encode_wav_bytes(wav_bytes, config=cfg, backend="golden")
    assert sharded == golden


def test_distributed_helpers_single_process(mesh):
    """Process-topology helpers degrade exactly in the 1-process case:
    the whole frame range is local, allgather is identity, and
    initialize(num_processes=1) is a no-op (no coordination service)."""
    from zigflac_tpu.parallel import distributed as dist

    assert dist.initialize(num_processes=1) is False
    assert dist.process_count() == 1 and dist.process_index() == 0
    ndev = mesh.devices.size
    lo, hi = dist.local_row_bounds(mesh, 4 * ndev)
    assert (lo, hi) == (0, 4 * ndev)
    with pytest.raises(ValueError):
        dist.local_row_bounds(mesh, 4 * ndev + 1)  # not divisible
    payload, sizes = dist.allgather_parts(
        b"abc", np.array([1, 2], np.int64))
    assert payload == b"abc" and sizes.tolist() == [1, 2]
    # empty contribution stays well-formed
    payload, sizes = dist.allgather_parts(b"", np.zeros(0, np.int64))
    assert payload == b"" and sizes.size == 0


def test_make_global_batch_row_sharded(mesh):
    """make_global_batch row-shards local rows over the frame axis with
    the expected global view (single-process: local == global)."""
    from jax.sharding import PartitionSpec as P

    from zigflac_tpu.parallel import distributed as dist

    ndev = mesh.devices.size
    rows = np.arange(ndev * 6, dtype=np.int32).reshape(ndev, 6)
    garr = dist.make_global_batch(mesh, P("frames"), rows, rows.shape)
    assert garr.shape == rows.shape
    np.testing.assert_array_equal(np.asarray(garr), rows)
    assert len(garr.addressable_shards) == ndev
