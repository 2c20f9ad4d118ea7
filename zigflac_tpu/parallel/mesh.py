"""Multi-chip scaling: frame-axis data parallelism over a device mesh.

The reference is single-threaded with no communication backend (SURVEY.md §2
checklist); the accelerator equivalent is SPMD over a ``jax.sharding.Mesh``
with the frame batch sharded across devices. Frames are independent, so the
design keeps cross-shard traffic minimal: packed bytes stay sharded (the
host assembles per shard, in frame order), and the one collective between
devices is the global capacity-overflow any-reduce (``lax.pmax`` over the mesh
axis) so every shard's metadata row reports whether ANY chip tripped its
deposit-window budget. STREAMINFO's min/max frame sizes intentionally stay
on host: the reference's running-max update rule (metadata.zig quirk) is
order-dependent, so a plain cross-shard min/max would be wrong.

``encode_compact_sharded`` is the production SPMD surface — the same
tiered compact-stream program the single-device pipeline runs, under
``shard_map`` so XLA sees one program per chip.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..utils.config import EncoderConfig
from ..ops.bitpack import max_frame_words
from ..ops.header import header_static

FRAME_AXIS = "frames"


def default_mesh(devices=None) -> Mesh:
    """1-D frame-axis mesh over all (global) devices. After
    parallel.distributed.initialize() jax.devices() spans every host, so
    the same mesh/shard_map programs scale from one host to many. The
    mesh is 1-D and follows the algorithm alone: a host's cards reach each
    other all to all, so no topology shape applies. Devices sort
    process-major so each process owns one CONTIGUOUS frame-row range
    (distributed.local_row_bounds relies on this)."""
    devices = list(devices if devices is not None else jax.devices())
    devices.sort(key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devices), (FRAME_AXIS,))


_MESHES = {}


def _encode_shard_compact(frames, frame_numbers, *, config, depth,
                          hstatic, block_size, max_words, capb, deposit,
                          speculate):
    """Per-shard production compact-stream encode: each chip packs and
    byte-compacts its local frames; the host assembles shard streams in
    frame order. The metadata row grows one entry: the global overflow
    any-reduce (``pmax`` over the mesh), alongside the local flag — the host can
    read any single row to learn whether the whole batch needs the capacity
    ladder, while the local flags still say which shard to re-encode."""
    from ..models.pipeline import _encode_batch_compact

    stream, meta = _encode_batch_compact(
        frames, frame_numbers, config=config, depth=depth,
        hstatic=hstatic, block_size=block_size, max_words=max_words,
        capb=capb, deposit=deposit, speculate=speculate,
    )
    # meta = [frame_bytes..., total_words, overflow_local]; append the
    # cross-shard any-overflow
    ovf_any = jax.lax.pmax(meta[-1], FRAME_AXIS)
    meta = jnp.concatenate([meta, ovf_any[None]])
    return stream[None], meta[None]


@lru_cache(maxsize=32)
def _sharded_compact_fn(config: EncoderConfig, depth: int, c: int,
                        block_size: int, sample_rate: int, tier: int,
                        batch_local: int, deposit: str, mesh_key):
    """The sharded twin of pipeline._compiled_encode_compact: one SPMD
    program over the mesh, each shard running the tier's compact program on
    ``batch_local`` frames. Returns (fn, per-frame word cap in bytes)."""
    from ..models.pipeline import CAPACITY_LADDER

    mesh = _MESHES[mesh_key]
    hstatic = header_static(block_size, sample_rate, depth)
    n_wire = 2 if config.stereo_auto else c
    stream_ratio, words_ratio = CAPACITY_LADDER[tier]
    max_words = max_frame_words(block_size, n_wire, depth, words_ratio)
    from ..ops.bitpack import ALIGN_W

    raw_bytes = batch_local * block_size * c * max(depth, 8) // 8
    # slack mirrors pipeline._compiled_encode_compact: per-frame ALIGN_W
    # group round-up + headroom
    capb = int(raw_bytes * stream_ratio) + (4 * ALIGN_W + 32) * batch_local
    if deposit == "windowed" and tier > 0:
        deposit = "windowed_pair"  # mirrors pipeline: tier-1 forces pairs
    fn = partial(
        _encode_shard_compact,
        config=config,
        depth=depth,
        hstatic=hstatic,
        block_size=block_size,
        max_words=max_words,
        capb=capb,
        deposit=deposit,
        speculate=tier == 0,
    )
    mapped = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
        out_specs=(P(FRAME_AXIS), P(FRAME_AXIS)),
    )
    return jax.jit(mapped), max_words * 4


def encode_compact_sharded(
    frames: jnp.ndarray,
    frame_numbers: jnp.ndarray,
    config: EncoderConfig,
    depth: int,
    sample_rate: int,
    tier: int,
    deposit: str,
    mesh: Mesh,
):
    """Production sharded encode: [N, C, B] frames (N divisible by mesh
    size) -> (stream u32 [ndev, capw_local], meta i64 [ndev, local+3]).
    Row s of each output is shard s's compact stream / metadata vector
    ([sizes..., total_words, overflow_local, overflow_any]), in frame
    order — the host collects each row exactly like a single-device batch,
    and re-encodes only overflowing shards through the capacity ladder.
    LPC mode needs no extra inputs: coefficients derive in-program from
    each shard's own lag sums (ops/lpc.fixed_point_levinson)."""
    mesh_key = tuple(d.id for d in mesh.devices.flat)
    _MESHES[mesh_key] = mesh
    n, c, B = frames.shape
    ndev = mesh.devices.size
    if n % ndev != 0:
        raise ValueError(f"frame count {n} not divisible by mesh size {ndev}")
    fn, frame_cap = _sharded_compact_fn(
        config, depth, c, B, sample_rate, tier, n // ndev, deposit, mesh_key
    )
    stream, meta = fn(frames, frame_numbers)
    return stream, meta, frame_cap
