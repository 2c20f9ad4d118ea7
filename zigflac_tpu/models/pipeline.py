"""DevicePipeline — the batched accelerator encode path.

frames [N, C, B] PCM  ──(device)──>  dense frame-stream bytes + sizes
                                       │
                          (host) slice + write — no per-frame work

One jitted program per (batch, block) shape covers plane construction,
stereo-mode + subframe selection, Rice search, bit packing, CRC-16, and
byte-level stream compaction — everything between the WAV feeder and the
output file (replaces libFLAC/{samples,fixed,rice}.zig + FrameWriter.zig +
Crc16.zig).

Host<->device traffic is kept small: inputs ship as int16 when the bit
depth allows, outputs come back as one dense u8 stream sized by a capacity
ladder (compressed-size budget -> verbatim-size budget -> exact padded
words), and batches are dispatched asynchronously so transfers overlap
compute.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..metadata import StreamInfo
from ..utils.config import EncoderConfig
from ..ops.analyze import plan_frames
from ..ops.bitpack import (
    compact_stream_aligned,
    deposit_crc16,
    max_frame_words,
    pack_frames,
)
from ..ops.crc16 import crc16_words
from ..ops.header import HeaderStatic, header_static

DEFAULT_BATCH = 1024

# Host<->device transfer accounting (bench.py's budget table): every
# dispatch adds its input bytes, every collect its fetched bytes (stream
# pages + metadata) and the fetch overshoot (page round-up past the needed
# words).
TRANSFER_STATS = {"h2d_bytes": 0, "d2h_bytes": 0, "d2h_overshoot_bytes": 0}


def reset_transfer_stats() -> dict:
    for k in TRANSFER_STATS:
        TRANSFER_STATS[k] = 0
    return TRANSFER_STATS

# Ragged tail frames at or above this size encode on device at their exact
# block size (one extra compiled shape per distinct tail length, batch 1);
# smaller tails go through the golden host oracle. 64 safely clears the
# warmup-slice floor (max fixed order 4, max LPC order 32).
TAIL_DEVICE_MIN = 64


def device_tail_enabled() -> bool:
    """Tail frames ride the device path by default; ZIGFLAC_DEVICE_TAIL=0
    opts out (each distinct tail length compiles its own batch-1 program,
    which a run encoding many files with distinct tails may not want)."""
    import os

    return os.environ.get("ZIGFLAC_DEVICE_TAIL", "1") != "0"


# The deposit path (ops/bitpack.pack_frames) each platform runs, chosen by
# an A/B of the 1024-frame config-1 and LPC batches on the platform (see
# PERF.md). Segment-sum scatters are cheap on the CPU, where the windowed
# path's compare-reduce and byte-plane matmuls are not.
DEPOSIT_BY_PLATFORM = {"cpu": "segsum", "gpu": "windowed"}


def _default_deposit() -> str:
    """The deposit path for the default device's platform; a platform
    without a measured choice is an error."""
    platform = jax.devices()[0].platform
    if platform not in DEPOSIT_BY_PLATFORM:
        raise RuntimeError(
            f"no deposit path chosen for platform {platform!r}; "
            f"known: {sorted(DEPOSIT_BY_PLATFORM)}"
        )
    return DEPOSIT_BY_PLATFORM[platform]


def _product_mesh():
    """The mesh the production pipeline shards over: all local devices when
    there is more than one (SURVEY §5: frame-axis data parallelism is the
    framework's scaling story — the reference has no backend at all).
    ZIGFLAC_MESH=0 forces single-device. None means single-device."""
    import os

    if os.environ.get("ZIGFLAC_MESH", "1") == "0":
        return None
    devices = jax.devices()
    if len(devices) < 2:
        return None
    from ..parallel.mesh import default_mesh

    return default_mesh(devices)
# capacity ladder: (output-stream budget, per-frame word budget) as
# fractions of raw PCM bytes. Tier 0 covers typical audio; tier 1 covers
# all-verbatim frames; the exact-worst-case padded-words path is the final
# fallback. Packing + CRC cost scale with the word budget.
CAPACITY_LADDER = ((0.75, 1.25), (1.15, None))


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


@lru_cache(maxsize=16)
def _dyn_page(total_words: int, page_words: int):
    """Jitted dynamic-offset page fetch: ONE compiled program per stream
    shape serves every tail offset (static-slice programs would recompile
    per distinct offset)."""

    @partial(jax.jit, static_argnums=())
    def fetch(stream, start):
        return jax.lax.dynamic_slice(stream, (start,), (page_words,))

    return fetch


def _prefetch_meta(meta) -> None:
    """Start the d2h copy of a batch's metadata vector as soon as the
    program is dispatched, so by collect time the ~8 KB row is already host
    resident and collect does not wait a round trip for it. Only a fully
    addressable array can be copied as one: under multi-process sharding
    each process holds just its own rows, and collect_batch fetches those
    shard by shard instead."""
    if meta.is_fully_addressable:
        meta.copy_to_host_async()


def _collect_aligned(out, nreal: int, frame_cap: int):
    """Fetch one batch's word-aligned compact stream and tighten it to the
    exact frame-byte concatenation. None on capacity overflow."""
    from ..native import assemble_ranges

    from ..ops.bitpack import ALIGN_W

    stream, meta = out
    meta = np.asarray(meta)  # single round trip: sizes + total + overflow
    TRANSFER_STATS["d2h_bytes"] += meta.nbytes
    if meta[-1] != 0:
        return None  # a symbol group out-spanned its deposit window
    fsz = meta[:nreal].astype(np.int64)
    if int(fsz.max()) > frame_cap:
        return None  # some frame out-sized its per-frame word budget
    # frames start on ALIGN_W-word groups in the compact stream (mirrors
    # ops/bitpack.compact_stream_aligned's layout)
    gcnt = (fsz + 4 * ALIGN_W - 1) // (4 * ALIGN_W)
    woff = (np.cumsum(gcnt) - gcnt) * ALIGN_W
    need = int((woff[-1] // ALIGN_W + gcnt[-1]) * ALIGN_W)
    # real frames are the stream prefix; padded tail frames may overflow
    if need > stream.shape[0]:
        return None
    # fetch only the used pages (fixed-size slices keep shapes static, so
    # the page-slice programs compile once; d2h moves ~actual bytes).
    # Pages are fetched OVERLAPPED: issue copy_to_host_async on every page
    # first, then consume, so the copies run concurrently. 4 MB pages keep
    # the slice-program count tiny. The LAST partial page narrows to 1 MB
    # dynamic-offset slices (one compiled program per stream shape, any
    # offset) so the average fetch overshoot drops from ~2 MB to ~0.5.
    P = 1 << 20  # 1Mi words = 4 MB per page
    SP = 1 << 18  # 256Ki words = 1 MB tail pages
    total = stream.shape[0]
    fetched = need
    if need >= total or total <= SP:
        sw = np.asarray(stream)[:need]
        fetched = total
    else:
        import os

        seq = os.environ.get("ZIGFLAC_FETCH_SEQ", "0") == "1"  # A/B knob
        if seq:  # whole 4 MB pages, blocking fetches
            npages = (need + P - 1) // P
            if npages * P >= total:
                sw = np.asarray(stream)[:need]
                fetched = total
            else:
                sw = np.concatenate(
                    [np.asarray(stream[i * P : (i + 1) * P])
                     for i in range(npages)]
                )[:need]
                fetched = npages * P
        else:
            nfull = need // P
            slices = [stream[i * P : (i + 1) * P] for i in range(nfull)]
            drops = [0] * nfull
            ds = _dyn_page(total, SP)
            pos = nfull * P
            while pos < need:
                start = min(pos, total - SP)  # never slice past the end
                slices.append(ds(stream, start))
                drops.append(pos - start)
                pos = start + SP
            for s in slices:
                s.copy_to_host_async()
            sw = np.concatenate(
                [np.asarray(s)[d:] for s, d in zip(slices, drops)]
            )[:need]
            fetched = sum(s.shape[0] for s in slices)
    TRANSFER_STATS["d2h_bytes"] += 4 * fetched
    TRANSFER_STATS["d2h_overshoot_bytes"] += 4 * (fetched - need)
    return assemble_ranges(sw.astype(">u4").tobytes(), woff, fsz), fsz


class DevicePipeline:
    """Holds the jit cache + static config for one (config, bit_depth)."""

    def __init__(
        self,
        config: EncoderConfig,
        bit_depth: int,
        batch_size: int = DEFAULT_BATCH,
    ) -> None:
        self.config = config
        self.bit_depth = bit_depth
        self.batch_size = batch_size
        self._mesh = _product_mesh()  # None = single device

    def _encode_batch_fn(self, n: int, c: int, block_size: int, sample_rate: int):
        """Words-path program (tests, mesh parity, capacity fallback)."""
        return _compiled_encode_batch(
            self.config, self.bit_depth, c, block_size, sample_rate
        )

    def _compact_fn(self, c: int, block_size: int, sample_rate: int, tier: int,
                    batch: int):
        return _compiled_encode_compact(
            self.config, self.bit_depth, c, block_size, sample_rate, tier, batch
        )

    def _feed(self, chunk: np.ndarray) -> np.ndarray:
        if self.bit_depth <= 16:
            chunk = chunk.astype(np.int16)  # halves the h2d volume
        TRANSFER_STATS["h2d_bytes"] += chunk.nbytes
        return chunk

    # -- public API ---------------------------------------------------------

    def encode_frames_stream(
        self,
        frames: np.ndarray,
        first_frame_number: int,
        info: StreamInfo,
        frame_numbers: np.ndarray | None = None,
        tail: np.ndarray | None = None,
        overlap_work=None,
    ) -> Tuple[bytes, np.ndarray]:
        """[F, C, B] PCM int32 full frames -> (frame-stream bytes, sizes).

        ``frame_numbers`` overrides the default consecutive numbering (used
        by the batched multi-file path, where numbering restarts per file).
        ``tail`` is an optional ragged final frame ``[C, rem]`` (rem < B),
        encoded on device at its exact block size and numbered after the
        full frames; its dispatch overlaps the main batches' collection, so
        the per-file tail adds no wall-clock on a busy pipeline
        (src/wav2flac.zig:64-75 encodes it as just another frame).
        ``overlap_work`` is an optional host callback run after every batch
        has been dispatched and before collection blocks — serial host work
        (the raw-PCM MD5) rides the device-compute + d2h window for free.
        """
        f, c, B = frames.shape
        bs = self.batch_size
        if frame_numbers is None:
            frame_numbers = first_frame_number + np.arange(f, dtype=np.int64)

        # dispatch all batches asynchronously (tier-0 capacity)
        pending = []
        for start in range(0, f, bs):
            chunk = frames[start : start + bs]
            fns = frame_numbers[start : start + chunk.shape[0]]
            pending.append(self.dispatch_batch(chunk, fns, info))
        if tail is not None:
            pending.append(
                self.dispatch_tail(tail, first_frame_number + f, info)
            )
        if overlap_work is not None:
            overlap_work()

        # collect in order; d2h of batch k overlaps compute of k+1..
        chunks: List[bytes] = []
        sizes: List[np.ndarray] = []
        for p in pending:
            got = self.collect_batch(p, info)
            chunks.append(got[0])
            sizes.append(got[1])
        return b"".join(chunks), (
            np.concatenate(sizes) if sizes else np.zeros(0, np.int64)
        )

    # -- dispatch/collect primitives (streaming feeder builds on these) -----

    def dispatch_batch(self, chunk: np.ndarray, fns: np.ndarray, info) -> dict:
        """Asynchronously dispatch one batch of full frames ``[n<=bs, C, B]``
        to the device (tier-0 capacity). Returns an opaque pending handle for
        ``collect_batch``; compute overlaps anything the host does next.

        LPC mode runs inside the same single program as everything else —
        the Q28 integer Levinson (ops/lpc.fixed_point_levinson) derives
        coefficients on device from in-program lag sums, so there is no
        lag fetch, no host pre-pass, and no coefficient upload."""
        nreal, c, B = chunk.shape
        ndev = self._mesh.devices.size if self._mesh is not None else 1
        bucket = min(self.batch_size, _next_pow2(nreal))
        if bucket % ndev:  # shard evenly over the mesh
            bucket += ndev - bucket % ndev
        if nreal < bucket:
            pad = np.repeat(chunk[-1:], bucket - nreal, axis=0)
            chunk = np.concatenate([chunk, pad], axis=0)
            fns = np.concatenate([fns, np.repeat(fns[-1:], bucket - nreal)])
        rec = {"chunk": chunk, "nreal": nreal, "fns": fns, "B": B,
               "rate": info.sample_rate}
        self._dispatch_main(rec)
        return rec

    def _dispatch_main(self, rec: dict) -> None:
        """Launch the main encode program for a prepared batch record."""
        chunk = rec["chunk"]
        _, c, B = chunk.shape
        if self._mesh is not None:
            from ..parallel.mesh import encode_compact_sharded

            if jax.process_count() > 1:
                # multi-host: feed only this process's frame rows; the
                # global array is row-sharded over the DCN-spanning mesh
                from jax.sharding import PartitionSpec as P

                from ..parallel.distributed import (
                    local_row_bounds, make_global_batch,
                )

                lo, hi = local_row_bounds(self._mesh, chunk.shape[0])
                frames_in = make_global_batch(
                    self._mesh, P("frames"), self._feed(chunk[lo:hi]),
                    chunk.shape,
                )
                fns_in = make_global_batch(
                    self._mesh, P("frames"), rec["fns"][lo:hi],
                    rec["fns"].shape,
                )
            else:
                frames_in = jnp.asarray(self._feed(chunk))
                fns_in = jnp.asarray(rec["fns"])
            stream, meta, frame_cap = encode_compact_sharded(
                frames_in, fns_in,
                self.config, self.bit_depth, rec["rate"], 0,
                _default_deposit(), self._mesh,
            )
            out = (stream, meta)
        else:
            fn, frame_cap = self._compact_fn(c, B, rec["rate"], 0,
                                             chunk.shape[0])
            out = fn(jnp.asarray(self._feed(chunk)), jnp.asarray(rec["fns"]))
        _prefetch_meta(out[1])
        rec["out"] = out
        rec["frame_cap"] = frame_cap

    def dispatch_tail(self, tail: np.ndarray, frame_number: int, info) -> dict:
        """Dispatch a ragged final frame ``[C, rem]`` at its exact block size
        (batch 1); numbered ``frame_number``."""
        rem = tail.shape[1]
        c = tail.shape[0]
        tchunk = tail[None, ...]
        tfns = np.array([frame_number], np.int64)
        rec = {"chunk": tchunk, "nreal": 1, "fns": tfns, "B": rem,
               "rate": info.sample_rate}
        fn, frame_cap = self._compact_fn(c, rem, info.sample_rate, 0, 1)
        rec["out"] = fn(jnp.asarray(self._feed(tchunk)), jnp.asarray(tfns))
        _prefetch_meta(rec["out"][1])
        rec["frame_cap"] = frame_cap
        return rec

    def collect_batch(self, pending: dict, info) -> Tuple[bytes, np.ndarray]:
        """Fetch one dispatched batch's frame bytes + sizes, re-encoding
        through the capacity ladder on overflow. Sharded outputs carry one
        compact stream per mesh device (rows, in frame order); each row
        collects exactly like a single-device batch, and ONLY overflowing
        shards re-encode through the ladder — the rest of the mesh's
        results stand (pathological content on one chip does not de-shard
        the batch)."""
        stream, meta = pending["out"]
        nreal = pending["nreal"]
        frame_cap = pending["frame_cap"]
        if meta.ndim == 1:
            got = _collect_aligned(pending["out"], nreal, frame_cap)
            if got is None:
                got = self._encode_overflow(
                    pending["chunk"], nreal, pending["fns"],
                    pending["chunk"].shape[1], pending["B"], info,
                )
            return got
        # sharded: meta rows are [sizes..., total_words, ovf_local, ovf_any]
        per_shard = meta.shape[1] - 3
        multiproc = jax.process_count() > 1
        if multiproc:
            # only this process's shard rows are addressable; byte-collect
            # them here and exchange the per-process streams once over DCN
            srows = {sh.index[0].start or 0: sh.data
                     for sh in stream.addressable_shards}
            mrows = {sh.index[0].start or 0: np.asarray(sh.data)[0]
                     for sh in meta.addressable_shards}
            shard_ids = sorted(srows)
        else:
            shard_ids = range(meta.shape[0])
        parts: List[bytes] = []
        szs: List[np.ndarray] = []
        for s in shard_ids:
            local_real = min(per_shard, nreal - s * per_shard)
            if local_real <= 0:
                continue  # padding-only shard at the batch tail
            if multiproc:
                row = (srows[s][0], mrows[s][:-1])
            else:
                row = (stream[s], meta[s, :-1])
            got = _collect_aligned(row, local_real, frame_cap)
            if got is None:  # this shard's rows only, through the ladder
                lo = s * per_shard
                rows = pending["chunk"][lo : lo + per_shard]
                fns = pending["fns"][lo : lo + per_shard]
                got = self._encode_overflow(
                    rows, local_real, fns, rows.shape[1], pending["B"],
                    info,
                )
            parts.append(got[0])
            szs.append(got[1])
        payload = b"".join(parts)
        sizes = (np.concatenate(szs) if szs
                 else np.zeros(0, np.int64))
        if multiproc:
            from ..parallel.distributed import allgather_parts

            payload, sizes = allgather_parts(payload, sizes)
        return payload, sizes

    def _encode_overflow(self, chunk, nreal, fns, c, B, info):
        """Capacity-ladder fallback for batches that out-size tier 0."""
        fn1, frame_cap = self._compact_fn(c, B, info.sample_rate, 1, chunk.shape[0])
        out = fn1(jnp.asarray(self._feed(chunk)), jnp.asarray(fns))
        got = _collect_aligned(out, nreal, frame_cap)
        if got is not None:
            return got
        # exact worst-case: padded words path
        fnw = self._encode_batch_fn(chunk.shape[0], c, B, info.sample_rate)
        words, total_bits, crcs = fnw(
            jnp.asarray(chunk.astype(np.int32)), jnp.asarray(fns)
        )
        words = np.asarray(words)[:nreal]
        byte_len = (np.asarray(total_bits)[:nreal] + 7) // 8
        crcs = np.asarray(crcs)[:nreal]
        if (byte_len > words.shape[1] * 4).any():
            raise RuntimeError("frame exceeded hard packer capacity")
        from ..native import assemble_frames

        return assemble_frames(words, byte_len, crcs), byte_len + 2

    def encode_frames(
        self, frames: np.ndarray, first_frame_number: int, info: StreamInfo
    ) -> List[bytes]:
        """[F, C, B] int32 full frames -> list of frame byte strings."""
        stream, sizes = self.encode_frames_stream(frames, first_frame_number, info)
        out: List[bytes] = []
        pos = 0
        for L in sizes.tolist():
            out.append(stream[pos : pos + int(L)])
            pos += int(L)
        return out


@lru_cache(maxsize=64)
def _compiled_encode_batch(
    config: EncoderConfig, depth: int, c: int, block_size: int, sample_rate: int
):
    """Words-path program (exact capacity): one per static signature."""
    hstatic = header_static(block_size, sample_rate, depth)
    n_wire = 2 if config.stereo_auto else c
    max_words = max_frame_words(block_size, n_wire, depth)
    return jax.jit(
        partial(
            _encode_batch,
            config=config,
            depth=depth,
            hstatic=hstatic,
            block_size=block_size,
            max_words=max_words,
        )
    )


@lru_cache(maxsize=64)
def _compiled_encode_compact(
    config: EncoderConfig,
    depth: int,
    c: int,
    block_size: int,
    sample_rate: int,
    tier: int,
    batch: int,
    deposit: str | None = None,
):
    """Compact-stream program for one static signature. Returns (fn,
    per-frame byte cap). ``deposit`` None means the platform's default
    (_default_deposit); an explicit mode builds that path's program, which
    is how a deposit A/B gets both programs in one process."""
    hstatic = header_static(block_size, sample_rate, depth)
    n_wire = 2 if config.stereo_auto else c
    stream_ratio, words_ratio = CAPACITY_LADDER[tier]
    max_words = max_frame_words(block_size, n_wire, depth, words_ratio)
    from ..ops.bitpack import ALIGN_W

    raw_bytes = batch * block_size * c * max(depth, 8) // 8
    # slack: per-frame ALIGN_W-group round-up (4*ALIGN_W bytes) + headroom
    capb = int(raw_bytes * stream_ratio) + (4 * ALIGN_W + 32) * batch
    if deposit is None:
        deposit = _default_deposit()
    if deposit == "windowed" and tier > 0:
        # ladder re-encodes force pair merging: content whose quads could
        # not merge (or out-spanned the window) still gets a fast windowed
        # pass before the exact scatter path
        deposit = "windowed_pair"
    return (
        jax.jit(
            partial(
                _encode_batch_compact,
                config=config,
                depth=depth,
                hstatic=hstatic,
                block_size=block_size,
                max_words=max_words,
                capb=capb,
                deposit=deposit,
                speculate=tier == 0,
            )
        ),
        max_words * 4,
    )


def _encode_batch(
    frames: jnp.ndarray,
    frame_numbers: jnp.ndarray,
    *,
    config: EncoderConfig,
    depth: int,
    hstatic: HeaderStatic,
    block_size: int,
    max_words: int,
):
    frames = frames.astype(jnp.int32)
    plan = plan_frames(frames, depth, config)
    words, total_bits, _ovf = pack_frames(
        plan, frame_numbers, hstatic, block_size, config.max_rice_order,
        max_words,
        lpc_order=config.lpc_order if config.prediction == "lpc" else 0,
        lpc_precision=config.lpc_precision,
        depth=depth,
    )
    byte_len = (total_bits + 7) >> 3
    crcs = crc16_words(words, byte_len)
    return words, total_bits, crcs


def _encode_batch_compact(
    frames: jnp.ndarray,
    frame_numbers: jnp.ndarray,
    *,
    config: EncoderConfig,
    depth: int,
    hstatic: HeaderStatic,
    block_size: int,
    max_words: int,
    capb: int,
    deposit: str = "segsum",
    speculate: bool = False,
):
    frames = frames.astype(jnp.int32)
    plan = plan_frames(frames, depth, config, speculate=speculate)
    words, total_bits, overflow = pack_frames(
        plan, frame_numbers, hstatic, block_size, config.max_rice_order,
        max_words,
        lpc_order=config.lpc_order if config.prediction == "lpc" else 0,
        lpc_precision=config.lpc_precision,
        deposit=deposit,
        depth=depth,
    )
    # a speculative-u32-sweep overflow invalidates the whole batch the
    # same way a deposit-window overflow does: the capacity ladder's
    # exact-sweep tier re-encodes it
    overflow = overflow | plan.sweep_unsafe
    byte_len = (total_bits + 7) >> 3
    crcs = crc16_words(words, byte_len)
    words = deposit_crc16(words, byte_len, crcs)
    frame_bytes = byte_len + 2
    stream, total_words = compact_stream_aligned(words, frame_bytes, capb // 4)
    # one fetchable metadata vector: [frame_bytes..., total_words, overflow]
    # (one d2h round trip per batch instead of three)
    meta = jnp.concatenate(
        [
            frame_bytes.astype(jnp.int64),
            total_words.astype(jnp.int64)[None],
            overflow.astype(jnp.int64)[None],
        ]
    )
    return stream, meta
