"""Device bitstream packing: prefix-sum bit offsets + segment-sum deposits.

The reference packs bits serially through a u64 buffer
(libFLAC/FrameWriter.zig:36-114). Here the whole frame becomes one static
symbol tensor: every field of the frame (header bytes, subframe headers,
warmup samples, Rice params, every residual code) is one symbol with

    nb  — total field width in bits (a Rice code's width includes its
          unary quotient run),
    val — the deposited value, right-aligned in the field (the quotient's
          zeros and the 1-terminator + remainder are ``(1<<k) | rem`` at the
          field's end),
    nbv — the deposited value's width (<= 33 bits).

An exclusive prefix-sum of ``nb`` gives every symbol's bit offset; each
deposit spans at most two 32-bit words via one u64 shift, and two sorted
segment-sums OR the deposits into the output words (disjoint bit ranges make
add == or). Masked-off symbols have nb = 0 and deposit nothing.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .analyze import FrameWirePlan, zigzag_u32
from .header import HeaderStatic, build_headers, MAX_HEADER_BYTES
from ..utils.config import MAX_FIXED_ORDER


class SymbolBlock(NamedTuple):
    nb: jnp.ndarray   # i32 [N, S] total field bits
    val: jnp.ndarray  # u64 [N, S] deposited value (right-aligned)
    nbv: jnp.ndarray  # i32 [N, S] deposited bits


# Compacted frames start on ALIGN_W-word (512-byte) boundaries: the stream
# compaction gather then moves whole 128-word rows, so the [rows, ALIGN_W]
# gather operand needs no relayout and the row count is 128x smaller than
# per-word. Cost: <=508 pad bytes per frame of device memory and d2h volume
# (~2.5% for typical 10 KB frames) — the pad never reaches the FLAC bytes
# (the host drops it during assembly, and the capacity ladder's slack term
# scales with ALIGN_W).
ALIGN_W = 128

# pack_frames' deposit paths: exact segment-sums, and windowed binning with
# quad (depth <= 16) or pair merging / pair merging only
DEPOSIT_MODES = ("segsum", "windowed", "windowed_pair")


def _u64(x) -> jnp.ndarray:
    return x.astype(jnp.uint64)


def _mask_u64(nbits: jnp.ndarray) -> jnp.ndarray:
    """(1 << nbits) - 1 as u64, valid for nbits in [0, 63]."""
    return (jnp.uint64(1) << _u64(nbits)) - jnp.uint64(1)


def _tree_or_last(x: jnp.ndarray) -> jnp.ndarray:
    n = x.shape[-1]
    while n > 1:
        if n % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[..., :1])], -1)
            n += 1
        half = n // 2
        x = x[..., :half] | x[..., half:]
        n = half
    return x[..., 0]


def _or_pyramid(x: jnp.ndarray, po_top: int):
    """levels[po][p] = OR of x over partition p at order po (int32 in/out)."""
    B = x.shape[-1]
    part = 1 << po_top
    top = _tree_or_last(x.reshape(*x.shape[:-1], part, B >> po_top))
    levels = [None] * (po_top + 1)
    levels[po_top] = top
    for po in range(po_top - 1, -1, -1):
        prev = levels[po + 1]
        levels[po] = prev[..., 0::2] | prev[..., 1::2]
    return levels


def _pad256(x: jnp.ndarray) -> jnp.ndarray:
    pad = 256 - x.shape[-1]
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])


def channel_symbols(
    kind: jnp.ndarray,        # i32 [N]: 0 const, 1 verbatim, 2 fixed, 3 lpc
    order: jnp.ndarray,       # i32 [N]
    method: jnp.ndarray,      # i32 [N]
    part_order: jnp.ndarray,  # i32 [N]
    sample_size: jnp.ndarray, # i32 [N]
    params: jnp.ndarray,      # u8 [N, 256]
    plane: jnp.ndarray,       # i64 [N, B]
    residuals: jnp.ndarray,   # i32 [N, B]
    qcoeffs: jnp.ndarray,     # i32 [N, 32]
    qshift: jnp.ndarray,      # i32 [N]
    block_size: int,
    max_rice_order: int,
    lpc_order: int = 0,       # static: 0 = LPC disabled
    lpc_precision: int = 14,
    wasted: jnp.ndarray | None = None,  # i32 [N] shaved bits (extension)
):
    """Symbols of one subframe: header byte, (wasted-bits unary), warmup,
    (LPC precision/shift/coeffs), method/part-order, then per grid group one
    partition-param column + its residual codes (reference serializers:
    FrameWriter.zig:251-361; LPC layout per the FLAC spec — the reference
    stubs it). Returns (widths [N, S], deposit values, deposit value bits) —
    every column deposits; offsets come from one prefix sum over the widths.
    """
    n, B = plane.shape
    is_const = kind == 0
    is_verb = kind == 1
    is_lpc = kind == 3
    is_pred = (kind == 2) | is_lpc
    ss = sample_size

    # -- subframe header byte (bit 0 = wasted-bits flag) + unary k field --
    if wasted is None:
        wasted = jnp.zeros((n,), jnp.int32)
    hdr_val = jnp.where(
        is_const,
        0,
        jnp.where(
            is_verb,
            1 << 1,
            jnp.where(is_lpc, (0x20 | (order - 1)) << 1, (8 | order) << 1),
        ),
    ) | (wasted > 0).astype(jnp.int32)
    hdr = SymbolBlock(
        nb=jnp.full((n, 1), 8, jnp.int32),
        val=_u64(hdr_val)[:, None],
        nbv=jnp.full((n, 1), 8, jnp.int32),
    )
    # wasted-bits field: k-1 zeros + a 1 terminator (k bits total)
    wb_nb = jnp.where(wasted > 0, wasted, 0)[:, None]
    wb = SymbolBlock(
        nb=wb_nb,
        val=jnp.where(wb_nb > 0, jnp.uint64(1), jnp.uint64(0)),
        nbv=jnp.where(wb_nb > 0, 1, 0),
    )

    # -- warmup samples --
    max_warmup = max(MAX_FIXED_ORDER, lpc_order)
    w_idx = jax.lax.broadcasted_iota(jnp.int32, (n, max_warmup), 1)
    w_active = is_pred[:, None] & (w_idx < order[:, None])
    w_nb = jnp.where(w_active, ss[:, None], 0)
    w_val = _u64(plane[:, :max_warmup]) & _mask_u64(w_nb)
    warm = SymbolBlock(nb=w_nb, val=jnp.where(w_active, w_val, 0), nbv=w_nb)

    # -- LPC: precision-1(4) + shift(5), then order coefficients --
    lpc_blocks = []
    if lpc_order:
        ps_nb = jnp.where(is_lpc, 9, 0)[:, None]
        ps_val = _u64(((lpc_precision - 1) << 5) | qshift)[:, None] & _mask_u64(
            ps_nb
        )
        lpc_blocks.append(
            SymbolBlock(nb=ps_nb, val=jnp.where(ps_nb > 0, ps_val, 0), nbv=ps_nb)
        )
        c_idx = jax.lax.broadcasted_iota(jnp.int32, (n, lpc_order), 1)
        c_active = is_lpc[:, None] & (c_idx < order[:, None])
        c_nb = jnp.where(c_active, lpc_precision, 0)
        c_val = _u64(qcoeffs[:, :lpc_order]) & _mask_u64(c_nb)
        lpc_blocks.append(
            SymbolBlock(nb=c_nb, val=jnp.where(c_active, c_val, 0), nbv=c_nb)
        )

    # -- method(2) + partition order(4) --
    m_nb = jnp.where(is_pred, 6, 0)[:, None]
    m_val = _u64((method << 4) | part_order)[:, None] & _mask_u64(m_nb)
    meth = SymbolBlock(nb=m_nb, val=jnp.where(m_nb > 0, m_val, 0), nbv=m_nb)

    # -- per-partition escape analysis --
    po_top = min(max_rice_order, (B & -B).bit_length() - 1)
    posmag = residuals ^ (residuals >> np.int32(31))  # |r| encoded positive
    pos_levels = _or_pyramid(posmag, po_top)
    or_levels = _or_pyramid(residuals, po_top)
    # select the chosen partition order's level with a where-chain (a 9-way
    # take_along_axis would lower as per-element gathers)
    res_max = _pad256(pos_levels[0])
    or_all = _pad256(or_levels[0])
    for po in range(1, po_top + 1):
        at = (part_order == po)[:, None]
        res_max = jnp.where(at, _pad256(pos_levels[po]), res_max)
        or_all = jnp.where(at, _pad256(or_levels[po]), or_all)
    bps = jnp.where(
        or_all == 0,
        0,
        jnp.where(res_max == 0, 1, (32 - jax.lax.clz(res_max)) + 1),
    ).astype(jnp.int32)

    # -- interleaved partition-param + residual symbols --
    # On the wire each partition's param immediately precedes its residuals
    # (FrameWriter.zig:304-349), so each residual slot i carries TWO symbol
    # slots: a param slot (active only at partition starts) and the residual
    # itself. Partition 0's param lands at slot 0, before the zero-width
    # masked warmup residual slots — same stream order as the reference.
    r_idx = jax.lax.broadcasted_iota(jnp.int32, (n, B), 1)

    param_len = (4 + method)[:, None]  # [N, 1]
    escape_code = ((1 << (4 + method)) - 1)[:, None]
    params_i = params.astype(jnp.int32)
    is_esc256 = params_i == escape_code
    fallback256 = is_esc256 & (bps >= 32)
    esc_live256 = is_esc256 & ~fallback256
    eff_param256 = jnp.where(fallback256, 30, params_i)

    # Distribute per-partition values to per-sample lanes without gathers OR
    # scatters: the partition order takes only po_top+1 values, and for each
    # the distribution is a STATIC repeat of the first 2^po packed columns —
    # select among the broadcasts with a where-chain, which needs no
    # boundary-scatter + cumsum pass per partition order.
    packed256 = (
        params_i
        | (eff_param256 << 5)
        | (esc_live256.astype(jnp.int32) << 10)
        | (fallback256.astype(jnp.int32) << 11)
        | (bps << 12)
    )
    po_top_here = min(max_rice_order, (B & -B).bit_length() - 1)
    per_sample = jnp.zeros((n, B), jnp.int32)
    ind = jnp.zeros((n, B), jnp.int32)  # 1 at partition starts
    for po in range(po_top_here + 1):
        nparts = 1 << po
        at = (part_order == po)[:, None]
        dist = jnp.repeat(packed256[:, :nparts], B >> po, axis=1)
        per_sample = jnp.where(at, dist, per_sample)
        start = (np.arange(B) % (B >> po) == 0).astype(np.int32)
        ind = jnp.where(at, jnp.asarray(start)[None, :], ind)
    param_i = per_sample & 31
    k = (per_sample >> 5) & 31
    r_esc = ((per_sample >> 10) & 1) == 1
    r_fallback = ((per_sample >> 11) & 1) == 1
    r_bps = (per_sample >> 12) & 63

    zz = _u64(zigzag_u32(residuals))
    rice_nb = (zz >> _u64(k)).astype(jnp.int64) + _u64(k).astype(jnp.int64) + 1
    rice_nb = rice_nb.astype(jnp.int32)
    rice_val = (jnp.uint64(1) << _u64(k)) | (zz & _mask_u64(k))
    esc_val = _u64(residuals) & _mask_u64(r_bps)

    r_active = is_pred[:, None] & (r_idx >= order[:, None])
    fx_nb = jnp.where(r_active, jnp.where(r_esc, r_bps, rice_nb), 0)
    fx_nbv = jnp.where(r_active, jnp.where(r_esc, r_bps, k + 1), 0)
    fx_val = jnp.where(r_active, jnp.where(r_esc, esc_val, rice_val), 0)

    vb_nb = jnp.broadcast_to(ss[:, None], (n, B))
    vb_val = _u64(plane) & _mask_u64(vb_nb)
    ct_nb = jnp.where(r_idx == 0, ss[:, None], 0)
    ct_val = jnp.where(r_idx == 0, _u64(plane) & _mask_u64(ss)[:, None], 0)

    s_nb = jnp.where(is_verb[:, None], vb_nb, jnp.where(is_const[:, None], ct_nb, fx_nb))
    s_nbv = jnp.where(is_verb[:, None], vb_nb, jnp.where(is_const[:, None], ct_nb, fx_nbv))
    s_val = jnp.where(is_verb[:, None], vb_val, jnp.where(is_const[:, None], ct_val, fx_val))

    # -- param grid columns -------------------------------------------------
    # Every partition start lies on the static grid of multiples of
    # G = B >> po_top (start_p = p * (B >> po) and B >> po is a multiple of
    # G for every legal po), so ONE param column per grid point, placed
    # before its G residual columns, puts each partition's param exactly
    # where the wire needs it — params are then ordinary monotone entries of
    # the main deposit stream (~3% more elements), and no separate
    # scatter-based side stream exists at all.
    n_grid = 1 << po_top
    G = B >> po_top
    p_slot_g = is_pred[:, None] & (ind[:, ::G] > 0)
    plen_s = jnp.where(r_esc, param_len + 5, param_len)  # [N, B]
    vparam = jnp.where(
        r_esc,
        (_u64(param_i) << jnp.uint64(5)) | _u64(r_bps),
        _u64(jnp.where(r_fallback, 30, param_i)),
    )
    pg_nb = jnp.where(p_slot_g, plen_s[:, ::G], 0)
    pg_val = jnp.where(p_slot_g, vparam[:, ::G], 0)

    # interleave [param_g | residuals g*G .. (g+1)*G-1] per grid group
    inter_nb = jnp.concatenate(
        [pg_nb[:, :, None], s_nb.reshape(n, n_grid, G)], axis=2
    ).reshape(n, n_grid * (G + 1))
    inter_val = jnp.concatenate(
        [pg_val[:, :, None], s_val.reshape(n, n_grid, G)], axis=2
    ).reshape(n, n_grid * (G + 1))
    inter_nbv = jnp.concatenate(
        [pg_nb[:, :, None], s_nbv.reshape(n, n_grid, G)], axis=2
    ).reshape(n, n_grid * (G + 1))

    blocks = [hdr, wb, warm] + lpc_blocks + [meth]
    nb_full = jnp.concatenate([b.nb for b in blocks] + [inter_nb], axis=1)
    dep_val = jnp.concatenate([b.val for b in blocks] + [inter_val], axis=1)
    dep_nbv = jnp.concatenate([b.nbv for b in blocks] + [inter_nbv], axis=1)
    return nb_full, dep_val, dep_nbv


def _split_hi_lo(d_cum, val, nbv):
    """Per-deposit word index + the two u32 word contributions."""
    d_start = d_cum - nbv
    w0 = (d_start >> 5).astype(jnp.int32)
    r = (d_start & 31).astype(jnp.int32)
    if val.dtype == jnp.uint32:
        v = val
        over = nbv - (32 - r)  # bits spilling into word w0+1
        hi = jnp.where(
            over > 0,
            v >> jnp.clip(over, 0, 31).astype(jnp.uint32),
            v << jnp.clip(-over, 0, 31).astype(jnp.uint32),
        )
        lo = jnp.where(
            over > 0,
            v << jnp.clip(32 - over, 0, 31).astype(jnp.uint32),
            jnp.uint32(0),
        )
    else:
        shift = 64 - r - nbv
        shifted = jnp.where(
            nbv > 0, val << _u64(jnp.clip(shift, 0, 63)), jnp.uint64(0)
        )
        hi = (shifted >> jnp.uint64(32)).astype(jnp.uint32)
        lo = (shifted & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    live = nbv > 0
    return w0, jnp.where(live, hi, 0), jnp.where(live, lo, 0)


def deposit_words(
    d_cum: jnp.ndarray,
    val: jnp.ndarray,
    nbv: jnp.ndarray,
    max_words: int,
) -> jnp.ndarray:
    """Exact per-element deposit path (no window-span limit): two sorted
    segment-sums per stream. Always exact, so it is also the capacity
    ladder's fallback for streams whose chunks out-span the windowed
    path's window (deposit_stream_windowed)."""
    w0, hi, lo = _split_hi_lo(d_cum, val, nbv)

    num_segments = max_words + 1

    def pack_one(ids0, hi_v, lo_v):
        a = jax.ops.segment_sum(
            hi_v, ids0, num_segments=num_segments, indices_are_sorted=True
        )
        b = jax.ops.segment_sum(
            lo_v, ids0 + 1, num_segments=num_segments, indices_are_sorted=True
        )
        return (a + b)[:max_words]

    return jax.vmap(pack_one)(w0, hi, lo).astype(jnp.uint32)


def deposit_crc16(
    words: jnp.ndarray, byte_len: jnp.ndarray, crcs: jnp.ndarray
) -> jnp.ndarray:
    """OR each frame's big-endian CRC-16 into the two bytes at byte_len
    (the padding bytes there are zero, so scatter-add == or)."""
    n = words.shape[0]
    rows = jnp.arange(n)
    hi = (crcs >> 8) & 0xFF
    lo = crcs & 0xFF
    for byte_val, pos in ((hi, byte_len), (lo, byte_len + 1)):
        w = (pos >> 2).astype(jnp.int32)
        sh = (8 * (3 - (pos & 3))).astype(jnp.uint32)
        words = words.at[rows, w].add((byte_val << sh).astype(jnp.uint32))
    return words


def compact_stream_aligned(
    words: jnp.ndarray, frame_bytes: jnp.ndarray, capw: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Group-aligned compaction: concatenate each frame's used words (its
    bytes rounded up to ``ALIGN_W``-word groups) into one dense u32 buffer.

    Frames start on ALIGN_W-word (32-byte) boundaries, so the move is a
    single flat gather of whole groups — 8x fewer serialized gather rows
    than per-word, each moving a contiguous 32-byte row. The host drops the
    <=31 pad bytes per frame during its memcpy assembly. Output group g
    belongs to frame f(g) = #frame-starts <= g (boundary scatter + cumsum);
    its in-frame group index comes from a second delta-scatter — no
    per-element table lookups anywhere.

    Returns (stream u32 [~capw] MSB-first, total_words i32). Caller checks
    total_words <= the returned stream size. ``words`` width and the group
    offsets the host computes must both use ALIGN_W (max_frame_words rounds
    the width; models/pipeline._collect_aligned mirrors the offsets).
    """
    n, W = words.shape
    assert W % ALIGN_W == 0, "frame word capacity must be ALIGN_W-aligned"
    Wg = W // ALIGN_W
    capg = -(-capw // ALIGN_W)
    gcnt = (frame_bytes + 4 * ALIGN_W - 1) // (4 * ALIGN_W)  # groups/frame
    goff = jnp.cumsum(gcnt) - gcnt
    total_g = goff[-1] + gcnt[-1]

    marks = jnp.zeros((capg,), jnp.int32)
    starts = goff[1:]
    marks = marks.at[starts].add(1, mode="drop")
    f = jnp.cumsum(marks)  # frame index per output group
    off = jnp.zeros((capg,), jnp.int32)
    goff_delta = goff - jnp.pad(goff, (1, 0))[:n]
    off = off.at[jnp.where(jnp.arange(n) == 0, 0, goff)].add(
        goff_delta, mode="drop"
    )
    boff_g = jnp.cumsum(off)  # goff[f] per output group
    g = jnp.arange(capg, dtype=jnp.int32)
    j = g - boff_g
    rows = words.reshape(n * Wg, ALIGN_W)
    out = rows[(f * Wg + j).astype(jnp.int32)]  # [capg, ALIGN_W]
    out = jnp.where((g < total_g)[:, None], out, 0)
    return out.reshape(-1).astype(jnp.uint32), (total_g * ALIGN_W).astype(
        jnp.int32
    )


def header_symbols(
    header_bytes: jnp.ndarray, header_len: jnp.ndarray
) -> SymbolBlock:
    n = header_bytes.shape[0]
    idx = jax.lax.broadcasted_iota(jnp.int32, (n, MAX_HEADER_BYTES), 1)
    active = idx < header_len[:, None]
    nb = jnp.where(active, 8, 0)
    return SymbolBlock(
        nb=nb, val=jnp.where(active, _u64(header_bytes), 0), nbv=nb
    )


def _cumsum_bits_exact(nb: jnp.ndarray) -> jnp.ndarray:
    """Exact i32 prefix sum of per-symbol bit widths [N, S] via blocked
    upper-triangular f32 matmuls (one matmul plus a tiny per-block offset
    cumsum, instead of XLA's scan lowering of jnp.cumsum).

    EXACT because every value is a non-negative integer and every partial
    sum is bounded by a frame's total bit count (< 2^19 even for depth-32
    stereo verbatim at block 32768, far under f32's 2^24 exact-integer
    range), so each f32 product/add is an exactly-representable integer.
    Callers gate on a static frame-bit bound and fall back to jnp.cumsum
    past 2^24.

    Precision note: the dot MUST run at Precision.HIGHEST, which on the
    GPU means true float32 arithmetic. At DEFAULT precision XLA may run an
    f32 matmul in TF32 on the tensor cores, which keeps 10 mantissa bits
    (11 significant bits): every symbol width above 2048 that is not a
    multiple of the rounding step (e.g. 2049, 4001) would round, shifting
    every later deposit offset and corrupting the frame. Such widths are
    legitimate — one impulsive residual can carry a unary quotient of
    thousands of bits while its partition still prefers Rice over escape —
    and the CPU suite cannot see the rounding because CPU f32 dots are
    exact; the card-only tests and chip_smoke.py's wide-symbol phase do.
    With HIGHEST every operand (width or 0/1), product and partial sum is
    an exact integer < 2^24."""
    n, s = nb.shape
    blk = 128
    sp = -(-s // blk) * blk
    x = nb.astype(jnp.float32)
    if sp != s:
        x = jnp.pad(x, ((0, 0), (0, sp - s)))
    xb = x.reshape(n, sp // blk, blk)
    tri = jnp.triu(jnp.ones((blk, blk), jnp.float32))  # tri[i,j]=1 iff i<=j
    inner = jax.lax.dot_general(
        xb,
        tri,
        (((2,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )  # [n, nblk, blk]: inclusive cumsum within each block
    bsum = inner[..., -1]
    offs = jnp.cumsum(bsum, axis=1) - bsum  # [n, nblk] exclusive, tiny
    out = (inner + offs[..., None]).astype(jnp.int32).reshape(n, sp)
    return out[:, :s]


def frame_symbol_stream(
    plan: FrameWirePlan,
    frame_numbers: jnp.ndarray,
    hstatic: HeaderStatic,
    block_size: int,
    max_rice_order: int,
    lpc_order: int = 0,
    lpc_precision: int = 14,
):
    """The whole-frame deposit stream: header bytes + every channel's
    subframe symbols concatenated, with the offset prefix sum. Returns
    (dep_cum i32 [N, S], total_bits i32 [N], dep_val_parts, dep_nbv [N, S])
    — value parts stay unconcatenated so the caller picks the dtype."""
    hb, hlen = build_headers(frame_numbers, plan.channels_code, hstatic)
    hdr = header_symbols(hb, hlen)
    nb_parts = [hdr.nb]
    dep_val_parts = [hdr.val]
    dep_nbv_parts = [hdr.nbv]
    n_wire = plan.kind.shape[0]  # plan arrays are wire-major [W, N, ...]
    for c in range(n_wire):
        nb_full, dep_val, dep_nbv = channel_symbols(
            plan.kind[c],
            plan.order[c],
            plan.method[c],
            plan.part_order[c],
            plan.sample_size[c],
            plan.params[c],
            plan.planes[c],
            plan.residuals[c],
            plan.qcoeffs[c],
            plan.qshift[c],
            block_size,
            max_rice_order,
            lpc_order=lpc_order,
            lpc_precision=lpc_precision,
            wasted=plan.wasted[c],
        )
        nb_parts.append(nb_full)
        dep_val_parts.append(dep_val)
        dep_nbv_parts.append(dep_nbv)

    nb = jnp.concatenate(nb_parts, axis=1)
    # static worst-case frame bits: every wire subframe at its verbatim
    # ceiling (33-bit samples + headers), generously padded. Under 2^24
    # the matmul cumsum is exact; past it (8-channel x 65535-sample frames)
    # fall back to the scan form.
    if n_wire * (block_size * 40 + 128) + 128 < (1 << 24):
        dep_cum = _cumsum_bits_exact(nb)
    else:
        dep_cum = jnp.cumsum(nb, axis=1, dtype=jnp.int32)
    total_bits = dep_cum[:, -1]
    dep_nbv = jnp.concatenate(dep_nbv_parts, axis=1)
    return dep_cum, total_bits, dep_val_parts, dep_nbv


# -- merged deposits: pair/quad merging and dword splitting ------------------
# Wide variable-distance shifts are hand-rolled u32 limb math: XLA's u64
# variable shifts can lower through per-column gathers, so everything here
# stays in u32 lanes after one constant-distance u64 -> limb split.


def _shl_pair(h, lo, b):
    """(h, lo) u32 pair << b for b in [0, 31], returning the three limbs
    (carry-out, hi, lo) of the 96-bit result. Branchless."""
    bu = b.astype(jnp.uint32)
    inv = jnp.clip(32 - b, 1, 31).astype(jnp.uint32)
    nz = b > 0
    z = jnp.uint32(0)
    spill = lambda x: jnp.where(nz, x >> inv, z)  # x >> (32-b), 0 at b==0
    return spill(h), (h << bu) | spill(lo), lo << bu


def _merge_pairs(d_cum, val, nbv):
    """Fuse adjacent deposit pairs: (val_a << width_b) | val_b deposited at
    pair-field end, nbv_a + width_b bits. Width-0 / masked partners are
    identities; pairs whose combined deposited span exceeds 64 bits cannot
    merge and raise ``cannot`` (the caller ORs it into the overflow flag).
    Returns (d_cum, (val_hi, val_lo) u32 pair, nbv, cannot) over ceil(S/2)
    columns."""
    n, s = val.shape
    if s % 2:
        d_cum = jnp.concatenate([d_cum, d_cum[:, -1:]], axis=1)
        val = jnp.concatenate([val, jnp.zeros((n, 1), val.dtype)], axis=1)
        nbv = jnp.concatenate([nbv, jnp.zeros((n, 1), nbv.dtype)], axis=1)
    # u64 -> u32 limbs first (constant-distance shift = a limb move); all
    # variable-distance math below stays in u32
    vh = (val >> jnp.uint64(32)).astype(jnp.uint32)
    vl = val.astype(jnp.uint32)
    ca, cb = d_cum[:, 0::2], d_cum[:, 1::2]
    ha, la = vh[:, 0::2], vl[:, 0::2]
    hb, lb = vh[:, 1::2], vl[:, 1::2]
    na, nb_ = nbv[:, 0::2], nbv[:, 1::2]
    width_b = cb - ca  # field b's TOTAL width (unary zeros included)
    a_live = na > 0
    tot = na + width_b
    cannot = jnp.any(a_live & (tot > 64))
    # (ha, la) << width_b over u32 limbs; width_b in [0, 63] when mergeable
    small = width_b < 32
    b_lo = jnp.clip(width_b, 0, 31)
    b_hi = jnp.clip(width_b - 32, 0, 31)
    _, sh_h, sh_l = _shl_pair(ha, la, b_lo)
    big_h = la << b_hi.astype(jnp.uint32)  # low limb crosses into hi
    sa_h = jnp.where(small, sh_h, big_h)
    sa_l = jnp.where(small, sh_l, jnp.uint32(0))
    # field b's value occupies the low width_b bits: disjoint from the
    # shifted field-a bits whenever the pair merges, so or == add
    hm = jnp.where(a_live, sa_h | hb, hb)
    lm = jnp.where(a_live, sa_l | lb, lb)
    nm = jnp.where(a_live, tot, nb_)
    return cb, (hm, lm), nm, cannot


def _merge_quads(d_cum, val, nbv):
    """Two merge rounds: pairs (<=64-bit, _merge_pairs) then adjacent PAIR
    deposits into <=96-bit quads — (val_a << width_b) | val_b over three
    u32 limbs, deposited at the quad-field end. The deposit stream shrinks
    to ceil(S/4) columns, and dword-granular binning needs only 3 slot
    compares per deposit (5 live word contributions — the 6th word is
    provably untouched), so stage-1 compare work drops ~37% vs pairs.
    Gate by content width: 4 symbols of ~(depth+2) bits must fit 96, so
    callers use quads for depth <= 16 only (pairs cover the rest).
    Returns (d_cum, (h, m, l) u32 limbs, nbv, cannot)."""
    d_cum, (ha_all, la_all), nbv, cannot1 = _merge_pairs(d_cum, val, nbv)
    n, s = d_cum.shape
    if s % 2:
        d_cum = jnp.concatenate([d_cum, d_cum[:, -1:]], axis=1)
        z = jnp.zeros((n, 1), jnp.uint32)
        ha_all = jnp.concatenate([ha_all, z], axis=1)
        la_all = jnp.concatenate([la_all, z], axis=1)
        nbv = jnp.concatenate([nbv, jnp.zeros((n, 1), nbv.dtype)], axis=1)
    ca, cb = d_cum[:, 0::2], d_cum[:, 1::2]
    ha, la = ha_all[:, 0::2], la_all[:, 0::2]
    hb, lb = ha_all[:, 1::2], la_all[:, 1::2]
    na, nb_ = nbv[:, 0::2], nbv[:, 1::2]
    width_b = cb - ca  # field b's TOTAL width (unary zeros included)
    a_live = na > 0
    tot = na + width_b
    cannot = cannot1 | jnp.any(a_live & (tot > 96))
    # (ha, la) << width_b over three limbs; width_b in [0, 95] if mergeable
    k = jnp.clip(width_b >> 5, 0, 2)
    b = width_b & 31
    c2, c1, c0 = _shl_pair(ha, la, b)
    z = jnp.uint32(0)
    k1 = k == 1
    k2 = k == 2
    # limb-rotate by k: value < 2^(96 - 32k) when merging, so nothing spills
    sh_h = jnp.where(k2, c0, jnp.where(k1, c1, c2))
    sh_m = jnp.where(k2, z, jnp.where(k1, c0, c1))
    sh_l = jnp.where(k2, z, jnp.where(k1, z, c0))
    # field b's value (<= 64 bits, right-aligned) is disjoint when merging
    hm = jnp.where(a_live, sh_h, z)
    mm = jnp.where(a_live, sh_m | hb, hb)
    lm = jnp.where(a_live, sh_l | lb, lb)
    nm = jnp.where(a_live, tot, nb_)
    return cb, (hm, mm, lm), nm, cannot


def _split3d(d_cum, val3, nbv):
    """Per-deposit first-DWORD index + five u32 word contributions: a
    <=96-bit value at in-dword bit offset r <= 63 ends by bit r + 96 <=
    159, so it spans at most THREE dwords but only FIVE words of the
    192-bit window (the 6th word starts at bit 160 — provably untouched).
    Left-justify over limbs: shift 192 - r - nbv in [33, 191].
    Returns (dw0, s0, s1, s2, s3, s4) with s_i the contribution to word
    2*dw0 + i (MSB-first stream order)."""
    h, m, l = val3
    d_start = d_cum - nbv
    dw0 = (d_start >> 6).astype(jnp.int32)
    r = (d_start & 63).astype(jnp.int32)
    sh = 192 - r - nbv
    k = sh >> 5  # in [1, 5]
    b = sh & 31
    # (h, m, l) << b over four limbs
    bu = b.astype(jnp.uint32)
    inv = jnp.clip(32 - b, 1, 31).astype(jnp.uint32)
    nz = b > 0
    z = jnp.uint32(0)
    spill = lambda x: jnp.where(nz, x >> inv, z)
    d3 = spill(h)
    d2 = (h << bu) | spill(m)
    d1 = (m << bu) | spill(l)
    d0 = l << bu

    # word 5-k gets limb 0 (low), upward: s_{5-k-j} = d_j
    def pick(*cases):
        # cases: list of (k value, limb) pairs; where-chain select
        out = z
        for kv, limb in cases:
            out = jnp.where(k == kv, limb, out)
        return out

    s0 = pick((5, d0), (4, d1), (3, d2), (2, d3))
    s1 = pick((4, d0), (3, d1), (2, d2), (1, d3))
    s2 = pick((3, d0), (2, d1), (1, d2))
    s3 = pick((2, d0), (1, d1))
    s4 = pick((1, d0))
    live = nbv > 0
    msk = lambda x: jnp.where(live, x, z)
    return dw0, msk(s0), msk(s1), msk(s2), msk(s3), msk(s4)


def _split2d(d_cum, val, nbv):
    """Per-deposit first-DWORD index + four u32 word contributions: a
    <=64-bit value at any bit offset spans at most TWO 64-bit dwords
    (words [2*dw0 .. 2*dw0+3]), so dword-granular binning needs only two
    slot compares per deposit where word-granular needs three, over half
    the slots. Left-justify the value in the 128-bit window starting at
    its first dword: shift 128 - r - nbv with r the in-dword bit offset.
    ``val`` is a (hi, lo) u32 limb pair (from _merge_pairs) or a u64 array.
    Returns (dw0, s0, s1, s2, s3) with s_i the contribution to word
    2*dw0 + i (MSB-first stream order)."""
    if isinstance(val, tuple):
        vh, vl = val
    else:
        vh = (val >> jnp.uint64(32)).astype(jnp.uint32)
        vl = val.astype(jnp.uint32)
    d_start = d_cum - nbv
    dw0 = (d_start >> 6).astype(jnp.int32)
    r = (d_start & 63).astype(jnp.int32)
    sh = 128 - r - nbv  # in [1, 127]; nbv == 0 rows are masked below
    # v << sh over limbs: sh = 32*k + b with k in {0..3}, b in [0, 31]
    k = sh >> 5
    b = sh & 31
    a2, a1, a0 = _shl_pair(vh, vl, b)
    z = jnp.uint32(0)
    k1 = k == 1
    k2 = k == 2
    k3 = k == 3
    # stream word i of the window = limb (3 - i) of (v << sh)
    s0 = jnp.where(k3, a0, jnp.where(k2, a1, jnp.where(k1, a2, z)))
    s1 = jnp.where(k3, z, jnp.where(k2, a0, jnp.where(k1, a1, a2)))
    s2 = jnp.where(k3, z, jnp.where(k2, z, jnp.where(k1, a0, a1)))
    s3 = jnp.where(k3, z, jnp.where(k2, z, jnp.where(k1, z, a0)))
    live = nbv > 0
    return (
        dw0,
        jnp.where(live, s0, z),
        jnp.where(live, s1, z),
        jnp.where(live, s2, z),
        jnp.where(live, s3, z),
    )


def deposit_stream_windowed(
    d_cum: jnp.ndarray,
    val: jnp.ndarray,
    nbv: jnp.ndarray,
    max_words: int,
    chunk: int = 128,
    win_rows: int = 8,
    row_words: int = 32,
    quad: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed binning of the pair- (or quad-) merged deposit stream: no
    scatter, and a matrix product for the window combine.

    Two stages, both with static shapes and no read-modify-write chains:

    1. WINDOWS: each chunk of ``chunk`` consecutive merged deposits spans a
       bounded range (monotone keys), so its contributions bin into a
       [win_rows * row_words]-word window starting at its first key aligned
       DOWN to a row_words-word row. One fused compare-against-iota
       reduction per chunk. Stage-1 cost is proportional to W = win_rows *
       row_words, so finer rows (32 words) beat 128-word rows: the
       alignment remainder shrinks from <=127 to <=row_words-1 and W drops
       384 -> 256 for the same content span bound.
    2. COMBINE: window w of chunk c holds output rows ``base_c .. base_c +
       win_rows`` (row_words-word rows). Overlap-adding all windows into
       the frame's output rows is a one-hot matmul over row keys: windows
       split into 4 bf16 byte planes ([N, K, row_words] each), multiplied
       by the [N, R, K] row-key one-hot with f32 accumulation, and
       reassembled. Disjoint bit ranges make every per-(word, byte) sum
       <= 255, exactly representable in bf16 and f32 — the matmul is
       bit-exact at any matmul precision (its operands are bf16 already).

    Returns (words u32 [N, max_words], overflow bool); overflow ORs the
    window-span check with merge-impossibility, and the caller falls back
    to the exact segment-sum path.
    """
    if quad:
        # <=96-bit quad deposits: 3 dword slots, 5 live word contributions
        # (the 6th window word is provably untouched — _split3d)
        d_cum, val3, nbv, cannot = _merge_quads(d_cum, val, nbv)
        dw0, s0, s1, s2, s3, s4 = _split3d(d_cum, val3, nbv)
        span_slack = 3
    else:
        d_cum, val, nbv, cannot = _merge_pairs(d_cum, val, nbv)
        dw0, s0, s1, s2, s3 = _split2d(d_cum, val, nbv)
        s4 = None
        span_slack = 2
    n, s = dw0.shape
    W = win_rows * row_words
    Wd = W // 2  # window size in 64-bit dwords
    # rows beyond the word budget clamp into slack rows past max_words
    # (monotone preserved); frames that needed them trip the caller's
    # capacity check, so the slack garbage is never read
    dw0 = jnp.minimum(dw0, (max_words >> 1) + 1)
    s_pad = -(-max(s, chunk) // chunk) * chunk
    if s_pad != s:
        padn = s_pad - s
        dw0 = jnp.concatenate(
            [dw0, jnp.broadcast_to(dw0[:, -1:], (n, padn))], axis=1
        )
        z = jnp.zeros((n, padn), jnp.uint32)
        s0 = jnp.concatenate([s0, z], axis=1)
        s1 = jnp.concatenate([s1, z], axis=1)
        s2 = jnp.concatenate([s2, z], axis=1)
        s3 = jnp.concatenate([s3, z], axis=1)
        if s4 is not None:
            s4 = jnp.concatenate([s4, z], axis=1)
    nch = s_pad // chunk

    row_sh = row_words.bit_length() - 1
    assert row_words == 1 << row_sh and row_words >= 2
    dwr = dw0.reshape(n, nch, chunk)
    base_row = dwr[:, :, 0] >> (row_sh - 1)  # [N, nch] output row of chunk
    rel = dwr - (base_row[:, :, None] << (row_sh - 1))  # in-window dword
    overflow = jnp.any(rel > Wd - span_slack) | cannot

    # stage 1: per-chunk windows binned at DWORD granularity (i32 adds of
    # disjoint-bit values == or). Each deposit spans at most two dwords,
    # expressed as two VIRTUAL deposits on a doubled chunk axis — one slot
    # compare each with two word outputs — so the compare work is
    # (2*chunk) * Wd * (1 cmp + 2 sel + 2 add), ~45% less than 3-word
    # binning at chunk * W * (3 cmp + 3 sel + 3 add). The deposit axis is
    # the MINOR axis of the virtual 4D compare tensor, so the compare fuses
    # into the reduce instead of materializing in device memory.
    def cc(*streams):
        return jnp.concatenate(
            [
                jax.lax.bitcast_convert_type(x, jnp.int32).reshape(
                    n, nch, 1, chunk
                )
                for x in streams
            ],
            axis=3,
        )

    # TWO sibling reduces, one per word plane, each recomputing the slot
    # compare inline. (A single reduce over a stacked plane axis invites
    # XLA to materialize the [N, nch, Wd, 2chunk] predicate as its own
    # fusion and stream it into the reduce.)
    tio = jax.lax.broadcasted_iota(jnp.int32, (1, 1, Wd, 1), 2)
    relx = rel[:, :, None, :]
    relcat = jnp.concatenate([relx, relx + 1], axis=3)  # [N, nch, 1, 2c]
    z32 = jnp.int32(0)
    if quad:
        # a quad deposit covers dwords rel..rel+2: the EVEN word plane
        # needs all three slots (s0, s2, s4); the odd plane only two —
        # s4's partner word is provably zero (_split3d)
        relcat3 = jnp.concatenate([relx, relx + 1, relx + 2], axis=3)
        acc0 = jnp.where(relcat3 == tio, cc(s0, s2, s4), z32).sum(
            axis=3, dtype=jnp.int32
        )
    else:
        acc0 = jnp.where(relcat == tio, cc(s0, s2), z32).sum(
            axis=3, dtype=jnp.int32
        )
    acc1 = jnp.where(relcat == tio, cc(s1, s3), z32).sum(
        axis=3, dtype=jnp.int32
    )
    # stage 2: overlap-add via one-hot matmul over row_words-word rows,
    # one matmul per (byte plane, word parity), so each plane's shift/mask
    # fuses into its matmul operand. The EVEN and ODD word planes stay
    # separate through half-width dots and interleave ONCE on the final
    # i32 output (a single [N, R, rw/2, 2] stack): interleaving the bf16
    # planes before the dot would relayout all four byte planes.
    K = nch * win_rows
    rw2 = row_words // 2
    winb_e = acc0.reshape(n, K, rw2)  # even stream words of each row
    winb_o = acc1.reshape(n, K, rw2)  # odd stream words
    # pre-transpose ONCE in i32: the dot below wants its rhs K-minor while
    # stage 1 produces batch-minor accumulators; transposing here costs two
    # i32 copies instead of one relayout per bf16 byte plane.
    winb_e = jnp.swapaxes(winb_e, 1, 2)  # [N, rw2, K]
    winb_o = jnp.swapaxes(winb_o, 1, 2)
    keys = base_row[:, :, None] + jnp.arange(win_rows, dtype=jnp.int32)
    keys = keys.reshape(n, K)  # output row of each window row
    R = (max_words + 2) // row_words + win_rows + 1
    onehot = (
        keys[:, None, :] == jnp.arange(R, dtype=jnp.int32)[None, :, None]
    ).astype(jnp.bfloat16)  # [N, R, K]
    out_e = jnp.zeros((n, R, rw2), jnp.int32)
    out_o = jnp.zeros((n, R, rw2), jnp.int32)
    for b in range(4):
        pe = ((winb_e >> (8 * b)) & 0xFF).astype(jnp.bfloat16)  # [N, rw2, K]
        po = ((winb_o >> (8 * b)) & 0xFF).astype(jnp.bfloat16)
        se = jax.lax.dot_general(
            onehot, pe, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )  # [N, R, rw2]; each entry <= 255 (disjoint bits), exact
        so = jax.lax.dot_general(
            onehot, po, (((2,), (2,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        out_e = out_e + (se.astype(jnp.int32) << (8 * b))
        out_o = out_o + (so.astype(jnp.int32) << (8 * b))
    out = jnp.stack([out_e, out_o], axis=-1).reshape(n, R, row_words)
    words = jax.lax.bitcast_convert_type(out, jnp.uint32).reshape(
        n, R * row_words
    )
    return words[:, :max_words], overflow


def pack_frames(
    plan: FrameWirePlan,
    frame_numbers: jnp.ndarray,
    hstatic: HeaderStatic,
    block_size: int,
    max_rice_order: int,
    max_words: int,
    lpc_order: int = 0,
    lpc_precision: int = 14,
    deposit: str = "segsum",
    depth: int = 24,
):
    """Full frames (header + subframes) -> (words u32 [N, W], total_bits,
    overflow).

    Every wire field — header bytes, subframe fronts, partition params (on
    their grid columns), residual codes — is one column of a single width
    array; one prefix sum yields every bit offset and EVERY column deposits,
    so there is exactly one deposit stream (monotone word keys). ``deposit``
    picks how it lands in words: "segsum" (exact sorted segment-sums, never
    overflows), "windowed" (deposit_stream_windowed, quad-merged where the
    depth allows) or "windowed_pair" (windowed, pair-merged only).
    """
    if deposit not in DEPOSIT_MODES:
        raise ValueError(
            f"unknown deposit mode {deposit!r}; expected one of "
            f"{DEPOSIT_MODES}"
        )
    dep_cum, total_bits, dep_val_parts, dep_nbv = frame_symbol_stream(
        plan, frame_numbers, hstatic, block_size, max_rice_order,
        lpc_order=lpc_order, lpc_precision=lpc_precision,
    )

    if deposit != "segsum":
        # merging pairs adjacent symbols into <=64-bit deposits, so values
        # are u64 regardless of depth
        dep_val = jnp.concatenate(
            [v.astype(jnp.uint64) for v in dep_val_parts], axis=1
        )
        # chunk/window sizing: stage-1 cost scales as S * window, so small
        # chunks with tight windows win (chunk=32 pairs; much smaller
        # chunks lose to per-chunk overheads). Windows align to 32-word
        # (16-dword) rows: a window needs the <=15-dword alignment
        # remainder + the content span + the span-check slack. The span
        # is depth-bound: a sustained merged width beyond (depth+2) bits
        # per symbol (escape samples <= depth+1 plus a 5-bit param column)
        # implies the estimator would have chosen verbatim, so heavier
        # chunks only arise on adversarial content, where the overflow
        # flag falls back to the exact path. depth <= 16 quad-merges 4
        # symbols into <=96-bit deposits (16 per chunk — same chunk count
        # and window as 32 pairs, ~37% less stage-1 compare work); deeper
        # content and 33-bit side channels (i64 planes) stay pair-merged.
        # "windowed_pair" forces pairs — the capacity ladder's tier-1
        # re-encode uses it so quad-unmergeable content still gets a
        # windowed pass instead of the exact scatter path.
        quad = (
            deposit == "windowed"
            and depth <= 16
            and plan.planes.dtype != jnp.int64
        )
        if quad:
            chunk = 16
            unit_bits = 4 * (depth + 2)
            slack = 2  # rel <= Wd - 3: 3-dword spans
        else:
            chunk = 32
            unit_bits = (
                68 if plan.planes.dtype == jnp.int64 else 2 * (depth + 2)
            )
            slack = 1  # rel <= Wd - 2
        span_dw = -(-chunk * unit_bits // 64)
        wr = -(-(span_dw + 15 + slack) // 16)
        main_words, overflow = deposit_stream_windowed(
            dep_cum, dep_val, dep_nbv, max_words, chunk=chunk,
            win_rows=wr, row_words=32, quad=quad,
        )
        return main_words, total_bits, overflow

    # deposits are <= 32 bits except the 33-bit side-channel samples of
    # 32-bit-depth stereo; narrow values halve traffic and keep the
    # splitting in pure u32
    vdt = jnp.uint64 if plan.planes.dtype == jnp.int64 else jnp.uint32
    dep_val = jnp.concatenate([v.astype(vdt) for v in dep_val_parts], axis=1)

    words = deposit_words(dep_cum, dep_val, dep_nbv, max_words)
    return words, total_bits, jnp.asarray(False)


def max_frame_words(
    block_size: int, n_wire: int, depth: int, ratio: float | None = None
) -> int:
    """Static per-frame word capacity.

    ``ratio=None`` gives the provable worst case: actual Rice bits can
    exceed the flake estimate by at most ~part_size/2 per partition (the
    estimate is a truncated mean), so estimate < verbatim(bits_of_t * B)
    implies actual < (bits_of_t + 6) * B + headers.

    A float ratio gives a practical capacity of ``ratio`` x the frame's raw
    PCM bytes + header slack — packing and CRC cost scale with this, and
    overflowing frames are detected and re-run at the exact capacity.
    """
    if ratio is not None:
        raw = block_size * n_wire * max(depth, 8) // 8
        per_ch_overhead = 8 + 32 * 34 + 9 + 32 * 15 + 6 + 256 * 10
        total_bits = (
            MAX_HEADER_BYTES * 8
            + int(raw * 8 * ratio)
            + n_wire * per_ch_overhead
            + 64
        )
        return -(-((total_bits + 31) // 32) // ALIGN_W) * ALIGN_W
    bits_of_t = 64 if depth == 32 else 32
    per_ch = (
        8 + 32 * 34 + 9 + 32 * 15 + 6 + 256 * 10
        + block_size * (bits_of_t + 6)
    )
    total_bits = MAX_HEADER_BYTES * 8 + n_wire * per_ch + 64
    # rounded to the compaction alignment so per-frame rows regroup exactly
    return -(-((total_bits + 31) // 32) // ALIGN_W) * ALIGN_W
