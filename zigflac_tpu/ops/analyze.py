"""Batched frame analysis — the encoder's decision kernels as XLA ops.

Everything the reference computes per frame in serial hot loops runs here as
integer tensor ops over a ``[n_frames, n_planes, block_size]`` batch:

* fixed-predictor order search: difference cascade + first-min argmin of
  sum-of-abs residuals, wide-mode i32-overflow disqualification
  (reference hot loop #1: libFLAC/fixed.zig:88-168)
* residual computation via the binomial-coefficient form of the k-th
  difference (reference hot loop #2: libFLAC/fixed.zig:27-74)
* Rice parameter estimation: zigzag partition-sum pyramid + flake cost
  sweep with exact u64 wrapping semantics, smallest-param /
  largest-partition-order tie-breaks, selectable escape params
  (reference hot loop #3: libFLAC/rice.zig:237-375)
* Constant/Verbatim/Fixed selection with strict ``<`` and header-less
  size accounting (libFLAC/Encoder.zig:320-376)

All shapes are static; every decision is branch-free (select/where), so the
whole analysis jits into one fused XLA program.
"""

from __future__ import annotations

from typing import List, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import EncoderConfig, MAX_FIXED_ORDER, MAX_RICE_PARAM_4BIT

# numpy scalar, NOT jnp: a module-level jnp constant is a concrete device
# array, and jit CAPTURES it as a program input instead of inlining the
# literal, which costs a transfer on every execution. np scalars inline at
# trace time.
U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# res_k[i] = sum_m BINOM[k][m] * s[i-m]  (k-th difference; matches the
# predictor form of libFLAC/fixed.zig:9-15)
BINOM = np.array(
    [
        [1, 0, 0, 0, 0],
        [1, -1, 0, 0, 0],
        [1, -2, 1, 0, 0],
        [1, -3, 3, -1, 0],
        [1, -4, 6, -4, 1],
    ],
    dtype=np.int64,
)


class PlaneAnalysis(NamedTuple):
    """Per-plane decisions; leading dims match the input's batch dims."""

    kind: jnp.ndarray        # i32: 0 constant, 1 verbatim, 2 fixed, 3 lpc
    est_bits: jnp.ndarray    # u64: header-less size estimate for mode argmin
    order: jnp.ndarray       # i32: predictor order (fixed 0..4, lpc 1..32)
    method: jnp.ndarray      # i32: 0 = 4-bit rice params, 1 = 5-bit
    part_order: jnp.ndarray  # i32: rice partition order 0..8
    params: jnp.ndarray      # u8 [..., 256]: rice param per partition
    residuals: jnp.ndarray   # i32 [..., B]: first `order` slots are 0
    qcoeffs: jnp.ndarray     # i32 [..., 32]: quantized LPC coefficients
    qshift: jnp.ndarray      # i32 [...]: LPC coefficient shift
    wasted: jnp.ndarray      # i32 [...]: shaved trailing zero bits (extension)
    sweep_unsafe: jnp.ndarray  # bool scalar: speculative u32 rice sweep hit
                               # a >=2^31 partition sum; results invalid,
                               # caller must re-encode exactly
    res_lpc: jnp.ndarray = None  # i32 [..., B] LPC-candidate residuals, or
                                 # None. When present, ``residuals`` holds
                                 # the FIXED candidate and the plane's
                                 # choice is ``kind`` (3 = lpc): callers
                                 # fold the select into their own gather
                                 # pass instead of this module streaming a
                                 # [..., B] where-merge nobody reads twice
                                 # (the merge fusion measured 0.3 ms/batch
                                 # at 441 GB/s, r5). Rows with kind < 2
                                 # never read either residual array.


def _ilog2(v: int) -> int:
    return v.bit_length() - 1


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


def zigzag_u32(res: jnp.ndarray) -> jnp.ndarray:
    """u32 zigzag with i32 wrapping shift (libFLAC/rice.zig:268-271)."""
    r = res.astype(jnp.int32)
    return (r.astype(jnp.uint32) << jnp.uint32(1)) ^ (r >> jnp.int32(31)).astype(
        jnp.uint32
    )


def shift_right_zero(x: jnp.ndarray, m: int) -> jnp.ndarray:
    """x shifted m positions along the last axis, zero-filled at the front."""
    if m == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(m, 0)]
    return jnp.pad(x, pad)[..., : x.shape[-1]]


def _tree_or(x: jnp.ndarray) -> jnp.ndarray:
    """OR-reduce the last axis with a halving tree of elementwise ORs
    (a custom lax.reduce computation can lower to a serial loop)."""
    n = x.shape[-1]
    while n > 1:
        if n % 2:
            x = jnp.concatenate([x, jnp.zeros_like(x[..., :1])], -1)
            n += 1
        half = n // 2
        x = x[..., :half] | x[..., half:]
        n = half
    return x[..., 0]


def best_fixed_order(planes: jnp.ndarray, wide: bool):
    """(order i32, ok i1, totals u64[5]) per plane — first-min argmin of
    sum-of-abs over the difference cascade; wide mode marks any order whose
    residuals exceed i32 with u64::max and reports whether the winner is
    usable (libFLAC/fixed.zig:88-168)."""
    i32_max = jnp.uint64((1 << 31) - 1)
    # depth < 28 (normal mode): every difference fits int32; wide mode
    # needs int64 (33-bit side samples, up to 37-bit diffs).
    # Each order's difference is computed DIRECTLY from the input via its
    # binomial taps (d_k[i] = sum_m BINOM[k][m] * x[i+k-m]) instead of
    # cascading d_k = diff(d_{k-1}): the cascade materialized three
    # [planes, ~B] intermediates to HBM (each multi-use: the next diff +
    # its own reduce — ~0.9 ms of pure traffic per 1024-frame batch at
    # 16-bit), while the tap form gives five sibling reduces over shifted
    # slices of ONE buffer, which XLA fuses without materializing any
    # difference tensor. The values are the same exact integers, so
    # order/argmin/bytes are unchanged.
    x = planes.astype(jnp.int64) if wide else planes.astype(jnp.int32)
    B = x.shape[-1]
    totals = []
    for k in range(MAX_FIXED_ORDER + 1):
        dk = None
        for m in range(k + 1):
            c = int(BINOM[k][m])
            sl = x[..., k - m : B - m] if k else x
            term = sl if c == 1 else (-sl if c == -1 else c * sl)
            dk = term if dk is None else dk + term
        a = jnp.abs(dk)
        total = a.astype(jnp.uint64).sum(axis=-1)
        if wide:
            overflow = _tree_or(a.astype(jnp.uint64)) > i32_max
            total = jnp.where(overflow, U64_MAX, total)
        totals.append(total)
    tstack = jnp.stack(totals)  # [5, ...]
    order = jnp.argmin(tstack, axis=0).astype(jnp.int32)  # first-min
    if wide:
        best_total = totals[0]
        for k in range(1, MAX_FIXED_ORDER + 1):
            best_total = jnp.where(order == k, totals[k], best_total)
        ok = best_total != U64_MAX
    else:
        ok = jnp.ones(order.shape, dtype=bool)
    return order, ok, tstack


def residuals_for_order(planes: jnp.ndarray, order: jnp.ndarray) -> jnp.ndarray:
    """Residuals of the (per-plane dynamic) chosen order as i32, first
    ``order`` slots zeroed. Computed as one pass with gathered binomial
    coefficients instead of materializing all five cascades."""
    B = planes.shape[-1]
    coeffs = jnp.asarray(BINOM)[order]  # [..., 5]
    wide_in = planes.dtype == jnp.int64
    acc_dtype = jnp.int64 if wide_in else jnp.int32
    acc = jnp.zeros(planes.shape, dtype=acc_dtype)
    p = planes.astype(acc_dtype)
    for m in range(MAX_FIXED_ORDER + 1):
        c = coeffs[..., m].astype(acc_dtype)[..., None]
        acc = acc + c * shift_right_zero(p, m)
    idx = jax.lax.broadcasted_iota(jnp.int32, planes.shape, planes.ndim - 1)
    acc = jnp.where(idx < order[..., None], 0, acc)
    return acc.astype(jnp.int32)


def rice_sums_pyramid(zz: jnp.ndarray, po_top: int) -> List[jnp.ndarray]:
    """sums[po][p] = sum of zigzags in partition p at order po (u64). The
    warmup slots are already zero in our residual arrays, which equals the
    reference's explicit warmup subtraction (libFLAC/rice.zig:295-297)."""
    B = zz.shape[-1]
    z = zz.astype(jnp.uint64)
    part = 1 << po_top
    top = z.reshape(*z.shape[:-1], part, B >> po_top).sum(axis=-1)
    sums = [None] * (po_top + 1)
    sums[po_top] = top
    for po in range(po_top - 1, -1, -1):
        prev = sums[po + 1]
        sums[po] = prev[..., 0::2] + prev[..., 1::2]
    return sums


def rice_estimate(
    residuals: jnp.ndarray,
    order: jnp.ndarray,
    block_size: int,
    max_rice_order: int,
    max_param: int,
    zz_bits: int = 32,
    speculate: bool = False,
    spec_po: int = 6,
    agg_proven_rows: int = 0,
):
    """(bits u64, method i32, part_order i32, params u8[...,256], unsafe
    bool scalar) — the flake
    estimate with every reference tie-break (libFLAC/rice.zig:237-375):
    per-partition cost = psize*(k+1) + ((sum -% psize/2) >> k) in wrapping
    u64, smallest param wins cost ties, escape param (max_param+1) costs
    psize*param, all-zero partitions cost 5, partition-order ties keep the
    larger order, and the order is clamped by ctz(B) and the predictor
    order's log2 limit.

    ``zz_bits``: static bound with zigzag values < 2**zz_bits (pass 32 when
    unknown). Partition levels whose sums provably fit 32 bits sweep in
    u32 — the u64-emulated sweep is the analysis hot spot (measured
    ~1.3 ms/1024-frame 16-bit batch, a 2.4k-op fusion) and the u32 result
    is bit-identical: non-underflowing rows never wrap in either width,
    and rows with s < psz/2 always select k=0 under the reference's
    wrapping-u64 semantics (every k >= 1 candidate lands near 2^(64-k),
    far above any real cost), which a post-sweep fixup reproduces.

    ``speculate``: sweep EVERY level in u32 and instead *detect* sums
    >= 2^31 among the proof-unsafe levels, reporting them in the returned
    ``unsafe`` flag. The caller must then discard the whole result and
    re-run an exact program (the encode pipeline folds ``unsafe`` into
    its capacity-ladder overflow, whose tier-1 re-encode sweeps exactly) —
    this wins the u32 sweep for 24-bit content and LPC candidates, whose
    residuals have no useful static bound, at the cost of a rare
    re-encode on pathological content.

    ``agg_proven_rows``: static count of LEADING batch rows (1-D batch,
    row = minor axis) carrying an AGGREGATE magnitude proof: every
    partition sum of those rows is < 2^31 at every level, so ALL their
    columns sweep u32 exactly — no speculation, no detector. The proof
    (analyze_planes): fixed residuals come from the first-min argmin over
    orders 0..4 including order 0, so sum|res| <= sum|res_0| = sum|x| <
    B * 2^sample_size, and the level-0 zigzag sum is < 2^(ceil_log2(B) +
    sample_size + 1) — under 2^31 whenever ceil_log2(B) + sample_size
    <= 30 (16-bit/4096: 2^29). When only a PREFIX of rows is proven (the
    merged fixed+LPC sweep), the remaining rows still need ``speculate``:
    the detector then covers every unproven column of the unproven rows
    alone."""
    B = block_size
    po_top = min(max_rice_order, _ctz(B))
    K = max_param + 2  # sweep covers 0..max_param+1 (escape inclusive)

    zz = zigzag_u32(residuals)
    sums = rice_sums_pyramid(zz, po_top)

    # dynamic per-plane partition-order clamp from the predictor order:
    # log2(B) - floor(log2(order)); order 0 -> 15 (rice.zig:76-80)
    L = _ilog2(B)
    limit_by_order = np.array(
        [15] + [L - _ilog2(k) for k in range(1, 33)], dtype=np.int32
    )
    dyn_max_po = jnp.minimum(jnp.asarray(limit_by_order)[order], po_top)

    batch_shape = order.shape

    # The k sweep and the whole per-level selection run BATCH-MINOR: every
    # tensor is [..., parts, N] with the frame batch on the last axis.
    # In the [..., N, parts] orientation the scalar outputs (totals,
    # method — [..., N]) prefer N-minor layouts, XLA's layout assignment
    # back-propagates that preference into the 3D sweep tensors, and the
    # program fills with transpose copies + serialized kLoop fusions
    # (measured ~2 ms of a 1024-frame batch). Batch-minor end to end, the
    # only transposes are one [.., N, 256] u64 level-top (below) and the
    # [.., 256, N] -> [.., N, 256] params at the end — both cheap.
    col_po = np.concatenate(
        [np.full(1 << po, po, np.int32) for po in range(po_top + 1)]
    )
    col_psz = (B >> col_po).astype(np.uint64)[:, None]  # [511, 1]
    col_first = np.concatenate(
        [np.arange(1 << po) == 0 for po in range(po_top + 1)]
    )[:, None]
    # transpose the pyramid top once, then rebuild the coarser levels with
    # strided adds on the parts axis (axis -2)
    top_t = jnp.swapaxes(sums[po_top], -1, -2)  # [..., 256, N]
    sums_t = [None] * (po_top + 1)
    sums_t[po_top] = top_t
    for po in range(po_top - 1, -1, -1):
        prev = sums_t[po + 1]
        sums_t[po] = prev[..., 0::2, :] + prev[..., 1::2, :]
    s_all = jnp.concatenate(
        [sums_t[po] for po in range(po_top + 1)], axis=-2
    )  # [..., 511, N] u64, level 0 first

    def sweep(s, psz, dt):
        """The unrolled k sweep + escape/zero fixes in width ``dt``. (As a
        fori_loop the carries round-trip HBM every iteration; unrolled,
        XLA fuses the whole sweep into one elementwise kernel.)"""
        lhs = s - psz // dt(2)  # wrapping subtract
        best_bc = psz + lhs  # k = 0
        best_k = jnp.zeros(s.shape, jnp.int32)
        for k in range(1, K):
            bc = psz * dt(k + 1) + (lhs >> dt(k))
            smaller = bc < best_bc
            best_k = jnp.where(smaller, k, best_k)
            best_bc = jnp.minimum(bc, best_bc)
        esc = best_k == max_param + 1
        best_bc = jnp.where(esc, psz * dt(max_param + 1), best_bc)
        zero = s == 0
        best_k = jnp.where(zero, max_param + 1, best_k)
        best_bc = jnp.where(zero, dt(5), best_bc)
        return best_k, best_bc

    # level-po partition sums are < 2^(log2(B) - po + zz_bits): levels at
    # or above proof_cut_po sweep in u32 (bit-identical, see docstring).
    # Under ``speculate``, levels >= spec_po also sweep in u32 with
    # dynamic detection: the coarse levels stay exact because (a) they are
    # only 2^spec_po - 1 of the 2^(po_top+1) - 1 columns (~12% of the
    # sweep at the default 6) and (b) ordinary loud 24-bit content really
    # does push coarse-partition sums past 2^31 (128-sample noise
    # partitions sit ~2^30.7), which would make the whole-batch fallback
    # fire routinely; at 64-sample partitions the margin is ~2.5x and only
    # adversarial content trips it. Callers whose residuals carry a
    # tighter magnitude story (16-bit LPC: |zz| < 2^31 by the
    # lpc_residuals proof, level-3 sums ~2^23 on real content with >100x
    # margin to the detector) pass spec_po=3 — the u64 leg shrinks from
    # 63 columns to 7, and a trip still only costs the exact re-encode.
    proof_cut_po = min(max(L + zz_bits - 31, 0), po_top + 1)
    cut_po = min(proof_cut_po, spec_po) if speculate else proof_cut_po
    if agg_proven_rows:
        assert order.ndim == 1, "aggregate row proof needs a 1-D batch"
        if agg_proven_rows >= order.shape[0]:
            proof_cut_po = cut_po = 0  # fully proven: pure exact u32 sweep
        elif speculate:
            cut_po = 0  # detector below covers the unproven-row suffix
        else:
            agg_proven_rows = 0  # partial proof needs detection to sweep u32
    cut = (1 << cut_po) - 1  # column offset of the first u32-swept level
    unsafe = jnp.zeros((), bool)
    if speculate and proof_cut_po > cut_po:
        hi = min((1 << proof_cut_po) - 1, s_all.shape[-2])
        unsafe = (
            s_all[..., cut:hi, agg_proven_rows:] >= jnp.uint64(1 << 31)
        ).any()
    order_t = order[..., None, :]  # [..., 1, N]
    col_psz_j = jnp.asarray(col_psz)
    col_first_j = jnp.asarray(col_first)
    parts = []
    if cut > 0:
        psz64 = jnp.where(
            col_first_j[:cut], col_psz_j[:cut] - order_t.astype(jnp.uint64),
            col_psz_j[:cut],
        )
        parts.append(sweep(s_all[..., :cut, :], psz64, jnp.uint64))
    if cut_po <= po_top:
        s32 = s_all[..., cut:, :].astype(jnp.uint32)
        psz32 = jnp.where(
            col_first_j[cut:],
            col_psz_j[cut:].astype(jnp.uint32) - order_t.astype(jnp.uint32),
            col_psz_j[cut:].astype(jnp.uint32),
        )
        k32, bc32 = sweep(s32, psz32, jnp.uint32)
        # s < psz/2 rows (s > 0 — all-zero rows keep the zero fix): the
        # u64 reference sweep always keeps k = 0 with the wrapped cost
        # psz + (s -% psz/2) = psz - psz/2 + s
        under = (s32 < psz32 // jnp.uint32(2)) & (s32 != 0)
        k32 = jnp.where(under, 0, k32)
        bc32 = jnp.where(under, psz32 - psz32 // jnp.uint32(2) + s32, bc32)
        parts.append((k32, bc32.astype(jnp.uint64)))
    if len(parts) == 2:
        best_k = jnp.concatenate([parts[0][0], parts[1][0]], axis=-2)
        best_bc = jnp.concatenate([parts[0][1], parts[1][1]], axis=-2)
    else:
        best_k, best_bc = parts[0]

    totals = []
    methods = []
    params_padded = []
    start = 0
    pad_cfg = [(0, 0)] * (order.ndim - 1) + [(0, 0), (0, 0)]
    for po in range(po_top + 1):
        nparts = 1 << po
        k_lvl = best_k[..., start : start + nparts, :]
        if max_param > MAX_RICE_PARAM_4BIT:
            method = (k_lvl > MAX_RICE_PARAM_4BIT).any(axis=-2).astype(jnp.int32)
        else:
            method = jnp.zeros(batch_shape, jnp.int32)
        # tree-sum the partition costs (halving strided adds instead of a
        # minor-axis u64 reduce)
        bc_total = best_bc[..., start : start + nparts, :]
        m = nparts
        while m > 1:
            bc_total = bc_total[..., 0::2, :] + bc_total[..., 1::2, :]
            m >>= 1
        total = bc_total[..., 0, :] + (
            method.astype(jnp.uint64) + 4
        ) * jnp.uint64(nparts)
        total = jnp.where(dyn_max_po >= po, total, U64_MAX)
        totals.append(total)
        methods.append(method)
        pad_cfg[-2] = (0, 256 - nparts)
        params_padded.append(jnp.pad(k_lvl.astype(jnp.uint8), pad_cfg))
        start += nparts

    tstack = jnp.stack(totals)  # [PO+1, ...]
    # ties keep the larger partition order (<= in rice.zig:258) -> last-min
    best_po = (po_top - jnp.argmin(tstack[::-1], axis=0)).astype(jnp.int32)
    # where-chain selects (take_along_axis lowers as per-element gathers)
    bits, method, params = totals[0], methods[0], params_padded[0]
    for po in range(1, po_top + 1):
        at = best_po == po
        bits = jnp.where(at, totals[po], bits)
        method = jnp.where(at, methods[po], method)
        params = jnp.where(at[..., None, :], params_padded[po], params)
    return bits, method, best_po, jnp.swapaxes(params, -1, -2), unsafe


def _apply_wasted(planes: jnp.ndarray, sample_size: int, config):
    """Wasted-bits shave (extension — the reference always writes 0): the
    common trailing zero bits of the plane come off and the samples encode
    at a reduced width; the subframe header carries k. Shared by the
    analysis and the LPC lag-sum program so both see identical planes."""
    batch_shape = planes.shape[:-1]
    if not config.wasted_bits:
        return planes, jnp.zeros(batch_shape, jnp.int32)
    ored = _tree_or(planes)
    bw = 64 if planes.dtype == jnp.int64 else 32
    lowbit = ored & (-ored)
    ctz = (bw - 1) - jax.lax.clz(lowbit)
    wasted = jnp.where(ored != 0, ctz, 0).astype(jnp.int32)
    wasted = jnp.clip(wasted, 0, sample_size - 1)
    return planes >> wasted[..., None].astype(planes.dtype), wasted


def analyze_planes(
    planes: jnp.ndarray,
    bits_of_t: int,
    sample_size: int,
    block_size: int,
    config: EncoderConfig,
    speculate: bool = False,
) -> PlaneAnalysis:
    """Full per-plane subframe decision (libFLAC/Encoder.zig:320-376).

    ``planes``: [..., B] int32 (or int64 for the 32-bit-depth side channel).
    ``bits_of_t``: 32 or 64 — the reference compares against
    ``@bitSizeOf(SampleT)``, not the real encoded width.
    ``sample_size``: the streaminfo bit depth (NOT +1 for side planes; the
    reference passes the raw depth to chooseSubframeEncoding).

    Multi-dim batches are FLATTENED to one axis for the whole analysis and
    unflattened at exit: with a 3D [P, N, X] working set, XLA's layout
    assignment can shuffle the P axis through transposing copies; flat
    [P*N, X] tensors stay in natural {1,0} layouts end to end. The
    boundary reshapes merge/split leading axes only, so they are free.
    """
    batch_shape = planes.shape[:-1]
    if len(batch_shape) > 1:
        m = int(np.prod(batch_shape))
        nb = len(batch_shape)
        flat = lambda x: x.reshape((m,) + x.shape[nb:])
        a = analyze_planes(
            flat(planes), bits_of_t, sample_size, block_size, config,
            speculate=speculate,
        )
        return PlaneAnalysis(
            *[v if v is None or v.ndim == 0
              else v.reshape(batch_shape + v.shape[1:])
              for v in a]
        )
    B = block_size
    assert planes.shape[-1] == B
    batch_shape = planes.shape[:-1]
    wide = not (sample_size < 28 and bits_of_t == 32)

    planes, wasted = _apply_wasted(planes, sample_size, config)

    all_eq = (planes == planes[..., :1]).all(axis=-1)
    verb_bits = jnp.uint64(B * bits_of_t)
    z32 = jnp.zeros(batch_shape, jnp.int32)
    zq = jnp.zeros(batch_shape + (32,), jnp.int32)

    lpc_order = config.lpc_order if config.prediction == "lpc" else 0
    if B <= max(MAX_FIXED_ORDER, lpc_order) or config.prediction == "none":
        kind = jnp.where(all_eq, 0, 1).astype(jnp.int32)
        est = jnp.where(all_eq, jnp.uint64(bits_of_t), verb_bits)
        return PlaneAnalysis(
            kind=kind,
            est_bits=est,
            order=z32,
            method=z32,
            part_order=z32,
            params=jnp.zeros(batch_shape + (256,), jnp.uint8),
            residuals=jnp.zeros(batch_shape + (B,), jnp.int32),
            qcoeffs=zq,
            qshift=z32,
            wasted=wasted,
            sweep_unsafe=jnp.zeros((), bool),
        )

    order, ok, _totals = best_fixed_order(planes, wide)
    residuals = residuals_for_order(planes, order)
    max_param = min(
        30 if sample_size > 16 else MAX_RICE_PARAM_4BIT, config.max_rice_param
    )
    # zigzag bound for the u32 sweep split: samples are sample_size+1 bits
    # at most (side planes), order-4 residuals gain 4 bits, zigzag 1 more
    # wide (32-bit-depth) planes can push even fine-partition sums past
    # 2^31 on ordinary content, so speculation is limited to i32 planes
    speculate = speculate and not wide
    fixed_zz_bits = 32 if wide else min(sample_size + 6, 32)
    # aggregate magnitude proof for the FIXED rows (rice_estimate
    # docstring): chosen-order sum|res| <= order-0 sum|x| (first-min
    # argmin), so every partition sum < 2^(ceil_log2(B) + sample_size + 1)
    # — all levels sweep u32 exactly (no u64 leg, no detector) whenever
    # that clears 2^31. 16-bit/4096 blocks: sums < 2^29.
    agg_ok = (
        not wide
        and order.ndim == 1
        and (B - 1).bit_length() + sample_size <= 30
    )

    if config.prediction == "lpc":
        # extension: ONE LPC candidate competes with the best fixed
        # predictor on estimated bits + coefficient overhead (strict <).
        # The WHOLE derivation is in-program integer math — exact windowed
        # autocorrelation limb sums (ops/lpc.lag_sums) through the Q28
        # fixed-point Levinson + quantization (fixed_point_levinson) —
        # bit-identical to the golden oracle's numpy run of the same
        # integer ops, with no host round trip. The candidate ORDER is
        # picked from the recursion's prediction-error energies
        # (select_lpc_candidate — the reference's estimate-then-one-Rice-
        # pass philosophy, libFLAC/fixed.zig:88-168), so only one Rice
        # sweep and one residual computation run instead of one per
        # candidate order (the LPC mode's dominant cost).
        from .lpc import (
            fixed_point_levinson,
            lag_sums,
            lpc_candidate_orders,
            lpc_residuals,
            select_lpc_candidate,
        )

        lags = lag_sums(planes, config.lpc_order, sample_size)
        pre = fixed_point_levinson(
            lags, lpc_candidate_orders(config.lpc_order),
            config.lpc_precision, jnp,
        )
        l_order, l_q, l_shift, l_okq = select_lpc_candidate(
            pre, B, config.lpc_precision, jnp
        )
        l_res, l_fits = lpc_residuals(
            planes, l_q, l_shift, l_order, config.lpc_order, jnp,
            sample_size=sample_size,
        )
        l_ok = l_okq & l_fits
        if speculate and order.ndim == 1:
            # ONE merged sweep over [fixed; lpc] rows (concatenated on the
            # batch-minor axis): the zigzag + pyramid + k-sweep + level
            # selection run as half the fusions of two separate calls —
            # fewer ops matter where the LPC program is bound by op
            # count rather than bytes. Row results are bit-identical to
            # separate calls: both row groups share the same column split
            # (16-bit: spec_po=3 == the fixed rows' proof cut; the
            # detector covers every unproven u32 column, and provably-safe
            # fixed rows can never trip it).
            both = rice_estimate(
                jnp.concatenate([residuals, l_res], axis=0),
                jnp.concatenate([order, l_order], axis=0),
                B, config.max_rice_order, max_param,
                zz_bits=32, speculate=True,
                spec_po=3 if sample_size <= 16 else 6,
                agg_proven_rows=order.shape[0] if agg_ok else 0,
            )
            m = order.shape[0]
            rice_bits, l_bits = both[0][:m], both[0][m:]
            method, l_method = both[1][:m], both[1][m:]
            part_order, l_po = both[2][:m], both[2][m:]
            params, l_params = both[3][:m], both[3][m:]
            sweep_unsafe = both[4]
        else:
            rice_bits, method, part_order, params, sweep_unsafe = (
                rice_estimate(
                    residuals, order, B, config.max_rice_order, max_param,
                    zz_bits=fixed_zz_bits, speculate=speculate,
                    agg_proven_rows=order.shape[0] if agg_ok else 0,
                )
            )
            l_bits, l_method, l_po, l_params, l_unsafe = rice_estimate(
                l_res, l_order, B, config.max_rice_order, max_param,
                speculate=speculate,
            )
            sweep_unsafe = sweep_unsafe | l_unsafe
        # a wide-mode overflow disqualifies the fixed candidate entirely
        rice_bits = jnp.where(ok, rice_bits, U64_MAX)
        qcoeffs, qshift = zq, z32
        l_cost = l_bits + (
            jnp.uint64(9)
            + l_order.astype(jnp.uint64) * jnp.uint64(config.lpc_precision)
        )
        better = l_ok & (l_cost < rice_bits)
        rice_bits = jnp.where(better, l_cost, rice_bits)
        method = jnp.where(better, l_method, method)
        part_order = jnp.where(better, l_po, part_order)
        params = jnp.where(better[..., None], l_params, params)
        # the [..., B] residual merge is NOT materialized here: callers
        # fold the kind==3 select into their gather pass (res_lpc field)
        res_lpc = l_res
        order = jnp.where(better, l_order, order)
        qcoeffs = jnp.where(better[..., None], l_q, qcoeffs)
        qshift = jnp.where(better, l_shift, qshift)
        use_lpc = better
        pred_kind = jnp.where(use_lpc, 3, 2).astype(jnp.int32)
    else:
        rice_bits, method, part_order, params, sweep_unsafe = rice_estimate(
            residuals, order, B, config.max_rice_order, max_param,
            zz_bits=fixed_zz_bits, speculate=speculate,
            agg_proven_rows=order.shape[0] if agg_ok else 0,
        )
        # a wide-mode overflow disqualifies the fixed candidate entirely
        rice_bits = jnp.where(ok, rice_bits, U64_MAX)
        qcoeffs, qshift = zq, z32
        use_lpc = jnp.zeros(batch_shape, bool)
        pred_kind = jnp.full(batch_shape, 2, jnp.int32)
        res_lpc = None

    use_pred = (ok | use_lpc) & (rice_bits < verb_bits) & ~all_eq
    kind = jnp.where(all_eq, 0, jnp.where(use_pred, pred_kind, 1)).astype(
        jnp.int32
    )
    est = jnp.where(
        all_eq, jnp.uint64(bits_of_t), jnp.where(use_pred, rice_bits, verb_bits)
    )
    return PlaneAnalysis(
        kind=kind,
        est_bits=est,
        order=order,
        method=method,
        part_order=part_order,
        params=params,
        residuals=residuals,
        qcoeffs=qcoeffs,
        qshift=qshift,
        wasted=wasted,
        sweep_unsafe=sweep_unsafe,
        res_lpc=res_lpc,
    )


class FrameWirePlan(NamedTuple):
    """Everything the packer needs, per frame, in wire-channel order.

    Arrays are WIRE-MAJOR [W, N, ...] (``channels_code`` alone is [N]):
    the whole analysis runs plane-major so every per-plane scalar tensor
    is [P, N] with the frame batch on the MINOR axis. Batch-minor [N, P]
    scalars can make XLA's layout assignment transpose them, and that
    layout back-propagates into the big [.., B] tensors as transpose
    copies.
    ``planes`` is int64 (covers the 33-bit side channel), ``sample_size``
    is per wire channel per frame (depth or depth+1 for side planes).
    """

    channels_code: jnp.ndarray  # i32 [N]
    kind: jnp.ndarray           # i32 [W, N]
    order: jnp.ndarray
    method: jnp.ndarray
    part_order: jnp.ndarray
    sample_size: jnp.ndarray    # i32 [W, N]
    params: jnp.ndarray         # u8 [W, N, 256]
    planes: jnp.ndarray         # i32 [W, N, B] (i64 iff depth 32 stereo)
    residuals: jnp.ndarray      # i32 [W, N, B]
    qcoeffs: jnp.ndarray        # i32 [W, N, 32]
    qshift: jnp.ndarray         # i32 [W, N]
    wasted: jnp.ndarray         # i32 [W, N]: shaved bits (0 unless enabled)
    sweep_unsafe: jnp.ndarray   # bool scalar (see PlaneAnalysis)


def plan_frames_indep(
    frames: jnp.ndarray, depth: int, config: EncoderConfig,
    speculate: bool = False,
) -> FrameWirePlan:
    """Independent channels: each analyzed and written as-is
    (libFLAC/Encoder.zig:242-247)."""
    n, c, B = frames.shape
    pm = jnp.moveaxis(frames, 1, 0)  # [c, n, B] plane-major
    a = analyze_planes(pm, 32, depth, B, config, speculate=speculate)
    planes_w = pm >> a.wasted[..., None]
    residuals = a.residuals
    if a.res_lpc is not None:
        residuals = jnp.where(
            (a.kind == 3)[..., None], a.res_lpc, residuals
        )
    return FrameWirePlan(
        channels_code=jnp.full((n,), c - 1, jnp.int32),
        kind=a.kind,
        order=a.order,
        method=a.method,
        part_order=a.part_order,
        sample_size=depth - a.wasted,
        params=a.params,
        planes=planes_w,
        residuals=residuals,
        qcoeffs=a.qcoeffs,
        qshift=a.qshift,
        wasted=a.wasted,
        sweep_unsafe=a.sweep_unsafe,
    )


def plan_frames_stereo(
    frames: jnp.ndarray, depth: int, config: EncoderConfig,
    speculate: bool = False,
) -> FrameWirePlan:
    """stereo_auto: build L/R/M/S planes, analyze all four, pick the mode
    with the first-min of {L+R, L+S, S+R, M+S}, and emit the two wire
    channels (libFLAC/Encoder.zig:248-314)."""
    n, c, B = frames.shape
    assert c == 2
    left = frames[:, 0]
    right = frames[:, 1]
    l64 = left.astype(jnp.int64)
    r64 = right.astype(jnp.int64)
    mid = ((l64 + r64) >> 1).astype(jnp.int32)
    side64 = l64 - r64

    # The four planes ride through the analysis FLAT on one [4n, B] batch
    # axis (plane-major: rows [k*n, (k+1)*n) are plane k). A [4, n, B]
    # stack costs two full relayout copies at the analysis boundary:
    # the packer-facing stack
    # materializes batch-minor {1,2,0}, analyze_planes' flatten transposes
    # it to sample-minor {2,1,0}, and the residual unflatten transposes
    # back. Flat concat + major-axis row slices are layout-free both ways;
    # the only batch-minor materialization left is gather_ch's output
    # stack, which must exist anyway.
    if depth == 32:
        lrm = jnp.concatenate([left, right, mid], axis=0)  # [3n, B] i32
        a3 = analyze_planes(lrm, 32, depth, B, config, speculate=speculate)
        a_s = analyze_planes(
            side64, 64, depth, B, config, speculate=speculate
        )
        est = jnp.concatenate([a3.est_bits, a_s.est_bits], axis=0)
        kind = jnp.concatenate([a3.kind, a_s.kind], axis=0)
        order = jnp.concatenate([a3.order, a_s.order], axis=0)
        method = jnp.concatenate([a3.method, a_s.method], axis=0)
        part_order = jnp.concatenate(
            [a3.part_order, a_s.part_order], axis=0
        )
        params = jnp.concatenate([a3.params, a_s.params], axis=0)
        residuals = jnp.concatenate(
            [a3.residuals, a_s.residuals], axis=0
        )
        res_lpc = (
            None if a3.res_lpc is None
            else jnp.concatenate([a3.res_lpc, a_s.res_lpc], axis=0)
        )
        qcoeffs = jnp.concatenate([a3.qcoeffs, a_s.qcoeffs], axis=0)
        qshift = jnp.concatenate([a3.qshift, a_s.qshift], axis=0)
        wasted = jnp.concatenate([a3.wasted, a_s.wasted], axis=0)
        sweep_unsafe = a3.sweep_unsafe | a_s.sweep_unsafe
        planes_w = jnp.concatenate(
            [lrm.astype(jnp.int64), side64], axis=0
        ) >> wasted[..., None].astype(jnp.int64)
        # [4n, B] — i64: the side channel is 33-bit at depth 32
    else:
        side = side64.astype(jnp.int32)
        lrms = jnp.concatenate([left, right, mid, side], axis=0)  # [4n, B]
        a = analyze_planes(lrms, 32, depth, B, config, speculate=speculate)
        est, kind, order, method = a.est_bits, a.kind, a.order, a.method
        part_order, params, residuals = a.part_order, a.params, a.residuals
        qcoeffs, qshift = a.qcoeffs, a.qshift
        wasted = a.wasted
        sweep_unsafe = a.sweep_unsafe
        res_lpc = a.res_lpc
        planes_w = lrms >> wasted[..., None]
        # i32: all planes fit (side <= depth+1 <= 25 bits)

    # mode sums in plane order [L, R, M, S] = row groups 0,1,2,3
    pl = lambda x, k: x[k * n:(k + 1) * n]
    sums = jnp.stack(
        [
            pl(est, 0) + pl(est, 1),  # Indep
            pl(est, 0) + pl(est, 3),  # LeftSide
            pl(est, 3) + pl(est, 1),  # SideRight
            pl(est, 2) + pl(est, 3),  # MidSide
        ],
        axis=0,
    )
    ch_type = jnp.argmin(sums, axis=0).astype(jnp.int32)  # first-min, [n]

    # wire-channel planes per mode (L,R,M,S = 0,1,2,3): wire0 = [L,L,S,M],
    # wire1 = [R,S,R,S]. Elementwise selects, not per-element gathers
    # over the big [4n, B] tensors.
    def gather_ch(x):
        ct = ch_type.reshape(n, *([1] * (x.ndim - 1)))
        w0 = jnp.where(
            ct <= 1, pl(x, 0), jnp.where(ct == 2, pl(x, 3), pl(x, 2))
        )
        w1 = jnp.where((ct == 0) | (ct == 2), pl(x, 1), pl(x, 3))
        return jnp.stack([w0, w1], axis=0)

    # residuals gather with the LPC-candidate select FOLDED IN: plane k's
    # residual is res_lpc when its kind == 3 (rows with kind < 2 never
    # read either) — one fused select tree instead of analyze_planes
    # materializing a merged [4n, B] array this pass immediately rereads
    if res_lpc is None:
        residuals_w = gather_ch(residuals)
    else:
        rk = lambda k: jnp.where(
            (pl(kind, k) == 3)[:, None], pl(res_lpc, k), pl(residuals, k)
        )
        ct1 = ch_type[:, None]
        rw0 = jnp.where(ct1 <= 1, rk(0), jnp.where(ct1 == 2, rk(3), rk(2)))
        rw1 = jnp.where((ct1 == 0) | (ct1 == 2), rk(1), rk(3))
        residuals_w = jnp.stack([rw0, rw1], axis=0)

    # side sits at wire 0 for SideRight, wire 1 for LeftSide/MidSide; the
    # side channel is written with depth+1 bits (libFLAC/Encoder.zig:203-206);
    # wasted bits (extension) reduce the wire width per plane
    wasted_w = gather_ch(wasted)
    ss0 = depth + (ch_type == 2).astype(jnp.int32) - wasted_w[0]
    ss1 = depth + ((ch_type == 1) | (ch_type == 3)).astype(jnp.int32) - wasted_w[1]

    return FrameWirePlan(
        channels_code=jnp.where(ch_type == 0, 1, ch_type + 7).astype(jnp.int32),
        kind=gather_ch(kind),
        order=gather_ch(order),
        method=gather_ch(method),
        part_order=gather_ch(part_order),
        sample_size=jnp.stack([ss0, ss1], axis=0),
        params=gather_ch(params),
        planes=gather_ch(planes_w),
        residuals=residuals_w,
        qcoeffs=gather_ch(qcoeffs),
        qshift=gather_ch(qshift),
        wasted=wasted_w,
        sweep_unsafe=sweep_unsafe,
    )


def plan_frames(
    frames: jnp.ndarray, depth: int, config: EncoderConfig,
    speculate: bool = False,
) -> FrameWirePlan:
    if config.stereo_auto:
        return plan_frames_stereo(frames, depth, config, speculate=speculate)
    return plan_frames_indep(frames, depth, config, speculate=speculate)
