"""LPC (linear-prediction) subframes — the extension the reference stubs.

The reference lists LPC under "Progressing" and comments out its subframe
type (libFLAC/Encoder.zig:498-503, readme.md:24-27); BASELINE.json config 3
requires it: windowed autocorrelation + Levinson-Durbin + quantized
coefficients with error feedback + shifted integer prediction.

Determinism architecture (golden == device == any platform, by construction):

* The ENTIRE derivation is integer arithmetic — no float touches
  coefficients anywhere (float results can differ across backends in the
  last bits, which would break the byte-exactness invariant):
  - autocorrelation: samples windowed by a Q8 fixed-point Tukey(0.5)
    window (WINDOW_Q — see tukey_qw for why 8), each lag sum carried as three int64 limb partial sums (hi·hi,
    hi·lo+lo·hi, lo·lo over 24-bit limbs) — `lag_sums` (jnp) and
    `lag_sums_np` produce the same exact integers;
  - Levinson-Durbin + quantization: Q28 fixed point over int64 adds,
    multiplies, arithmetic shifts and floor divisions
    (`fixed_point_levinson`, one implementation parameterized by the
    array module) — each op is exact and identical in numpy and XLA, so
    the device runs it INSIDE the encode program (no lag fetch, no host
    pre-pass, no coefficient upload) and the golden oracle runs the same
    integers in numpy.
* Residual computation from quantized coefficients is integer (jnp on
  device, numpy in golden — exact either way).

Encoding behavior (ours to define — there is no reference bitstream to
match): analyze at the candidate orders below, Q8 Tukey(0.5) window,
precision ``config.lpc_precision`` bits, pick LPC over fixed/verbatim/
constant by the same header-less estimated-bits comparison the reference
uses between fixed and verbatim.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAX_LPC_ORDER = 32

_LIMB = 24  # limb width: |windowed sample| <= 2^47 -> hi <= 2^23; products
#             <= 2^48, summed over <= 2^15 samples -> < 2^63 (no overflow)


@lru_cache(maxsize=32)
def tukey_window(n: int, alpha: float = 0.5) -> np.ndarray:
    """Tukey (tapered cosine) window, float64."""
    if n == 1:
        return np.ones(1)
    t = np.linspace(0.0, 1.0, n)
    w = np.ones(n)
    edge = alpha / 2.0
    lo = t < edge
    hi = t >= 1.0 - edge
    w[lo] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[lo] / alpha - 1.0)))
    w[hi] = 0.5 * (1.0 + np.cos(np.pi * (2.0 * t[hi] / alpha - 2.0 / alpha + 1.0)))
    return w


WINDOW_Q = 8  # window fixed-point fraction bits (see tukey_qw)


@lru_cache(maxsize=32)
def tukey_qw(n: int) -> np.ndarray:
    """The window the encoder actually uses: Q8 fixed point, int64.

    Q8 (scale 256) instead of the original Q15 because the window scale
    sets the lag-sum magnitude proof: |xw| < 2^(sample_size + WINDOW_Q),
    and at Q8 every depth <= 16 hits tier 0 of _lag_tier (ONE i64
    product-reduce per lag over a single aliased i32 buffer) and 24-bit
    hits tier 1 instead of the 4-product limb path. Window precision is
    an ENCODER QUALITY knob, not a correctness one (the stream carries
    quantized coefficients; any window yields a valid stream, golden and
    device share this one definition) — measured ratio impact of Q15->Q8
    on tonal+noise / chirp / quiet-noise / AR(2) content: <= +0.003%
    (r4; Q7 cost +0.083% on chirp, hence 8)."""
    return np.round(tukey_window(n) * float(1 << WINDOW_Q)).astype(np.int64)


def _lag_tier(sample_size, block_size: int) -> int:
    """Pick the cheapest exact product strategy for the lag sums from the
    magnitude proof |xw| <= 2^(sample_size+1+(WINDOW_Q-1)) (side planes
    carry one extra bit; the Q8 window adds WINDOW_Q, signed magnitude
    drops 1):

    * tier 0 — ONE i64 product per lag: the full product sum fits i64.
    * tier 1 — TWO products per lag (full x times y>>16 and y&0xFFFF):
      each partial sum fits i64 (covers 12/16-bit audio, the common
      case — HALF the multiplies and reduces of the limb path).
    * tier 2 — the general 24-bit-limb path (4 products per lag; the
      only one that handles 20/24/32-bit depths).

    The computed VALUE is identical in every tier (exact integers) and
    the normalized limb decomposition is unique, so the tier choice can
    never affect bytes — only speed."""
    if sample_size is None:
        return 2
    d = sample_size + 1 + (WINDOW_Q - 1)  # |xw| <= 2^d
    lb = max(int(block_size) - 1, 1).bit_length()  # ceil(log2 B)
    if 2 * d + lb <= 62:
        return 0
    if max(2 * d - 16, d + 16) + lb <= 62:
        return 1
    return 2


def _lag_sums_impl(planes, order: int, sample_size, xp):
    B = planes.shape[-1]
    x = planes.astype(xp.int64) * tukey_qw(B)
    m24 = np.int64((1 << _LIMB) - 1)
    tier = _lag_tier(sample_size, B)
    # Narrow operand storage: the product-reduces are memory-bound (the
    # i64 windowed signal is re-streamed once per product per lag), and an
    # i64 operand moves twice the bytes of an i32 one. Every
    # operand whose magnitude proof fits i32 is stored i32 and widened
    # back to i64 inside the product (the cast is exact and fuses into the
    # reduce): tier 0 always (|xw| <= 2^(16+WINDOW_Q) there), tier 1's x
    # iff sample_size+WINDOW_Q <= 31, tier 1's y>>16 always (<= 2^17
    # under the tier gate), tier 2's 24-bit limbs always (hi <= 2^23
    # since |xw| < 2^47).
    narrow = sample_size is not None and sample_size + WINDOW_Q <= 31
    if tier == 2:
        hi = (x >> np.int64(_LIMB)).astype(xp.int32)
        lo = (x & m24).astype(xp.int32)
    elif tier == 1:
        if narrow:
            # |xw| <= 2^31 - 2^15 under the narrow gate, so yh = xw >> 16
            # fits int16 and yl is an unsigned low half: 16-bit storage is
            # exact and halves the b-side stream of every lag reduce (the
            # widen back to i64 fuses into the product-reduce). Depths
            # 17-18 still reach tier 1 with |yh| up to 2^17 — those keep
            # i32 halves. Decomposing the products over the halves alone
            # (hh / hl+lh / ll with a limb recombine) to drop the i32 x
            # stream entirely was measured slower despite fewer bytes: the
            # all-16-bit operand reduces vectorize worse than the
            # i32-times-i16 form. Keep x i32 as the a-side.
            yh = (x >> np.int64(16)).astype(xp.int16)
            yl = (x & np.int64(0xFFFF)).astype(xp.uint16)
            x = x.astype(xp.int32)
        else:
            yh = (x >> np.int64(16)).astype(xp.int32)
            yl = (x & np.int64(0xFFFF)).astype(xp.int32)
    else:
        x = x.astype(xp.int32)
    out = []
    for k in range(order + 1):
        if tier == 0:
            a = x[..., k:] if k else x
            b = x[..., : B - k] if k else x
            s = (a.astype(xp.int64) * b).sum(axis=-1)
            c = s >> np.int64(_LIMB)
            out.append(
                xp.stack([c >> np.int64(_LIMB), c & m24, s & m24], axis=-1)
            )
        elif tier == 1:
            a = x[..., k:] if k else x
            bh = yh[..., : B - k] if k else yh
            bl = yl[..., : B - k] if k else yl
            s_h = (a.astype(xp.int64) * bh).sum(axis=-1)
            s_l = (a.astype(xp.int64) * bl).sum(axis=-1)
            # value = s_h*2^16 + s_l = A*2^24 + Bp, exactly (floor
            # semantics throughout: two's-complement >> and & are the
            # floor decomposition)
            A = s_h >> np.int64(8)
            Bp = ((s_h & np.int64(0xFF)) << np.int64(16)) + s_l
            c = Bp >> np.int64(_LIMB)
            m = A + c
            out.append(
                xp.stack([m >> np.int64(_LIMB), m & m24, Bp & m24], axis=-1)
            )
        else:
            ah = hi[..., k:] if k else hi
            al = lo[..., k:] if k else lo
            bh = hi[..., : B - k] if k else hi
            bl = lo[..., : B - k] if k else lo
            ah64, al64 = ah.astype(xp.int64), al.astype(xp.int64)
            hh = (ah64 * bh).sum(axis=-1)
            hl = (ah64 * bl).sum(axis=-1) + (al64 * bh).sum(axis=-1)
            ll = (al64 * bl).sum(axis=-1)
            qll = ll >> np.int64(_LIMB)
            rll = ll & m24
            hl2 = hl + qll
            qhl = hl2 >> np.int64(_LIMB)
            rhl = hl2 & m24
            out.append(xp.stack([hh + qhl, rhl, rll], axis=-1))
    return xp.stack(out, axis=-2)


def lag_sums(planes: jnp.ndarray, order: int, sample_size=None) -> jnp.ndarray:
    """Exact integer windowed autocorrelation limb sums on device.

    ``planes`` int [..., B] -> [..., order+1, 3] int64 where lag k's exact
    value is ``l0·2^48 + l1·2^24 + l2`` (a ~96-bit integer carried as
    three normalized partials). Bit-identical to ``lag_sums_np`` on any
    backend and at any tier (see _lag_tier; pass ``sample_size`` to let
    shallow depths use 1-2 products per lag instead of 4 — measured 6.1 ms
    of the 11.4 ms LPC-mode delta at 16-bit before tiering)."""
    return _lag_sums_impl(planes, order, sample_size, jnp)


def lag_sums_np(planes: np.ndarray, order: int, sample_size=None) -> np.ndarray:
    """numpy mirror of ``lag_sums`` (golden path) — same exact integers,
    same limb normalization (so fixed_point_levinson sees byte-identical
    integer inputs from either backend)."""
    return _lag_sums_impl(planes, order, sample_size, np)


_Q = 28  # Levinson fixed-point fraction bits


def _bitlen_nonneg(x, xp):
    """Bit length of a non-negative int64 array — pure integer binary
    search (identical in numpy and XLA; no clz dependency)."""
    n = xp.zeros_like(x)
    for sh in (32, 16, 8, 4, 2, 1):
        big = (x >> sh) > 0
        n = n + xp.where(big, sh, 0)
        x = xp.where(big, x >> sh, x)
    return n + (x > 0)


def _lags_q28(lags, xp):
    """Limb lag sums -> Q28 normalized autocorrelation r_k = v_k / v_0.

    Exact integer arithmetic: per frame, v_k >> s with s = bitlen(v_0)-30
    (|v_k| <= v_0 by Cauchy-Schwarz, so the shifted values fit ~31 bits;
    the s < 48 branch computes a*2^(48-s) + (lo48 >> s), exact because
    two's-complement limbs are already the floor decomposition), then
    r_k = (vs_k << 28) // vs_0. Every op floors identically in numpy and
    XLA."""
    a = lags[..., 0]
    lo48 = (lags[..., 1] << np.int64(_LIMB)) + lags[..., 2]  # [0, 2^48)
    a0 = a[..., 0:1]
    lo0 = lo48[..., 0:1]
    bl = xp.where(a0 > 0, 48 + _bitlen_nonneg(a0, xp), _bitlen_nonneg(lo0, xp))
    s = xp.maximum(bl - 30, 0)
    hi_sh = xp.minimum(xp.maximum(s - 48, 0), np.int64(63))
    lo_up = xp.maximum(48 - s, 0)
    lo_dn = xp.minimum(s, np.int64(47))
    vs = xp.where(
        s >= 48,
        a >> hi_sh,
        (a << lo_up) + (lo48 >> lo_dn),
    )
    v0 = xp.maximum(vs[..., 0:1], 1)
    return (vs << np.int64(_Q)) // v0  # Q28, r_0 == 2^28 exactly


def _quantize_selected(coeffs, cmax, order, max_order: int, precision: int,
                       xp):
    """Quantize the SELECTED candidate's Q28 coefficients to ``precision``
    signed bits with error feedback — the float scheme's exact integer
    twin: shift = precision-1 - (floor(log2 cmax)+1) in [0, 15], q_j =
    clamp(round(c_j * 2^shift + fb)) with round-half-up (a defined
    deterministic rule; both backends use it, so golden == device by
    construction). ``order`` is a per-plane tensor; the loop runs
    ``max_order`` static steps and masks q_j = 0 for j >= order (the old
    per-candidate form quantized each candidate order separately —
    sum(orders) tiny-op loop iterations plus [..., 32] where-merges per
    candidate; selecting the [..., max_order] Q28 snapshot first and
    quantizing once is bit-identical for j < order because the snapshot
    and the error-feedback history match, and the explicit mask pins
    j >= order to the old zero padding even when a clamped unstable
    recursion leaks feedback past the selected order)."""
    bl = _bitlen_nonneg(cmax, xp)  # floor(log2 cmax) = bl - 1 - _Q
    shift = xp.clip((precision - 1) - (bl - 1 - _Q + 1), 0, 15)
    qmax = np.int64((1 << (precision - 1)) - 1)
    qmin = np.int64(-(1 << (precision - 1)))
    half = np.int64(1 << (_Q - 1))
    zero = xp.zeros_like(order)
    fb = xp.zeros_like(cmax)
    qs = []
    for j in range(max_order):
        target = (coeffs[..., j] << shift) + fb
        q = xp.clip((target + half) >> np.int64(_Q), qmin, qmax)
        fb = target - (q << np.int64(_Q))
        qs.append(xp.where(j < order, q.astype(xp.int32), zero))
    qcoeffs = xp.stack(qs, axis=-1)
    return qcoeffs, shift.astype(xp.int32)


def fixed_point_levinson(lags, orders: Tuple[int, ...], precision: int, xp):
    """Limb lag sums -> quantized coefficients, in PURE INTEGER fixed
    point (Q28) — runs inside the device encode program (jnp) and in the
    golden oracle (numpy) with bit-identical results, so LPC needs no
    host round trip at all (the round-3 float flow fetched lag sums,
    ran IEEE f64 Levinson on host, and uploaded coefficients: ~40 ms of
    transfer per batch on thin links).

    ``lags`` int64 [..., max_order+1, 3] limbs -> list of ``(order,
    C i64 [..., max_order] Q28 coefficient snapshot, cmax i64 [...],
    ok bool, err Q28 int64)`` per candidate order (one recursion captures
    all of them; ``err`` is the recursion's prediction-error energy, the
    candidate-selection signal — see select_lpc_candidate, which picks
    ONE candidate and quantizes only it via _quantize_selected). All
    arithmetic is int64 adds / multiplies / arithmetic shifts / floor
    divisions — each exact and identical across backends. Magnitudes are
    clamped (|k| <= 2 in Q28, |c| <= 32, |acc| <= 64) so no product can
    overflow int64; clamped (unstable) recursions produce valid-but-poor
    coefficients that lose the candidate search or trip ``ok``."""
    r = _lags_q28(lags, xp)
    max_order = max(orders)
    batch = r.shape[:-1]
    one = np.int64(1 << _Q)
    err = xp.full(batch, one)  # r_0 normalized to exactly 1.0
    k_clip = np.int64(2 << _Q)
    c_clip = np.int64(32 << _Q)
    a_clip = np.int64(64 << _Q)
    # coefficients as ONE [..., max_order] tensor: the j-loops over
    # per-coefficient arrays emitted O(max_order^2) tiny device ops whose
    # per-op launch and sequencing cost dominated the
    # recursion's actual arithmetic; the batched forms below are the same
    # exact integer ops (per-term >> _Q floors kept inside the reduce;
    # i64 sums can't overflow: |(c*r) >> Q| <= 2^33, <= 31 terms) fused
    # into a handful of ops per order.
    C = xp.zeros(batch + (max_order,), xp.int64)
    out = []
    for i in range(max_order):
        acc = r[..., i + 1]
        if i:
            rr = xp.flip(r[..., 1 : i + 1], axis=-1)  # r[i-j], j = 0..i-1
            acc = acc - ((C[..., :i] * rr) >> np.int64(_Q)).sum(axis=-1)
        acc = xp.clip(acc, -a_clip, a_clip)
        k = xp.clip((acc << np.int64(_Q)) // xp.maximum(err, 1), -k_clip,
                    k_clip)
        if i:
            upd = xp.clip(
                C[..., :i]
                - ((k[..., None] * xp.flip(C[..., :i], axis=-1))
                   >> np.int64(_Q)),
                -c_clip, c_clip,
            )
            C = xp.concatenate([upd, k[..., None], C[..., i + 1 :]], axis=-1)
        else:
            C = xp.concatenate([k[..., None], C[..., 1:]], axis=-1)
        err = (err * xp.maximum(one - ((k * k) >> np.int64(_Q)), 1)) >> (
            np.int64(_Q)
        )
        if (i + 1) in orders:
            cmax = xp.abs(C[..., : i + 1]).max(axis=-1)
            # cmax == 0 (all-zero coefficients: silence) and runaway
            # magnitudes (unstable recursion) disqualify the candidate
            ok = (cmax > 0) & (cmax < (np.int64(1) << np.int64(48)))
            out.append((i + 1, C, cmax, ok, err))
    return out


def _log2_q8(e, xp):
    """Deterministic integer log2 with 8 fractional bits (linear mantissa
    interpolation) for POSITIVE int64 inputs <= 2^40: monotone and
    identical in numpy and XLA — accuracy only shapes the candidate-order
    trade-off, determinism is what correctness needs."""
    bl = _bitlen_nonneg(e, xp)
    top = xp.maximum(bl - 1, 0)
    mant = (e << np.int64(8)) >> top  # in [256, 512)
    return (top << np.int64(8)) + mant - np.int64(256)


def select_lpc_candidate(pre, block_size: int, precision: int, xp):
    """Pick ONE candidate order per plane from the Levinson outputs by
    estimated cost — the reference's own philosophy for fixed orders
    (libFLAC/fixed.zig:88-168 picks by error sums, THEN runs one Rice
    estimate): est_bits(o) ~ B * log2(err_o)/2 + coefficient overhead
    (9 + o*precision). One Rice sweep then runs for the selected
    candidate instead of one per candidate (the LPC mode's dominant cost
    once coefficients moved in-program), and only the SELECTED
    candidate's coefficients are quantized (_quantize_selected) — the
    per-candidate quantization loops were sum(orders) sequenced tiny ops.
    Integer Q8 log2 keeps the rule bit-identical across backends;
    first-min tie-break over ascending orders. Returns (order i32 [...],
    qc i32 [..., 32], shift i32, ok) — ``ok`` is False when NO candidate
    is usable."""
    score = None
    order = coeffs = cmax = ok = None
    max_order = max(o for o, *_ in pre)
    for o, c_C, c_cmax, c_ok, c_err in pre:
        s = (block_size * _log2_q8(xp.maximum(c_err, 1), xp)) >> np.int64(1)
        s = s + np.int64((9 + o * precision) << 8)
        # unusable candidates never win: larger than any real score
        s = xp.where(c_ok, s, np.int64(1) << np.int64(62))
        if score is None:
            score, order = s, xp.full(s.shape, o, xp.int32)
            coeffs, cmax, ok = c_C, c_cmax, c_ok
        else:
            better = s < score  # strict <: first-min keeps the lower order
            score = xp.where(better, s, score)
            order = xp.where(better, o, order).astype(xp.int32)
            coeffs = xp.where(better[..., None], c_C, coeffs)
            cmax = xp.where(better, c_cmax, cmax)
            ok = ok | c_ok
    qc, shift = _quantize_selected(coeffs, cmax, order, max_order,
                                   precision, xp)
    pad = [(0, 0)] * (qc.ndim - 1) + [(0, 32 - max_order)]
    return order, xp.pad(qc, pad), shift, ok


def lpc_residuals(planes, qcoeffs, shift, order, max_order: int, xp,
                  sample_size=None):
    """r[i] = s[i] - (sum_j q_j * s[i-1-j] >> shift) for i >= order, first
    ``order`` slots zeroed. ``order`` is a PER-PLANE array (the selected
    candidate); the tap loop runs ``max_order`` static iterations and the
    zero-padded qcoeffs beyond each plane's real order contribute nothing.
    One implementation for both backends (exact integers either way).
    Returns (residuals i32 [..., B], fits_i32 bool).

    ``sample_size`` (the audio depth; side planes carry one extra bit,
    d = sample_size + 1) enables a STATIC overflow proof that skips the
    dynamic fits check — a [planes, B] and-reduce over every residual.
    Proof with
    |s| <= 2^d, order <= 32 and the _quantize_fixed geometry (shift =
    clip(precision + 27 - bitlen(cmax), 0, 15), Levinson clamp |c| <= 32
    in Q28 so bitlen(cmax) <= 34, clip |q_j| <= 2^(precision-1)):
    whichever clip branch applies, |q_j| / 2^shift <= 2^(bitlen - 28) <=
    2^6, hence |pred >> shift| <= 32 * 2^6 * 2^d = 2^(d+11); the residual
    is bounded by 2^d + 2^(d+11) + slack < 2^31 whenever d <= 19 — every
    depth <= 18 audio can never trip the check, on either backend (the
    same gate in numpy keeps golden == device by construction)."""
    B = planes.shape[-1]
    # taps stream the signal at its NATIVE width (i32 except 33-bit depth-32
    # side planes) and widen inside the fused multiply-accumulate — an i64
    # signal copy would double the HBM traffic of all max_order+1 passes
    # (same narrow-storage rule as the lag sums; the accumulator itself
    # must be i64: |q*s| <= 2^(14+33)).
    narrow = sample_size is not None and sample_size <= 18
    if narrow:
        # Split each tap product into two i32 partial sums instead of one
        # i64 multiply-accumulate (an i64 product costs several 32-bit
        # multiplies + carries on 32-bit lanes). With |q| <= 2^14
        # (precision <= 15) and
        # |s| <= 2^d, d <= 19: |sum q*(s>>8)| <= 32 * 2^14 * 2^11 = 2^30
        # and |sum q*(s&0xFF)| <= 32 * 2^14 * 2^8 = 2^27 — both fit i32 —
        # and s == (s>>8)*256 + (s&0xFF) exactly (arithmetic shift +
        # unsigned low byte), so pred == (S_hi << 8) + S_lo exactly.
        s_hi = xp.zeros(planes.shape, dtype=xp.int32)
        s_lo = xp.zeros(planes.shape, dtype=xp.int32)
    else:
        pred = xp.zeros(planes.shape, dtype=xp.int64)
    for j in range(max_order):
        if xp is np:
            sh = np.zeros_like(planes)
            sh[..., j + 1 :] = planes[..., : B - j - 1]
        else:
            sh = xp.pad(planes, [(0, 0)] * (planes.ndim - 1) + [(j + 1, 0)])[
                ..., :B
            ]
        if narrow:
            q32 = qcoeffs[..., j : j + 1]
            sh32 = sh.astype(xp.int32)
            s_hi = s_hi + q32 * (sh32 >> 8)
            s_lo = s_lo + q32 * (sh32 & 0xFF)
        else:
            pred = pred + qcoeffs[..., j : j + 1].astype(xp.int64) * sh.astype(
                xp.int64
            )
    if xp is np:
        idx = np.arange(B, dtype=np.int32)
        idx = np.broadcast_to(idx, planes.shape)
    else:
        idx = jax.lax.broadcasted_iota(xp.int32, planes.shape, planes.ndim - 1)
    if narrow:
        # finish in PURE i32 — keeps the (<<8)+lo >> shift - sub chain
        # out of 64-bit lanes. Exact split of the shift:
        # pred = ((hi << 8) + lo) >> s with s in [0, 15]; for s_l =
        # min(s, 8), hi*2^8 is divisible by 2^s_l, so the first >> s_l
        # distributes term-wise (hi*2^8/2^s_l exact + floor(lo/2^s_l)) and
        # the remaining >> (s - s_l) composes (floor of floor). Magnitudes
        # (docstring proof, d <= 19): |final pred| <= 2^30, |lo >> s_l| <=
        # 2^27, so every term and intermediate fits i32 (|hi << (8-s_l)|
        # <= |pred| + |lo >> s_l| by the triangle inequality when s_l = s,
        # and |hi + (lo >> 8)| <= 2^30 + 2^19 when s_l = 8).
        s32 = shift[..., None].astype(xp.int32)
        s_l = xp.minimum(s32, 8)
        t = (s_hi << (8 - s_l)) + (s_lo >> s_l)
        pred32 = t >> (s32 - s_l)
        res = planes.astype(xp.int32) - pred32
        res = xp.where(idx < xp.asarray(order)[..., None], 0, res)
        # statically proven in range (see docstring): no dynamic check
        fits = xp.ones(planes.shape[:-1], dtype=bool)
        return res, fits
    pred = pred >> shift[..., None].astype(xp.int64)
    res = planes.astype(xp.int64) - pred
    res = xp.where(idx < xp.asarray(order)[..., None], 0, res)
    if sample_size is not None and sample_size <= 18:  # d = depth+1 <= 19
        # statically proven in range (see docstring): no dynamic check
        fits = xp.ones(planes.shape[:-1], dtype=bool)
    else:
        i32max = np.int64((1 << 31) - 1)
        fits = ((res <= i32max) & (res >= -i32max - 1)).all(axis=-1)
    return res.astype(xp.int32), fits


def lpc_candidate_orders(lpc_order: int):
    """Static candidate orders for the order search: powers of two up to the
    configured max, plus the max itself — the Levinson recursion produces
    every lower order for free, so extra candidates only pay their
    quantization + residual + Rice-estimate cost."""
    cands = {lpc_order}
    o = 1
    while o < lpc_order:
        cands.add(o)
        o *= 2
    return tuple(sorted(cands))


def analyze_lpc_np(
    planes: np.ndarray, lpc_order: int, precision: int, sample_size=None
):
    """Full host LPC analysis (golden path): numpy lag sums, the SAME
    integer Q28 Levinson + err-based candidate selection the device
    program runs (bit-identical by construction), and numpy residuals for
    the ONE selected order. Returns (order i32 [...], residuals i32
    [..., B], qcoeffs i32 [..., 32], shift, ok)."""
    B = planes.shape[-1]
    orders = lpc_candidate_orders(lpc_order)
    lags = lag_sums_np(planes, lpc_order, sample_size)
    pre = fixed_point_levinson(lags, orders, precision, np)
    order, qc, shift, ok = select_lpc_candidate(pre, B, precision, np)
    res, fits = lpc_residuals(planes, qc, shift, order, lpc_order, np,
                              sample_size=sample_size)
    return order, res, qc, shift, ok & fits
