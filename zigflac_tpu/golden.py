"""Host golden FLAC encoder — the bit-exactness oracle.

A direct, scalar/numpy re-statement of the reference encoder's *semantics*
(not its code): every tie-break, wrapping-arithmetic detail, and quirk is
reproduced so the device pipeline (ops/, models/encoder.py) can be tested
byte-for-byte against it:

* fixed-order search by min sum-of-abs-residuals, first-min argmin, wide-mode
  overflow disqualification            (libFLAC/fixed.zig:88-168)
* flake-style Rice cost estimate with u64 wrapping, smallest-param ties,
  ``<=`` partition-order preference, all-zero-partition escape, escape param
  selectable from the sweep            (libFLAC/rice.zig:237-375)
* strict ``<`` Fixed-vs-Verbatim with header-less size accounting
                                       (libFLAC/Encoder.zig:320-376)
* first-min stereo-mode argmin over {L+R, L+S, S+R, M+S}
                                       (libFLAC/Encoder.zig:306-313)
* frame-header code tables incl. the dead 144*2^n branch and the
  uncommon-sample-rate block_size bug  (libFLAC/FrameWriter.zig:136-247)
* escape partitions incl. the >=32-bit fallback to param 30
                                       (libFLAC/FrameWriter.zig:313-339)

This path is *slow by design* (it exists for tests and as the packer
fallback); the production path is the batched device pipeline.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .crc import crc8, crc16
from .utils.bits import BitWriter
from .utils.config import (
    EncoderConfig,
    MAX_FIXED_ORDER,
    MAX_RICE_PARAM_4BIT,
)
from .metadata import StreamInfo

U64 = (1 << 64) - 1

# Channel-assignment codes (libFLAC/Encoder.zig:483-488, FrameWriter.zig:365-377)
CH_INDEP = 0
CH_LEFT_SIDE = 1
CH_SIDE_RIGHT = 2
CH_MID_SIDE = 3


# ---------------------------------------------------------------------------
# Fixed prediction (libFLAC/fixed.zig)
# ---------------------------------------------------------------------------


def fixed_error_cascade(samples: np.ndarray) -> List[np.ndarray]:
    """err_k = k-th order difference of samples, defined for i >= k (int64).

    Returns [e0, e1, e2, e3, e4] where e_k has length len(samples) - k.
    """
    e = samples.astype(np.int64)
    out = [e]
    for _ in range(MAX_FIXED_ORDER):
        e = np.diff(e)
        out.append(e)
    return out


def fixed_best_order(samples: np.ndarray, wide: bool) -> Optional[int]:
    """argmin_k sum|err_k|, first-min wins; wide mode disqualifies any order
    whose residuals exceed i32 range and returns None if the winner is
    disqualified (libFLAC/fixed.zig:88-168)."""
    assert len(samples) > MAX_FIXED_ORDER
    cascade = fixed_error_cascade(samples)
    totals = []
    i32_max = (1 << 31) - 1
    for k, e in enumerate(cascade):
        absvals = np.abs(e).astype(np.uint64)
        total = int(absvals.sum(dtype=np.uint64))
        if wide and int(np.bitwise_or.reduce(absvals)) > i32_max:
            total = U64
        totals.append(total)
    best = int(np.argmin(np.array(totals, dtype=np.uint64)))  # first-min
    if not wide or totals[best] != U64:
        return best
    return None


def fixed_residuals(samples: np.ndarray, order: int) -> np.ndarray:
    """Residuals of the given order as int32; the first ``order`` slots are 0
    (the reference leaves garbage there and excludes them downstream)."""
    res = np.zeros(len(samples), dtype=np.int32)
    e = samples.astype(np.int64)
    for _ in range(order):
        e = np.diff(e)
    res[order:] = e.astype(np.int32)  # wide mode guarantees i32 range
    return res


# ---------------------------------------------------------------------------
# Rice parameter estimation (libFLAC/rice.zig)
# ---------------------------------------------------------------------------


def zigzag(res: np.ndarray) -> np.ndarray:
    """u32 zigzag with i32 wrapping shift (libFLAC/rice.zig:268-271)."""
    r = res.astype(np.int32)
    with np.errstate(over="ignore"):
        return ((r.astype(np.uint32) << np.uint32(1)) ^ (r >> np.int32(31)).astype(np.uint32))


@dataclass
class RiceConfig:
    method: int  # 0 = FOUR (4-bit params), 1 = FIVE (5-bit params)
    part_order: int
    params: List[int]

    @property
    def escape_code(self) -> int:
        return 0b1111 if self.method == 0 else 0b11111


def find_optimal_param(part_sum: int, part_size: int, max_param: int) -> Tuple[int, int]:
    """(param, bit_count) for one partition — exact u64 wrap semantics of
    libFLAC/rice.zig:344-375. The sweep covers params 0..max_param+1; the
    escape param (max_param+1) is selectable and costs part_size*param."""
    if part_sum == 0:
        return max_param + 1, 5
    lhs = (part_sum - part_size // 2) & U64
    best_bc = None
    best_k = 0
    for k in range(max_param + 2):
        bc = (part_size * (k + 1) + (lhs >> k)) & U64
        if best_bc is None or bc < best_bc:
            best_bc, best_k = bc, k
    if best_k == max_param + 1:
        return best_k, part_size * best_k
    return best_k, best_bc


def calc_sums(zz: np.ndarray, max_part_order: int, pred_order: int) -> List[np.ndarray]:
    """Partition zigzag-sum pyramid (libFLAC/rice.zig:276-308): sums at the
    max order (partition 0 minus the warmup zigzags), then pairwise halving."""
    n = len(zz)
    part_count = 1 << max_part_order
    part_size = n >> max_part_order
    z = zz.astype(np.uint64)
    top = z[: part_count * part_size].reshape(part_count, part_size).sum(axis=1, dtype=np.uint64)
    top[0] -= z[:pred_order].sum(dtype=np.uint64)
    sums = [None] * (max_part_order + 1)
    sums[max_part_order] = top
    for o in range(max_part_order - 1, -1, -1):
        prev = sums[o + 1]
        sums[o] = prev[0::2] + prev[1::2]
    return sums


def calc_optimal_params(
    part_order: int,
    blk_size: int,
    max_param: int,
    pred_order: int,
    sums: np.ndarray,
) -> Tuple[int, RiceConfig]:
    """(total_bits, RiceConfig) for one partition order
    (libFLAC/rice.zig:312-342). First partition is pred_order smaller."""
    part_count = 1 << part_order
    all_bits = 0
    params: List[int] = []
    part_size = (blk_size >> part_order) - pred_order
    for i in range(part_count):
        p, bc = find_optimal_param(int(sums[i]), part_size, max_param)
        params.append(p)
        all_bits += bc
        part_size = blk_size >> part_order
    method = 0
    if max_param > MAX_RICE_PARAM_4BIT and any(p > MAX_RICE_PARAM_4BIT for p in params):
        method = 1
    total = all_bits + (method + 4) * part_count
    return total, RiceConfig(method=method, part_order=part_order, params=params)


def rice_calc_params(
    residuals: np.ndarray,
    max_part_order: int,
    max_param: int,
    bit_depth: int,
    pred_order: int,
) -> Tuple[int, RiceConfig]:
    """Entry point matching libFLAC/rice.zig:68-86 + calcParamEstimate:
    clamps the partition order by ctz(len) and the predictor order, the param
    by bit depth, then sweeps partition orders keeping ties at larger order."""
    n = len(residuals)
    assert n > pred_order
    if pred_order != 0:
        pred_order_limited = _ilog2(n) - _ilog2(pred_order)
    else:
        pred_order_limited = 15
    maximum_part_order = min(max_part_order, _ctz(n), pred_order_limited)
    maximum_param = min(
        30 if bit_depth > 16 else MAX_RICE_PARAM_4BIT, max_param
    )
    zz = zigzag(residuals)
    sums = calc_sums(zz, maximum_part_order, pred_order)
    best_bits = U64
    best_cfg: Optional[RiceConfig] = None
    for po in range(maximum_part_order + 1):
        bits, cfg = calc_optimal_params(po, n, maximum_param, pred_order, sums[po])
        if bits <= best_bits:  # ties -> larger partition order
            best_bits, best_cfg = bits, cfg
    assert best_cfg is not None
    return best_bits, best_cfg


def _ilog2(v: int) -> int:
    return v.bit_length() - 1


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


# ---------------------------------------------------------------------------
# Subframe selection (libFLAC/Encoder.zig:320-376)
# ---------------------------------------------------------------------------


@dataclass
class SubframeChoice:
    kind: str  # "constant" | "verbatim" | "fixed" | "lpc"
    est_bits: int
    order: int = 0
    rice: Optional[RiceConfig] = None
    residuals: Optional[np.ndarray] = None
    qcoeffs: Optional[np.ndarray] = None
    qshift: int = 0
    precision: int = 0


def choose_subframe(
    plane: np.ndarray,
    bits_of_t: int,  # @bitSizeOf(SampleT): 32 or 64
    sample_size: int,  # streaminfo bit depth (NOT +1 for side planes)
    config: EncoderConfig,
) -> SubframeChoice:
    n = len(plane)
    if n == 0:
        raise ValueError("empty subframe")
    if bool(np.all(plane[1:] == plane[0])):
        return SubframeChoice("constant", bits_of_t)

    verbatim_bits = n * bits_of_t
    choice = SubframeChoice("verbatim", verbatim_bits)
    lpc_order = config.lpc_order if config.prediction == "lpc" else 0
    if n <= max(MAX_FIXED_ORDER, lpc_order) or config.prediction == "none":
        return choice

    wide = not (sample_size < 28 and bits_of_t == 32)
    order = fixed_best_order(plane, wide)
    if order is None:
        fixed_bits, rice_cfg, residuals = U64, None, None
    else:
        residuals = fixed_residuals(plane, order)
        fixed_bits, rice_cfg = rice_calc_params(
            residuals, config.max_rice_order, config.max_rice_param,
            sample_size, order,
        )

    best = SubframeChoice("fixed", fixed_bits, order or 0, rice_cfg, residuals)

    if config.prediction == "lpc":
        # Extension (the reference stubs LPC): the whole coefficient
        # derivation is pure integer math (exact lag sums + the Q28
        # fixed-point Levinson + err-based candidate-order selection,
        # ops/lpc.py) — numpy here, the SAME integer ops inside the
        # device program — so both backends decide identically on any
        # platform: one selected candidate, first-strictly-smaller cost
        # vs the fixed predictor.
        from .ops.lpc import analyze_lpc_np

        l_ord, l_res, l_q, l_shift, l_ok = analyze_lpc_np(
            plane[None], lpc_order, config.lpc_precision, sample_size
        )
        if bool(np.asarray(l_ok)[0]):
            o = int(np.asarray(l_ord)[0])
            l_res = np.asarray(l_res)[0]
            l_bits, l_cfg = rice_calc_params(
                l_res, config.max_rice_order, config.max_rice_param,
                sample_size, o,
            )
            l_cost = l_bits + 9 + o * config.lpc_precision
            if l_cost < best.est_bits:
                best = SubframeChoice(
                    "lpc", l_cost, o, l_cfg, l_res,
                    qcoeffs=np.asarray(l_q)[0],
                    qshift=int(np.asarray(l_shift)[0]),
                    precision=config.lpc_precision,
                )

    if best.rice is not None and best.est_bits < verbatim_bits:  # strict <
        return best
    return choice


def mid_side(left: np.ndarray, right: np.ndarray, depth: int) -> Tuple[np.ndarray, np.ndarray]:
    """mid = (l+r)>>1 (floor), side = l-r; side is int64 iff depth == 32
    (libFLAC/samples.zig:45-51, Encoder.zig:252-270)."""
    l64 = left.astype(np.int64)
    r64 = right.astype(np.int64)
    mid = ((l64 + r64) >> 1).astype(np.int32)
    side = l64 - r64
    if depth != 32:
        side = side.astype(np.int32)
    return mid, side


@dataclass
class FramePlan:
    ch_type: int  # CH_* code
    # For Indep: one entry per channel. For stereo modes: the two written
    # logical channels in wire order, each
    # (plane, choice, sample_size, wasted_bits).
    subframes: List[Tuple[np.ndarray, SubframeChoice, int, int]]


def wasted_bits_of(plane: np.ndarray, sample_size: int, config: EncoderConfig):
    """(k, shifted_plane) — common trailing zero bits (extension; the
    reference has no wasted-bits support). k = 0 unless enabled."""
    if not config.wasted_bits:
        return 0, plane
    ored = int(np.bitwise_or.reduce(plane.astype(np.int64)))
    if ored == 0:
        return 0, plane
    k = min((ored & -ored).bit_length() - 1, sample_size - 1)
    return k, plane >> k


def plan_frame(
    samples: Sequence[np.ndarray],
    depth: int,
    config: EncoderConfig,
) -> FramePlan:
    """processChannels (libFLAC/Encoder.zig:233-317)."""
    if not config.stereo_auto:
        subs = []
        for ch in samples:
            k, shifted = wasted_bits_of(ch, depth, config)
            subs.append(
                (shifted, choose_subframe(shifted, 32, depth, config),
                 depth - k, k)
            )
        return FramePlan(CH_INDEP, subs)

    left, right = samples[0], samples[1]
    mid, side = mid_side(left, right, depth)
    side_bits_of_t = 64 if depth == 32 else 32

    k_l, left = wasted_bits_of(left, depth, config)
    k_r, right = wasted_bits_of(right, depth, config)
    k_m, mid = wasted_bits_of(mid, depth, config)
    k_s, side = wasted_bits_of(side, depth, config)

    c_left = choose_subframe(left, 32, depth, config)
    c_right = choose_subframe(right, 32, depth, config)
    c_mid = choose_subframe(mid, 32, depth, config)
    c_side = choose_subframe(side, side_bits_of_t, depth, config)

    sums = [
        c_left.est_bits + c_right.est_bits,   # Indep (L+R)
        c_left.est_bits + c_side.est_bits,    # LeftSide
        c_side.est_bits + c_right.est_bits,   # SideRight
        c_mid.est_bits + c_side.est_bits,     # MidSide
    ]
    ch_type = int(np.argmin(np.array(sums, dtype=np.uint64)))  # first-min

    if ch_type == CH_INDEP:
        subs = [(left, c_left, depth - k_l, k_l),
                (right, c_right, depth - k_r, k_r)]
    elif ch_type == CH_LEFT_SIDE:
        subs = [(left, c_left, depth - k_l, k_l),
                (side, c_side, depth + 1 - k_s, k_s)]
    elif ch_type == CH_SIDE_RIGHT:
        subs = [(side, c_side, depth + 1 - k_s, k_s),
                (right, c_right, depth - k_r, k_r)]
    else:
        subs = [(mid, c_mid, depth - k_m, k_m),
                (side, c_side, depth + 1 - k_s, k_s)]
    return FramePlan(ch_type, subs)


# ---------------------------------------------------------------------------
# Frame writing (libFLAC/FrameWriter.zig)
# ---------------------------------------------------------------------------


def write_frame_header(
    w: BitWriter,
    is_fixed_size: bool,
    block_size: int,
    sample_rate: int,
    channels_code: int,
    bit_depth: int,
    frame_number: int,
) -> None:
    w.write(16, 0xFFF8 if is_fixed_size else 0xFFF9)

    # block size code (incl. the dead 144*2^n branch: block_size>>ctz is the
    # odd part, never 144 — kept for fidelity, FrameWriter.zig:158-162)
    uncommon_block_size = 0  # 0 none, 8 byte, 16 half
    ctz = _ctz(block_size)
    if block_size == (1 << ctz) and 8 <= ctz <= 15:
        w.write(4, ctz)
    elif block_size == 192:
        w.write(4, 1)
    elif (block_size >> ctz) == 144 and 2 <= ctz <= 5:
        w.write(4, ctz)
    elif block_size < 0x100:
        w.write(4, 0b0110)
        uncommon_block_size = 8
    else:
        w.write(4, 0b0111)
        uncommon_block_size = 16

    # sample rate code
    rate_codes = {
        0: 0, 88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
        24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
    }
    uncommon_sample_rate = 0  # 0 none, 4 byte, 1 half, 10 half_tenth
    if sample_rate in rate_codes:
        w.write(4, rate_codes[sample_rate])
    elif sample_rate <= 255:
        uncommon_sample_rate = 4
        w.write(4, 12)
    elif sample_rate <= 65535:
        uncommon_sample_rate = 1
        w.write(4, 13)
    else:
        uncommon_sample_rate = 10
        w.write(4, 14)

    w.write(4, channels_code)
    # 12/20-bit are extensions: the reference hits `unreachable` there
    # (FrameWriter.zig:207-209); codes per the FLAC spec. Any other
    # 4-32-bit depth uses code 0b000 = depth-from-STREAMINFO (spec §9.1.3)
    # — mirrors ops/header.header_static.
    if not 0 <= bit_depth <= 32 or bit_depth in (1, 2, 3):
        raise ValueError(f"bit depth {bit_depth} cannot be frame-encoded")
    depth_codes = {0: 0, 8: 2, 12: 4, 16: 8, 20: 10, 24: 12, 32: 14}
    w.write(4, depth_codes.get(bit_depth, 0))

    # frame number, UTF-8-style (FrameWriter.zig:216-232)
    if frame_number <= 0x7F:
        w.write(8, frame_number)
    else:
        assert frame_number <= 0x000F_FFFF_FFFF
        buffer = 0
        i = 0
        first_byte_max = 0b111111
        number = frame_number
        while number > first_byte_max:
            buffer |= (0b1000_0000 + (number & 0b111111)) << (8 * i)
            i += 1
            number >>= 6
            first_byte_max >>= 1
        buffer |= ((0b11111110 << (6 - i)) | number) << (8 * i)
        w.write_signed(8 * (i + 1), buffer)

    # uncommon block size tail
    if uncommon_block_size:
        w.write(uncommon_block_size, block_size - 1)
    # uncommon sample rate tail: the reference writes *block_size* here (bug
    # preserved: FrameWriter.zig:240-244); values are masked to field width.
    if uncommon_sample_rate == 4:
        w.write(8, block_size & 0xFF)
    elif uncommon_sample_rate:
        w.write(16, (block_size // uncommon_sample_rate) & 0xFFFF)

    # CRC-8 over the header bytes written so far
    w.write(8, crc8(w.bytes_so_far()))


def _write_wasted(w: BitWriter, k: int) -> None:
    if k > 0:
        w.write_zeros(k - 1)
        w.write(1, 1)


def write_constant_subframe(
    w: BitWriter, sample_size: int, sample: int, wasted: int = 0
) -> None:
    w.write(8, 0 | (1 if wasted else 0))
    _write_wasted(w, wasted)
    w.write_signed(sample_size, int(sample))


def write_verbatim_subframe(
    w: BitWriter, sample_size: int, plane: np.ndarray, wasted: int = 0
) -> None:
    w.write(8, (1 << 1) | (1 if wasted else 0))
    _write_wasted(w, wasted)
    mask = (1 << sample_size) - 1
    for s in plane.tolist():
        w.write(sample_size, s & mask)


def write_fixed_subframe(
    w: BitWriter,
    sample_size: int,
    plane: np.ndarray,
    residuals: np.ndarray,
    order: int,
    rice_cfg: RiceConfig,
    wasted: int = 0,
) -> None:
    w.write(8, ((8 | order) << 1) | (1 if wasted else 0))
    _write_wasted(w, wasted)
    mask = (1 << sample_size) - 1
    for i in range(order):
        w.write(sample_size, int(plane[i]) & mask)
    _write_rice_partitions(w, residuals, order, rice_cfg)


def write_lpc_subframe(
    w: BitWriter,
    sample_size: int,
    plane: np.ndarray,
    choice: SubframeChoice,
    wasted: int = 0,
) -> None:
    """LPC subframe per the FLAC spec (extension; reference stubs this)."""
    order = choice.order
    w.write(8, ((0x20 | (order - 1)) << 1) | (1 if wasted else 0))
    _write_wasted(w, wasted)
    mask = (1 << sample_size) - 1
    for i in range(order):
        w.write(sample_size, int(plane[i]) & mask)
    w.write(4, choice.precision - 1)
    w.write(5, choice.qshift)
    cmask = (1 << choice.precision) - 1
    for q in choice.qcoeffs[:order].tolist():
        w.write(choice.precision, q & cmask)
    _write_rice_partitions(w, choice.residuals, order, choice.rice)


def _write_rice_partitions(
    w: BitWriter,
    residuals: np.ndarray,
    order: int,
    rice_cfg: RiceConfig,
) -> None:
    param_len = rice_cfg.method + 4
    part_count = 1 << rice_cfg.part_order
    escape_code = rice_cfg.escape_code

    w.write(6, (rice_cfg.method << 4) | rice_cfg.part_order)

    n = len(residuals)
    pos = order
    part_size = (n >> rice_cfg.part_order) - order
    for param in rice_cfg.params[:part_count]:
        part = residuals[pos : pos + part_size]
        pos += part_size
        this_part_size = part_size
        part_size = n >> rice_cfg.part_order

        part_param = param
        if param == escape_code:
            p32 = part.astype(np.int32)
            if len(p32):
                res_max = int(np.bitwise_or.reduce(p32 ^ (p32 >> np.int32(31))))
                or_all = int(np.bitwise_or.reduce(p32))
            else:
                res_max = 0
                or_all = 0
            if or_all == 0:
                bps = 0
            elif res_max == 0:
                bps = 1
            else:
                bps = res_max.bit_length() + 1
            if bps >= 32:
                # FLAC can't hold 32-bit escaped samples; fall back to
                # param 30 Rice coding (FrameWriter.zig:325-327).
                part_param = 30
            else:
                w.write(param_len, part_param)
                w.write(5, bps)
                if bps == 0:
                    continue
                bmask = (1 << bps) - 1
                for r in p32.tolist():
                    w.write(bps, r & bmask)
                continue
        # normal Rice partition
        zz = zigzag(part)
        w.write(param_len, part_param)
        k = part_param
        kmask = (1 << k) - 1
        hi = 1 << k
        for z in zz.tolist():
            w.write_zeros(z >> k)
            w.write(k + 1, hi | (z & kmask))
        _ = this_part_size


def encode_frame(
    samples: Sequence[np.ndarray],
    frame_number: int,
    info: StreamInfo,
    config: EncoderConfig,
) -> bytes:
    """One complete FLAC frame (libFLAC/Encoder.zig:153-213)."""
    plan = plan_frame(samples, info.bit_depth, config)
    block_size = len(samples[0])
    if plan.ch_type == CH_INDEP:
        channels_code = info.channels - 1
    else:
        channels_code = plan.ch_type + 7

    w = BitWriter()
    write_frame_header(
        w, True, block_size, info.sample_rate, channels_code, info.bit_depth,
        frame_number,
    )
    for plane, choice, sample_size, wasted in plan.subframes:
        if choice.kind == "constant":
            write_constant_subframe(w, sample_size, int(plane[0]), wasted)
        elif choice.kind == "verbatim":
            write_verbatim_subframe(w, sample_size, plane, wasted)
        elif choice.kind == "lpc":
            write_lpc_subframe(w, sample_size, plane, choice, wasted)
        else:
            write_fixed_subframe(
                w, sample_size, plane, choice.residuals, choice.order,
                choice.rice, wasted,
            )
    w.align_to_byte()
    body = w.getvalue()
    return body + crc16(body).to_bytes(2, "big")
