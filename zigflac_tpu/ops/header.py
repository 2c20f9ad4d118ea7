"""Batched frame-header construction on device.

A FLAC frame header is byte-aligned: 2 sync bytes, 1 byte of
(block-size|rate) codes, 1 byte of (channel|depth) codes, a 1-7 byte
UTF-8-style frame number, optional uncommon-size tail bytes, and a CRC-8.
Only the channel code, frame number and CRC-8 vary per frame; everything
else is static per encode run, so the header builds as a small [N, 16] u8
tensor with vectorized selects (reference: libFLAC/FrameWriter.zig:136-247).

The uncommon-sample-rate tail reproduces the reference's bug of writing
``block_size`` instead of the rate (FrameWriter.zig:240-244), masked to the
field width.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..crc import CRC8_TABLE

MAX_HEADER_BYTES = 16

RATE_CODES = {
    88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
    24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11,
}


def _ctz(v: int) -> int:
    return (v & -v).bit_length() - 1


class HeaderStatic(NamedTuple):
    """Per-run static header pieces."""

    byte2: int          # (block_size_code << 4) | rate_code
    depth_code: int
    tail_bytes: List[int]  # uncommon block-size + sample-rate tail bytes


def header_static(block_size: int, sample_rate: int, bit_depth: int) -> HeaderStatic:
    # block size code (FrameWriter.zig:149-169, incl. the dead 144*2^n branch)
    ctz = _ctz(block_size)
    bs_tail: List[int] = []
    if block_size == (1 << ctz) and 8 <= ctz <= 15:
        bs_code = ctz
    elif block_size == 192:
        bs_code = 1
    elif (block_size >> ctz) == 144 and 2 <= ctz <= 5:
        bs_code = ctz
    elif block_size < 0x100:
        bs_code = 0b0110
        bs_tail = [(block_size - 1) & 0xFF]
    else:
        bs_code = 0b0111
        bs_tail = [((block_size - 1) >> 8) & 0xFF, (block_size - 1) & 0xFF]

    sr_tail: List[int] = []
    if sample_rate == 0:
        rate_code = 0
    elif sample_rate in RATE_CODES:
        rate_code = RATE_CODES[sample_rate]
    elif sample_rate <= 255:
        rate_code = 12
        sr_tail = [block_size & 0xFF]  # reference bug preserved
    elif sample_rate <= 65535:
        rate_code = 13
        v = block_size & 0xFFFF
        sr_tail = [(v >> 8) & 0xFF, v & 0xFF]
    else:
        rate_code = 14
        v = (block_size // 10) & 0xFFFF
        sr_tail = [(v >> 8) & 0xFF, v & 0xFF]

    # 12/20-bit are extensions (the reference hits `unreachable`,
    # libFLAC/FrameWriter.zig:202-214); any other 4-32-bit depth encodes
    # via frame depth code 0b000 (depth-from-STREAMINFO, FLAC spec §9.1.3)
    # — the reference merely ACCEPTS those WAVs (src/WavReader.zig:140-143)
    # and then crashes, so this strictly dominates its envelope.
    if not 4 <= bit_depth <= 32:
        raise ValueError(f"bit depth {bit_depth} cannot be frame-encoded")
    depth_codes = {8: 2, 12: 4, 16: 8, 20: 10, 24: 12, 32: 14}
    return HeaderStatic(
        byte2=(bs_code << 4) | rate_code,
        depth_code=depth_codes.get(bit_depth, 0),
        tail_bytes=bs_tail + sr_tail,
    )


def utf8_frame_number_bytes(fn: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(bytes u8 [N, 7], length i32 [N]) — the reference's UTF-8-style coded
    frame number (FrameWriter.zig:216-232). Byte 0 is the leading byte."""
    fn = fn.astype(jnp.int64)
    # values <= 0x7F short-circuit to one raw byte (FrameWriter.zig:216-217)
    single = fn <= 0x7F
    # else: number of continuation bytes = count of i where the loop
    # condition (fn >> 6i) > (63 >> i) holds (monotone, so a sum works)
    i_cont = jnp.zeros(fn.shape, jnp.int32)
    for i in range(7):
        i_cont = i_cont + ((fn >> (6 * i)) > (63 >> i)).astype(jnp.int32)
    length = jnp.where(single, 1, i_cont + 1)
    lead = jnp.where(
        single,
        fn,
        ((0xFE << (6 - i_cont.astype(jnp.int64))) | (fn >> (6 * i_cont.astype(jnp.int64)))) & 0xFF,
    )
    cols = [lead.astype(jnp.uint8)]
    for j in range(1, 7):
        shift = 6 * (i_cont - j).astype(jnp.int64)
        shift = jnp.maximum(shift, 0)
        cols.append((0x80 | ((fn >> shift) & 0x3F)).astype(jnp.uint8))
    return jnp.stack(cols, axis=-1), length


def build_headers(
    frame_numbers: jnp.ndarray,
    channels_code: jnp.ndarray,
    static: HeaderStatic,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(header_bytes u8 [N, 16], header_len i32 [N]) including the CRC-8."""
    n = frame_numbers.shape[0]
    fn_bytes, fn_len = utf8_frame_number_bytes(frame_numbers)
    n_tail = len(static.tail_bytes)
    tail = jnp.asarray(np.array(static.tail_bytes or [0], np.uint8))

    idx = jax.lax.broadcasted_iota(jnp.int32, (n, MAX_HEADER_BYTES), 1)
    b = jnp.zeros((n, MAX_HEADER_BYTES), jnp.uint8)
    b = jnp.where(idx == 0, jnp.uint8(0xFF), b)
    b = jnp.where(idx == 1, jnp.uint8(0xF8), b)
    b = jnp.where(idx == 2, jnp.uint8(static.byte2), b)
    byte3 = ((channels_code << 4) | static.depth_code).astype(jnp.uint8)
    b = jnp.where(idx == 3, byte3[:, None], b)
    # frame-number region [4, 4+fn_len): instead of per-element table
    # gathers, the 7 possible source columns go through a where-chain
    # (CLAUDE.md small-table rule)
    fn_pos = idx - 4
    in_fn = (fn_pos >= 0) & (fn_pos < fn_len[:, None])
    fn_sel = jnp.zeros((n, MAX_HEADER_BYTES), jnp.uint8)
    for jj in range(7):
        fn_sel = jnp.where(fn_pos == jj, fn_bytes[:, jj : jj + 1], fn_sel)
    b = jnp.where(in_fn, fn_sel, b)
    # tail region [4+fn_len, 4+fn_len+n_tail): <= 3 static byte values
    tail_start = 4 + fn_len
    if n_tail:
        t_pos = idx - tail_start[:, None]
        for tt, tv in enumerate(static.tail_bytes):
            b = jnp.where(t_pos == tt, jnp.uint8(tv), b)
    crc_pos = tail_start + n_tail

    # CRC-8 over bytes [0, crc_pos). The table step T[x] = (x << 8) mod
    # poly is GF(2)-LINEAR, so T[x] == XOR of T[2^k] over x's set bits:
    # eight constant selects per byte replace the 256-entry gather (15
    # serialized [N] gathers measured ~0.3 ms/batch; the select chain
    # fuses into one elementwise kernel).
    crc = jnp.zeros((n,), jnp.uint8)
    for j in range(MAX_HEADER_BYTES - 1):
        v = crc ^ b[:, j]
        nxt = jnp.zeros((n,), jnp.uint8)
        for k in range(8):
            bit = (v >> k) & 1
            nxt = nxt ^ jnp.where(
                bit == 1, jnp.uint8(int(CRC8_TABLE[1 << k])), jnp.uint8(0)
            )
        crc = jnp.where(j < crc_pos, nxt, crc)
    b = jnp.where(idx == crc_pos[:, None], crc[:, None], b)
    return b, (crc_pos + 1).astype(jnp.int32)
