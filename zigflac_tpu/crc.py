"""CRC primitives for FLAC framing.

* CRC-8/SMBUS  (poly 0x07,   init 0, non-reflected, xorout 0) — frame-header
  checksum (reference: libFLAC/FrameWriter.zig:117-126).
* CRC-16/UMTS  (poly 0x18005, init 0, non-reflected, xorout 0) — whole-frame
  checksum (reference: libFLAC/Crc16.zig).

The reference accelerates CRC-16 with PCLMULQDQ folding; on the device we use
the GF(2) linearity of CRC: the CRC of a message is the XOR of per-byte
contributions ``byte(x) * x^(8*dist_from_end + 16) mod G(x)``, which
vectorizes over every byte of every frame at once (see ops/crc16.py). This
module holds the host/table implementations and the precomputed GF(2) shift
tables that the device kernel gathers from.
"""

from __future__ import annotations

import numpy as np

CRC8_POLY = 0x07
CRC16_POLY = 0x18005  # x^16 + x^15 + x^2 + 1 (CRC-16/UMTS aka BUYPASS/ARC-nonreflected)


def _make_crc8_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint8)
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = ((crc << 1) ^ CRC8_POLY) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
        table[b] = crc
    return table


def _make_crc16_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint16)
    for b in range(256):
        crc = b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ (CRC16_POLY & 0xFFFF)) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
        table[b] = crc
    return table


CRC8_TABLE = _make_crc8_table()
CRC16_TABLE = _make_crc16_table()


def crc8(data: bytes | bytearray | memoryview | np.ndarray, crc: int = 0) -> int:
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    t = CRC8_TABLE
    for b in arr.tolist():
        crc = int(t[crc ^ b])
    return crc


def crc16(data: bytes | bytearray | memoryview | np.ndarray, crc: int = 0) -> int:
    arr = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    t = CRC16_TABLE
    for b in arr.tolist():
        crc = int(t[(crc >> 8) ^ b]) ^ ((crc << 8) & 0xFFFF)
    return crc


# ---------------------------------------------------------------------------
# GF(2) machinery for the parallel (device) CRC-16.
#
# CRC16(M) = M(x) * x^16 mod G(x)  (init 0, non-reflected, xorout 0).
# For byte b at distance-from-end e (bytes), its contribution is
#   b(x) * x^(8e + 16) mod G(x).
# ---------------------------------------------------------------------------


def gf2_mulmod16(a: int, b: int, poly: int = CRC16_POLY) -> int:
    """Carry-less multiply of two <=16-bit polynomials, reduced mod poly."""
    acc = 0
    while b:
        if b & 1:
            acc ^= a
        b >>= 1
        a <<= 1
        if a & 0x10000:
            a ^= poly
    return acc & 0xFFFF


def xpow_mod(e: int, poly: int = CRC16_POLY) -> int:
    """x^e mod G(x) as a 16-bit polynomial (e >= 0)."""
    # Square-and-multiply over GF(2)[x]/G.
    result = 1
    base = 2  # x
    while e:
        if e & 1:
            result = gf2_mulmod16(result, base, poly)
        base = gf2_mulmod16(base, base, poly)
        e >>= 1
    return result


def xpow_shift_table(max_bytes: int, poly: int = CRC16_POLY) -> np.ndarray:
    """Table t[e] = x^(8e+16) mod G for e in [0, max_bytes): the per-byte
    contribution multiplier at byte distance-from-end ``e``."""
    t = np.zeros(max_bytes, dtype=np.uint16)
    cur = xpow_mod(16, poly)
    step = xpow_mod(8, poly)
    for e in range(max_bytes):
        t[e] = cur
        cur = gf2_mulmod16(cur, step, poly)
    return t


def _xinv_mod(poly: int = CRC16_POLY) -> int:
    """x^-1 mod G. G has a constant term, so x is invertible:
    if G = x*Q + 1 then x*Q = G+1 = 1 (mod G), so x^-1 = Q = (G+1)/x."""
    return (poly ^ 1) >> 1


def xpow_neg8_table(max_bytes: int, poly: int = CRC16_POLY) -> np.ndarray:
    """Table inv[k] = x^(-8k) mod G for k in [0, max_bytes]: used to cancel
    k zero bytes of padding off the end of a fixed-width CRC accumulation."""
    inv1 = _xinv_mod(poly)
    inv8 = 1
    for _ in range(8):
        inv8 = gf2_mulmod16(inv8, inv1, poly)
    t = np.zeros(max_bytes + 1, dtype=np.uint16)
    cur = 1
    for k in range(max_bytes + 1):
        t[k] = cur
        cur = gf2_mulmod16(cur, inv8, poly)
    return t


def reduce24_table(poly: int = CRC16_POLY) -> np.ndarray:
    """Table r[h] = h(x) * x^16 mod G for h in [0, 256): reduces the top 8
    bits of a 24-bit carry-less product back into 16 bits."""
    t = np.zeros(256, dtype=np.uint16)
    for h in range(256):
        t[h] = gf2_mulmod16(h, xpow_mod(16, poly), poly)
    return t


def crc16_combine(crc_a: int, crc_b: int, len_b: int, poly: int = CRC16_POLY) -> int:
    """CRC of concat(A, B) given crc(A), crc(B) and len(B) in bytes."""
    return gf2_mulmod16(crc_a, xpow_mod(8 * len_b, poly), poly) ^ crc_b
