"""Unit oracles for the format primitives (SURVEY.md §4): CRC vectors,
bit I/O, zigzag, STREAMINFO packing, UTF-8 frame numbers, metadata blocks."""

import numpy as np
import pytest

from zigflac_tpu.crc import (
    crc8,
    crc16,
    crc16_combine,
    gf2_mulmod16,
    xpow_mod,
)
from zigflac_tpu.golden import zigzag, write_frame_header
from zigflac_tpu.metadata import StreamInfo, streaminfo_block, vorbis_comment_block
from zigflac_tpu.utils.bits import BitReader, BitWriter


def test_crc8_check_value():
    # CRC-8/SMBUS check value for "123456789"
    assert crc8(b"123456789") == 0xF4


def test_crc16_check_value():
    # CRC-16/UMTS (aka BUYPASS) check value for "123456789"
    assert crc16(b"123456789") == 0xFEE8


def test_crc16_combine():
    a, b = b"hello, ", b"world"
    assert crc16_combine(crc16(a), crc16(b), len(b)) == crc16(a + b)


def test_crc16_linearity():
    # crc(M || 0^k) == crc(M) * x^{8k} mod G
    m = b"\x12\x34\x56"
    for k in range(5):
        assert crc16(m + b"\x00" * k) == gf2_mulmod16(crc16(m), xpow_mod(8 * k))


def test_bitwriter_roundtrip():
    w = BitWriter()
    fields = [(3, 5), (1, 0), (16, 0xBEEF), (7, 100), (13, 4095), (24, 0xABCDEF)]
    for n, v in fields:
        w.write(n, v)
    w.align_to_byte()
    r = BitReader(w.getvalue())
    for n, v in fields:
        assert r.read(n) == v


def test_bitwriter_msb_first():
    w = BitWriter()
    w.write(4, 0xF)
    w.write(4, 0x0)
    w.write(8, 0xAB)
    assert w.getvalue() == bytes([0xF0, 0xAB])


def test_bitwriter_signed():
    w = BitWriter()
    w.write_signed(5, -1)
    w.write_signed(3, -4)
    r = BitReader(w.bytes_so_far())
    assert r.read_signed(5) == -1
    assert r.read_signed(3) == -4


def test_zigzag():
    v = np.array([0, -1, 1, -2, 2, 2**30, -(2**31)], dtype=np.int32)
    zz = zigzag(v)
    assert zz.tolist() == [0, 1, 2, 3, 4, 2**31, 2**32 - 1]


def test_streaminfo_bytes():
    info = StreamInfo(
        sample_rate=44100,
        channels=2,
        bit_depth=16,
        interchannel_samples=123456,
        min_block_size=4096,
        max_block_size=4096,
        md5=bytes(range(16)),
        min_frame_size=100,
        max_frame_size=9000,
    )
    b = info.bytes()
    assert len(b) == 34
    assert b[0:2] == (4096).to_bytes(2, "big")
    assert b[4:7] == (100).to_bytes(3, "big")
    assert b[7:10] == (9000).to_bytes(3, "big")
    packed = int.from_bytes(b[10:18], "big")
    assert packed >> 44 == 44100
    assert ((packed >> 41) & 7) + 1 == 2
    assert ((packed >> 36) & 31) + 1 == 16
    assert packed & ((1 << 36) - 1) == 123456
    assert b[18:] == bytes(range(16))


def test_update_frame_sizes_quirk():
    # `else if`: a strict new max never updates min in the same step
    # (libFLAC/metadata.zig:35-40).
    scalar = StreamInfo(44100, 2, 16, 0, 4096, 4096)
    vec = StreamInfo(44100, 2, 16, 0, 4096, 4096)
    sizes = [10, 20, 5, 20, 30, 2, 40]
    for s in sizes:
        scalar.update_frame_size(s)
    vec.update_frame_sizes(np.array(sizes))
    assert (scalar.min_frame_size, scalar.max_frame_size) == (
        vec.min_frame_size,
        vec.max_frame_size,
    )
    # strictly increasing sizes leave min at the sentinel
    inc = StreamInfo(44100, 2, 16, 0, 4096, 4096)
    inc.update_frame_sizes(np.array([1, 2, 3, 4]))
    assert inc.max_frame_size == 4
    assert inc.min_frame_size == (1 << 24) - 1


def test_vorbis_comment_block_bytes():
    b = vorbis_comment_block(is_last=True)
    assert b[0] == 0x84  # last | VorbisComment(4)
    assert int.from_bytes(b[1:4], "big") == len(b) - 4
    vlen = int.from_bytes(b[4:8], "little")
    assert b[8 : 8 + vlen] == b"toastori FLAC 0.0.0"
    assert int.from_bytes(b[8 + vlen :], "little") == 0


def test_streaminfo_block_bytes():
    info = StreamInfo(48000, 1, 24, 7, 4096, 4096)
    b = streaminfo_block(info, is_last=False)
    assert b[:4] == b"fLaC"
    assert b[4] == 0x00
    assert int.from_bytes(b[5:8], "big") == 34
    assert len(b) == 4 + 4 + 34


@pytest.mark.parametrize(
    "n,expected",
    [
        (0, b"\x00"),
        (0x7F, b"\x7f"),
        (0x80, b"\xc2\x80"),
        (0x7FF, b"\xdf\xbf"),
        (0x800, b"\xe0\xa0\x80"),
        (0xFFFF, b"\xef\xbf\xbf"),
        (0x10000, b"\xf0\x90\x80\x80"),
        (0x1FFFFF, b"\xf7\xbf\xbf\xbf"),
        (0x200000, b"\xf8\x88\x80\x80\x80"),
        (0x3FFFFFF, b"\xfb\xbf\xbf\xbf\xbf"),
        (0x4000000, b"\xfc\x84\x80\x80\x80\x80"),
        (0xFFFFFFFF, b"\xfe\x83\xbf\xbf\xbf\xbf\xbf"),
        (0xF_FFFF_FFFF, b"\xfe\xbf\xbf\xbf\xbf\xbf\xbf"),
    ],
)
def test_utf8_frame_number(n, expected):
    # Extract just the frame-number bytes from a synthetic header.
    w = BitWriter()
    write_frame_header(w, True, 4096, 44100, 1, 16, n)
    data = w.getvalue()
    # header: 2 sync + (bs|sr) 1 + (ch|depth) 1 = 4 bytes, then frame number
    fn = data[4 : 4 + len(expected)]
    assert fn == expected


def test_utf8_frame_number_roundtrip():
    from zigflac_tpu.decoder import _read_utf8_number

    for n in [0, 1, 127, 128, 2**11 - 1, 2**16, 2**21, 2**26 + 12345, 2**35]:
        w = BitWriter()
        write_frame_header(w, True, 4096, 44100, 1, 16, n)
        r = BitReader(w.getvalue(), 32)
        assert _read_utf8_number(r) == n


def test_cumsum_bits_exact_wide_symbols():
    """_cumsum_bits_exact must be exact for wide symbol widths (a long
    unary quotient on one impulsive residual). It runs its dot at
    Precision.HIGHEST because at default precision a GPU may run the f32
    matmul in TF32 (11 significant bits), which rounds widths such as 2049
    or 4001 and shifts every later deposit offset; bfloat16 operands
    (8 significant bits) would already round 257 and 513. CPU dots are
    exact, so on the CPU suite this pins the blocked-matmul plumbing; the
    gpu-marked tests run the same function on the card."""
    import jax.numpy as jnp
    from zigflac_tpu.ops.bitpack import _cumsum_bits_exact

    rng = np.random.default_rng(123)
    nb = rng.integers(0, 20, size=(6, 1000)).astype(np.int32)
    # odd widths straddling bf16 and TF32 representability, off-lane-grid
    nb[0, 37] = 513
    nb[1, 129] = 257
    nb[2, 500] = 4095
    nb[3, 999] = 100003
    nb[4, 127] = 2049
    nb[5, 128] = 4001
    got = np.asarray(_cumsum_bits_exact(jnp.asarray(nb)))
    want = np.cumsum(nb, axis=1, dtype=np.int64)
    assert want.max() < (1 << 24)
    np.testing.assert_array_equal(got, want.astype(np.int32))


def test_cumsum_bits_exact_requests_highest_precision():
    """The prefix-sum matmul is lowered with precision HIGHEST on both
    operands: the property that keeps it exact where the backend would
    otherwise use TF32 (widths above 2048 bits) or bf16."""
    import jax
    import jax.numpy as jnp
    from zigflac_tpu.ops.bitpack import _cumsum_bits_exact

    text = jax.jit(_cumsum_bits_exact).lower(
        jnp.zeros((2, 300), jnp.int32)
    ).as_text()
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots, "the prefix sum no longer lowers to a matmul"
    for line in dots:
        assert "precision = [HIGHEST, HIGHEST]" in line, line
