"""FLAC decoder — the round-trip correctness oracle (and BASELINE config 5).

The reference has no decoder (readme.md:33 lists it as queued); ours exists so
every encoded stream can be verified end-to-end: parse metadata + frames,
Rice-decode residuals, run fixed/LPC synthesis, check frame CRC-8/CRC-16 and
the STREAMINFO MD5 against the reconstructed PCM.

Supports everything our encoder emits: constant/verbatim/fixed(0-4)/LPC
subframes, 4+5-bit Rice methods with escape partitions, all stereo modes,
UTF-8-coded frame numbers, uncommon block sizes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .crc import crc8, crc16
from .utils.bits import BitReader
from .metadata import StreamInfo


class FlacDecodeError(ValueError):
    pass


BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192, 14: 16384, 15: 32768,
}
SAMPLE_RATES = {
    1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050, 7: 24000,
    8: 32000, 9: 44100, 10: 48000, 11: 96000,
}
# frame-header 4-bit depth codes as the reference writes them
# (FrameWriter.zig:202-214): {0: from-streaminfo, 2: 8, 8: 16, 12: 24, 14: 32}
DEPTH_CODES_4BIT = {0: 0, 2: 8, 4: 12, 8: 16, 10: 20, 12: 24, 14: 32}

FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


@dataclass
class DecodedStream:
    info: StreamInfo
    samples: np.ndarray  # [channels, n] int64 (covers 33-bit side math)
    vendor: Optional[bytes]
    frame_count: int
    md5_ok: bool
    tags: Optional[list] = None
    seektable: Optional[list] = None


def parse_vorbis_body(body: bytes):
    """VorbisComment block body -> (vendor bytes, comment strings).

    Loops are bounded by the REAL body, never the claimed tag count: a
    corrupted count (up to 2^32) over an exhausted body would otherwise
    spin ~forever on zero-length reads (found by tools/fuzz_decode.py).
    Shared by the metadata parser and the CLI --list printer."""
    vlen = int.from_bytes(body[0:4], "little")
    vendor = body[4 : 4 + vlen]
    p = 4 + vlen
    ntags = int.from_bytes(body[p : p + 4], "little")
    p += 4
    comments = []
    for _ in range(ntags):
        if p + 4 > len(body):
            raise FlacDecodeError("truncated VorbisComment block")
        clen = int.from_bytes(body[p : p + 4], "little")
        p += 4
        comments.append(body[p : p + clen].decode("utf-8", "replace"))
        p += clen
    return vendor, comments


def _parse_metadata(data: bytes):
    if data[:4] != b"fLaC":
        raise FlacDecodeError("bad signature")
    pos = 4
    info: Optional[StreamInfo] = None
    vendor: Optional[bytes] = None
    tags: list = []
    seektable: list = []
    while True:
        hdr = data[pos]
        is_last = bool(hdr & 0x80)
        btype = hdr & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        pos += 4 + length
        if btype == 0:  # STREAMINFO
            if length != 34:
                raise FlacDecodeError("bad STREAMINFO length")
            min_block = int.from_bytes(body[0:2], "big")
            max_block = int.from_bytes(body[2:4], "big")
            min_frame = int.from_bytes(body[4:7], "big")
            max_frame = int.from_bytes(body[7:10], "big")
            packed = int.from_bytes(body[10:18], "big")
            sample_rate = packed >> 44
            channels = ((packed >> 41) & 0x7) + 1
            bit_depth = ((packed >> 36) & 0x1F) + 1
            total = packed & ((1 << 36) - 1)
            info = StreamInfo(
                sample_rate=sample_rate,
                channels=channels,
                bit_depth=bit_depth,
                interchannel_samples=total,
                min_block_size=min_block,
                max_block_size=max_block,
                md5=body[18:34],
                min_frame_size=min_frame,
                max_frame_size=max_frame,
            )
        elif btype == 3:  # SeekTable
            for p in range(0, length, 18):
                seektable.append((
                    int.from_bytes(body[p : p + 8], "big"),
                    int.from_bytes(body[p + 8 : p + 16], "big"),
                    int.from_bytes(body[p + 16 : p + 18], "big"),
                ))
        elif btype == 4:  # VorbisComment
            vendor, comments = parse_vorbis_body(body)
            tags.extend(
                tuple(c.split("=", 1)) for c in comments if "=" in c
            )
        if is_last:
            break
    if info is None:
        raise FlacDecodeError("no STREAMINFO")
    return info, vendor, tags, seektable, pos


BLOCK_NAMES = {
    0: "STREAMINFO", 1: "PADDING", 2: "APPLICATION", 3: "SEEKTABLE",
    4: "VORBIS_COMMENT", 5: "CUESHEET", 6: "PICTURE",
}


def metadata_blocks(data):
    """Walk the raw metadata chain of a native FLAC stream: yields
    ``(block_type, body bytes)`` per block, STREAMINFO first (the block
    layout of libFLAC/metadata.zig:3-18). ``data`` may be bytes or an mmap;
    only the metadata head is touched."""
    if bytes(data[:4]) != b"fLaC":
        raise FlacDecodeError("bad signature")
    pos = 4
    while True:
        if pos + 4 > len(data):
            # a chain whose last block lacks the last-flag runs off the
            # end — typed error, not IndexError (--edit exit-2 contract)
            raise FlacDecodeError("truncated metadata chain")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = bytes(data[pos + 4 : pos + 4 + length])
        if len(body) < length:
            raise FlacDecodeError("truncated metadata block")
        yield hdr & 0x7F, body
        pos += 4 + length
        if hdr & 0x80:
            break


def _read_utf8_number(r: BitReader) -> int:
    first = r.read(8)
    if first < 0x80:
        return first
    n_cont = 0
    mask = 0x40
    while first & mask:
        n_cont += 1
        mask >>= 1
    value = first & (mask - 1)
    for _ in range(n_cont):
        b = r.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacDecodeError("bad UTF-8 frame number")
        value = (value << 6) | (b & 0x3F)
    return value


def _decode_residual_partitions(
    r: BitReader, block_size: int, pred_order: int
) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise FlacDecodeError("bad residual method")
    param_len = 4 + method
    escape = (1 << param_len) - 1
    part_order = r.read(4)
    part_count = 1 << part_order
    out = np.zeros(block_size - pred_order, dtype=np.int64)
    idx = 0
    for p in range(part_count):
        part_size = block_size >> part_order
        if p == 0:
            part_size -= pred_order
        param = r.read(param_len)
        if param == escape:
            bps = r.read(5)
            if bps == 0:
                idx += part_size
                continue
            for i in range(part_size):
                out[idx + i] = r.read_signed(bps)
            idx += part_size
        else:
            k = param
            for i in range(part_size):
                q = r.read_unary()
                z = (q << k) | (r.read(k) if k else 0)
                out[idx + i] = (z >> 1) ^ -(z & 1)
            idx += part_size
    return out


def _synthesize(warmup: np.ndarray, residual: np.ndarray, coeffs: List[int],
                shift: int = 0) -> np.ndarray:
    order = len(coeffs)
    n = order + len(residual)
    out = np.zeros(n, dtype=np.int64)
    out[:order] = warmup
    o = out.tolist()
    res = residual.tolist()
    limit = 1 << 40  # far beyond any valid 33-bit sample; corrupt input guard
    for i in range(order, n):
        pred = 0
        for j in range(order):
            pred += coeffs[j] * o[i - 1 - j]
        v = res[i - order] + (pred >> shift)
        if not -limit < v < limit:
            raise FlacDecodeError("synthesis diverged — corrupt stream")
        o[i] = v
    return np.array(o, dtype=np.int64)


def _decode_subframe(r: BitReader, block_size: int, sample_size: int) -> np.ndarray:
    if r.read(1) != 0:
        raise FlacDecodeError("bad subframe sync bit")
    sf_type = r.read(6)
    wasted = 0
    if r.read(1) == 1:
        wasted = 1 + r.read_unary()
        sample_size -= wasted
    if sf_type == 0:  # constant
        v = r.read_signed(sample_size)
        out = np.full(block_size, v, dtype=np.int64)
    elif sf_type == 1:  # verbatim
        out = np.array(
            [r.read_signed(sample_size) for _ in range(block_size)], dtype=np.int64
        )
    elif 8 <= sf_type <= 12:  # fixed, order = type & 7
        order = sf_type & 7
        warmup = np.array(
            [r.read_signed(sample_size) for _ in range(order)], dtype=np.int64
        )
        residual = _decode_residual_partitions(r, block_size, order)
        out = _synthesize(warmup, residual, FIXED_COEFFS[order])
    elif sf_type >= 32:  # LPC, order = (type & 31) + 1
        order = (sf_type & 31) + 1
        warmup = np.array(
            [r.read_signed(sample_size) for _ in range(order)], dtype=np.int64
        )
        precision = r.read(4) + 1
        if precision == 16:
            raise FlacDecodeError("invalid LPC precision")
        shift = r.read_signed(5)
        if shift < 0:
            raise FlacDecodeError("negative LPC shift")
        coeffs = [r.read_signed(precision) for _ in range(order)]
        residual = _decode_residual_partitions(r, block_size, order)
        out = _synthesize(warmup, residual, coeffs, shift)
    else:
        raise FlacDecodeError(f"unsupported subframe type {sf_type}")
    if wasted:
        out <<= wasted
    return out


def decode_frame(
    data: bytes, start: int, info: StreamInfo, check_crc: bool = True
) -> Tuple[np.ndarray, int, int]:
    """Decode one frame starting at byte offset ``start``.

    Returns (samples [channels, block_size] int64, frame_number, end_offset).
    """
    r = BitReader(data, start * 8)
    sync = r.read(14)
    if sync != 0x3FFE:
        raise FlacDecodeError(f"bad frame sync at {start}")
    r.read(1)  # reserved
    _blocking = r.read(1)  # 0 fixed, 1 variable
    bs_code = r.read(4)
    sr_code = r.read(4)
    ch_code = r.read(4)
    depth_code = r.read(4)
    frame_number = _read_utf8_number(r)
    if bs_code == 6:
        block_size = r.read(8) + 1
    elif bs_code == 7:
        block_size = r.read(16) + 1
    elif bs_code in BLOCK_SIZES:
        block_size = BLOCK_SIZES[bs_code]
    else:
        raise FlacDecodeError("reserved block size code")
    if sr_code == 12:
        r.read(8)
    elif sr_code in (13, 14):
        r.read(16)
    header_end_byte = r.bit_position // 8
    expected_crc8 = crc8(data[start:header_end_byte])
    got_crc8 = r.read(8)
    if check_crc and got_crc8 != expected_crc8:
        raise FlacDecodeError(f"frame header CRC-8 mismatch at {start}")
    if depth_code not in DEPTH_CODES_4BIT:
        raise FlacDecodeError(f"unsupported depth code {depth_code}")
    depth = DEPTH_CODES_4BIT[depth_code] or info.bit_depth

    if ch_code <= 7:
        n_ch = ch_code + 1
        planes = [_decode_subframe(r, block_size, depth) for _ in range(n_ch)]
        samples = np.stack(planes)
    elif ch_code == 8:  # left-side: wire = (left @ depth, side @ depth+1)
        left = _decode_subframe(r, block_size, depth)
        side = _decode_subframe(r, block_size, depth + 1)
        samples = np.stack([left, left - side])
    elif ch_code == 9:  # side-right: wire = (side @ depth+1, right @ depth)
        side = _decode_subframe(r, block_size, depth + 1)
        right = _decode_subframe(r, block_size, depth)
        samples = np.stack([side + right, right])
    elif ch_code == 10:  # mid-side: wire = (mid @ depth, side @ depth+1)
        mid = _decode_subframe(r, block_size, depth)
        side = _decode_subframe(r, block_size, depth + 1)
        # mid = (l+r)>>1 (floor), side = l-r  =>  l = mid + ((side + (side&1)) >> 1)
        left = mid + ((side + (side & 1)) >> 1)
        samples = np.stack([left, left - side])
    else:
        raise FlacDecodeError("reserved channel code")
    r.align_to_byte()
    body_end = r.bit_position // 8
    got_crc16 = r.read(16)
    if check_crc:
        expected_crc16 = crc16(data[start:body_end])
        if got_crc16 != expected_crc16:
            raise FlacDecodeError(f"frame CRC-16 mismatch at {start}")
    return samples, frame_number, body_end + 2


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length() if n > 1 else 1


def _to_i32(wire):
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda w: w.astype(jnp.int32))(wire)


_BATCH_FRAMES = 512


def _decode_batch(
    data: bytes, pos: int, info: StreamInfo, check_crc: bool,
    synth: str = "device", max_frames: int = _BATCH_FRAMES,
):
    """Native parse + batched synthesis for up to _BATCH_FRAMES consecutive
    frames sharing one block size. Returns (samples [C, m] int64, n_frames,
    end_pos). The serial bit extraction runs in C++ (zf_native.parse_frames),
    normalizing every subframe to one predictor form; synthesis then runs
    either as one vectorized device scan (``synth="device"``, ops/synth.py —
    the decoding dual of the encoder's frames-as-batch design) or fully in
    the C++ runtime (``synth="native"`` — no device transfers, the fast path
    on thin links). Both produce identical samples."""
    import _zf_native as _n

    C = info.channels
    try:
        (n, end, B, vb, qb, sb, cb, fb, kb, eb) = _n.parse_frames(
            data, pos, max_frames, info.bit_depth, C
        )
    except ValueError as e:
        raise FlacDecodeError(str(e)) from e
    if n == 0:
        return np.zeros((C, 0), np.int64), 0, pos
    ch_code = np.frombuffer(cb, np.int32)
    crc_ok = np.frombuffer(kb, np.uint8)
    if check_crc and not crc_ok.all():
        bad = int(np.argmin(crc_ok))
        raise FlacDecodeError(f"frame CRC mismatch (frame {bad} of batch)")

    if synth == "native":
        samples = np.frombuffer(
            _n.synthesize(vb, qb, sb, cb, n, C, B), np.int64
        ).reshape(n, C, B)
    else:
        from .ops.synth import recombine_stereo, synthesize_batch

        values = np.frombuffer(vb, np.int64).reshape(n, C, B)
        qco = np.frombuffer(qb, np.int64).reshape(n, C, 32)
        sow = np.frombuffer(sb, np.int32).reshape(n, C, 3)
        # pad the subframe axis to a power-of-two bucket: one compiled
        # synthesis program per (bucket, B) instead of one per frame count
        M = n * C
        bucket = _next_pow2(M)
        v2 = values.reshape(M, B)
        q2 = qco.reshape(M, 32)
        s2 = sow.reshape(M, 3)
        if bucket != M:
            padn = bucket - M
            v2 = np.concatenate([v2, np.zeros((padn, B), np.int64)])
            q2 = np.concatenate([q2, np.zeros((padn, 32), np.int64)])
            s2 = np.concatenate([s2, np.zeros((padn, 3), np.int32)])
        wire = synthesize_batch(v2, q2, s2[:, 0], s2[:, 1], s2[:, 2])
        wire = wire[:M].reshape(n, C, B)
        if C == 2 and (ch_code >= 8).any():
            wire = recombine_stereo(wire, ch_code)
        if info.bit_depth <= 24:
            # samples fit i32 (depth+1 side headroom <= 25 bits): halve the
            # device->host bytes, then widen on host (the decoder's public
            # dtype is int64 for the 33-bit depth-32 case)
            samples = np.asarray(_to_i32(wire)).astype(np.int64)
        else:
            samples = np.asarray(wire)
    if np.abs(samples).max(initial=0) >= (1 << 40):
        raise FlacDecodeError("synthesis diverged — corrupt stream")
    return samples.transpose(1, 0, 2).reshape(C, n * B), n, end


def _resolve_backend(backend: str) -> str:
    from . import native as _native

    have = _native.HAVE_NATIVE and hasattr(_native._n, "parse_frames")
    if backend == "auto":
        if have and hasattr(_native._n, "synthesize"):
            return "native"
        return "device" if have else "host"
    return backend


def decode_flac(
    data: bytes, check_crc: bool = True, backend: str = "auto"
) -> DecodedStream:
    """Decode a FLAC stream.

    ``backend``: "native" batches frames through the C++ bit parser with
    C++ IIR synthesis (no device transfers — the fast path on thin links);
    "device" uses the same parser with the vectorized device synthesis scan;
    "host" is the scalar per-sample reference path; "auto" picks native when
    built. All produce identical samples (tests/test_decoder_batch.py).
    """
    backend = _resolve_backend(backend)
    info, vendor, tags, seektable, pos = _parse_metadata(data)
    chunks: List[np.ndarray] = []
    frame_count = 0
    total = 0
    while total < info.interchannel_samples and pos < len(data):
        if backend in ("device", "native"):
            samples, nfr, pos = _decode_batch(
                data, pos, info, check_crc, synth=backend
            )
            if nfr == 0:
                break
            frame_count += nfr
        else:
            samples, _fn, pos = decode_frame(data, pos, info, check_crc)
            frame_count += 1
        chunks.append(samples)
        total += samples.shape[1]
    if total != info.interchannel_samples:
        raise FlacDecodeError(
            f"decoded {total} samples, STREAMINFO says {info.interchannel_samples}"
        )
    samples = np.concatenate(chunks, axis=1) if chunks else np.zeros(
        (info.channels, 0), dtype=np.int64
    )
    md5_ok = _verify_md5(samples, info)
    return DecodedStream(
        info, samples, vendor, frame_count, md5_ok, tags, seektable or None
    )


def _verify_md5(samples: np.ndarray, info: StreamInfo) -> bool:
    """Re-derive the raw little-endian PCM byte stream and compare its MD5
    with STREAMINFO's (which the encoder computed over the raw WAV bytes,
    src/WavReader.zig:69). Uses the same serialization helper as the encoder
    (wav.reconstruct_raw_bytes), covering every 4-32-bit depth (sub-byte
    and non-byte-aligned depths use the left-justified container stride
    with the 1-byte read-quirk inverse)."""
    from .wav import reconstruct_raw_bytes

    if info.md5 == b"\x00" * 16:
        return True
    raw = reconstruct_raw_bytes(samples, info.bit_depth)
    return hashlib.md5(raw).digest() == info.md5


def decode_file(
    input_path: str,
    output_path: str,
    check_crc: bool = True,
    backend: str = "auto",
    verify: bool = False,
    threads: int | None = None,
) -> StreamInfo:
    """Streaming flac2wav: decode a FLAC file to a PCM WAV with host memory
    bounded by one frame batch — the decode-side counterpart of the
    encoder's streaming feeder. The input maps via mmap (the C++ parser
    reads straight from the mapping, page cache evictable), the WAV header
    is written up front from STREAMINFO, and each decoded batch's samples
    stream out immediately; MD5 accumulates incrementally when ``verify``.

    Returns the STREAMINFO. Raises FlacDecodeError on CRC/MD5/format
    failure (``verify=True`` adds the MD5 check).

    ``threads``: frame-parallel native decode worker count; ``None`` uses
    the host CPU count. Frames are independent once their byte boundaries
    are known, so workers speculatively start at sync-scan candidates and
    the stitcher verifies the spans chain exactly, falling back to serial
    decode from the last verified byte on any mismatch — the output is
    byte-identical to single-threaded decode by construction.
    """
    import mmap
    import os as _os

    from . import native as _native
    from .wav import reconstruct_raw_bytes, wav_header_bytes, wav_pcm_bytes

    backend = _resolve_backend(backend)
    fused = backend == "native" and hasattr(_native._n, "decode_frames_pcm")
    if threads is None:
        threads = _os.cpu_count() or 1
    mt = (fused and threads > 1
          and hasattr(_native._n, "decode_frames_pcm_mt"))
    with open(input_path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            if mm[:4] == b"OggS":
                # Ogg-FLAC input: strip the container first (page CRCs
                # verified). The native stream is held in memory for the
                # decode — unlike the mmap path this is O(file), which is
                # fine for the container use case; a page-streaming
                # transmux can bound it later if needed.
                from .ogg import ogg_to_flac

                try:
                    native_stream = ogg_to_flac(bytes(mm), verify_crc=check_crc)
                except ValueError as e:
                    raise FlacDecodeError(str(e)) from e
                mm.close()
                mm = native_stream  # bytes quack enough for the loop below
            info, _vendor, _tags, _seek, pos = _parse_metadata(mm)
            md5 = _native.Md5Stream() if verify else None
            total = 0
            nb = (info.bit_depth + 7) // 8
            # MT path: a bigger per-call budget amortizes the per-batch
            # sync scan + thread spawn; bounded so the batch's
            # PCM buffer stays ~<=64 MB at the nominal 4096 block
            batch_frames = _BATCH_FRAMES
            if mt:
                byte_cap = (64 << 20) // max(4096 * info.channels * nb, 1)
                batch_frames = max(
                    _BATCH_FRAMES, min(threads * _BATCH_FRAMES, byte_cap)
                )
            try:
                # raises ValueError when a (possibly corrupt) STREAMINFO
                # claims more PCM than RIFF's u32 sizes can carry — keep
                # the CLI's typed-error contract (exit 2, no traceback)
                wav_hdr = wav_header_bytes(
                    info.interchannel_samples, info.channels,
                    info.sample_rate, info.bit_depth,
                )
            except ValueError as e:
                raise FlacDecodeError(str(e)) from e
            with open(output_path, "wb") as out:
                out.write(wav_hdr)
                while total < info.interchannel_samples and pos < len(mm):
                    if fused:
                        # single native pass: parse + synthesis + container
                        # serialization (the PCM bytes come out ready to
                        # write, and — for multi-byte containers — ready to
                        # MD5: reconstruct_raw_bytes == wav_pcm_bytes there)
                        if mt:
                            nfr, pos, _B, pcm, bad, maxabs = (
                                _native._n.decode_frames_pcm_mt(
                                    mm, pos, batch_frames, info.bit_depth,
                                    info.channels, threads,
                                )
                            )
                        else:
                            nfr, pos, _B, pcm, bad, maxabs = (
                                _native._n.decode_frames_pcm(
                                    mm, pos, _BATCH_FRAMES, info.bit_depth,
                                    info.channels,
                                )
                            )
                        if nfr == 0:
                            break
                        if check_crc and bad >= 0:
                            raise FlacDecodeError(
                                f"frame CRC mismatch (frame {bad} of batch)"
                            )
                        if maxabs >= 1 << 40:
                            raise FlacDecodeError(
                                "synthesis diverged — corrupt stream"
                            )
                        m = len(pcm) // (info.channels * nb)
                        total += m
                        if total > info.interchannel_samples:
                            cut = (total - info.interchannel_samples) * (
                                info.channels * nb
                            )
                            pcm = pcm[: len(pcm) - cut]
                            total = info.interchannel_samples
                        out.write(pcm)
                        if md5 is not None:
                            if nb == 1:
                                # 1-byte container: MD5 covers the quirk
                                # inverse (value+1 left-justified,
                                # src/WavReader.zig:74-81); the WAV
                                # container byte is value<<pad + 128, so
                                # rebias by (1<<pad) - 128 (mod 256)
                                pad = 8 - info.bit_depth
                                md5.update(
                                    (
                                        np.frombuffer(pcm, np.uint8)
                                        + np.uint8(((1 << pad) - 128) & 0xFF)
                                    ).tobytes()
                                )
                            else:
                                md5.update(pcm)
                        continue
                    if backend in ("device", "native"):
                        samples, nfr, pos = _decode_batch(
                            mm, pos, info, check_crc, synth=backend
                        )
                        if nfr == 0:
                            break
                    else:
                        samples, _fn, pos = decode_frame(
                            mm, pos, info, check_crc
                        )
                    total += samples.shape[1]
                    if total > info.interchannel_samples:
                        # trim padding of the final frame batch
                        samples = samples[
                            :, : samples.shape[1]
                            - (total - info.interchannel_samples)
                        ]
                        total = info.interchannel_samples
                    out.write(wav_pcm_bytes(samples, info.bit_depth))
                    if md5 is not None:
                        md5.update(
                            reconstruct_raw_bytes(samples, info.bit_depth)
                        )
            if total != info.interchannel_samples:
                raise FlacDecodeError(
                    f"decoded {total} samples, STREAMINFO says "
                    f"{info.interchannel_samples}"
                )
            if md5 is not None and info.md5 != b"\x00" * 16:
                if md5.digest() != info.md5:
                    raise FlacDecodeError("MD5 mismatch")
            return info
        finally:
            if hasattr(mm, "close"):  # bytes after an Ogg transmux
                mm.close()


def decode_range(
    data: bytes, start_sample: int, n_samples: int, check_crc: bool = True,
    backend: str = "auto",
) -> np.ndarray:
    """Random-access decode: ``[channels, n_samples]`` starting at
    ``start_sample``, using the SEEKTABLE (when present) to skip ahead —
    only the frames covering the range are parsed and synthesized.

    Seek points map sample numbers to byte offsets from the first frame
    (metadata.build_seekpoints); without a SEEKTABLE decoding starts at the
    first frame. Frames before the target that the nearest seek point cannot
    skip are decoded and discarded (FLAC frames are independent, so this is
    exact). Frames ride the native batch parser (the fast path) unless
    ``backend="host"`` forces the scalar reference decoder; batch sizes are
    capped near the range so little work happens past its end."""
    backend = _resolve_backend(backend)
    info, _vendor, _tags, seektable, pos = _parse_metadata(data)
    if start_sample < 0 or start_sample + n_samples > info.interchannel_samples:
        raise FlacDecodeError("requested range outside the stream")
    first_frame_pos = pos
    cur_sample = 0
    best = None
    for sample, offset, _ns in seektable or []:
        if sample <= start_sample and (best is None or sample > best[0]):
            best = (sample, offset)
    if best is not None:
        cur_sample = best[0]
        pos = first_frame_pos + best[1]

    out: List[np.ndarray] = []
    got = 0
    block_hint = info.max_block_size or 4096
    while got < n_samples and pos < len(data):
        if backend in ("device", "native"):
            # bound the batch to the frames the range can still need
            need = start_sample + n_samples - cur_sample
            maxf = min(_BATCH_FRAMES, -(-need // max(block_hint, 1)) + 1)
            samples, nfr, pos = _decode_batch(
                data, pos, info, check_crc, synth=backend, max_frames=maxf
            )
            if nfr == 0:
                break
            block_hint = samples.shape[1] // nfr
        else:
            samples, _fn, pos = decode_frame(data, pos, info, check_crc)
        bs = samples.shape[1]
        if cur_sample + bs <= start_sample:
            cur_sample += bs
            continue
        lo = max(0, start_sample + got - cur_sample)
        hi = min(bs, start_sample + n_samples - cur_sample)
        out.append(samples[:, lo:hi])
        got += hi - lo
        cur_sample += bs
    if got != n_samples:
        raise FlacDecodeError("stream ended inside the requested range")
    return np.concatenate(out, axis=1)


def verify_flac(data: bytes) -> bool:
    """Decode + verify CRCs and MD5; True iff everything checks out.
    Ogg-FLAC input is stripped transparently (page CRCs count too).

    Truncated input surfaces as EOFError/IndexError from the bit reader and
    metadata parser rather than FlacDecodeError — treat those as a clean
    verification failure, not a crash."""
    try:
        if data[:4] == b"OggS":
            from .ogg import ogg_to_flac

            data = ogg_to_flac(data)
        dec = decode_flac(data, check_crc=True)
    except (FlacDecodeError, EOFError, IndexError, ValueError):
        return False
    return dec.md5_ok
