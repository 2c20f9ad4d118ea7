"""Robustness: malformed inputs fail with typed errors, never crashes;
container parsing handles real-world WAV layouts."""

import io
import os

import numpy as np
import pytest

from zigflac_tpu.decoder import FlacDecodeError, decode_flac
from zigflac_tpu.models.encoder import encode_wav_bytes
from zigflac_tpu.wav import WavFormatError, WavReader, write_wav

from conftest import make_signal


def make_flac(rng, n=4096 + 100):
    samples = make_signal(rng, n, channels=2, depth=16, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    return encode_wav_bytes(buf.getvalue(), backend="golden")


def test_decoder_bitflip_fuzz(rng):
    """Corrupting any byte must produce a typed decode error or a CRC/MD5
    failure — never an unhandled exception."""
    flac = make_flac(rng)
    data = bytearray(flac)
    for _ in range(60):
        pos = int(rng.integers(4, len(data)))
        old = data[pos]
        data[pos] ^= 1 << int(rng.integers(0, 8))
        try:
            dec = decode_flac(bytes(data), check_crc=True)
            # a lucky flip in ignored padding may still verify; that's fine
        except (FlacDecodeError, EOFError):
            pass
        data[pos] = old


def test_decoder_truncation(rng):
    flac = make_flac(rng)
    for cut in [10, 50, len(flac) // 2, len(flac) - 3]:
        with pytest.raises((FlacDecodeError, EOFError, IndexError)):
            decode_flac(flac[:cut])


def test_wav_chunk_skipping(rng):
    """LIST/fact chunks before fmt and between fmt and data are skipped
    (reference behavior, src/WavReader.zig:126-129,158-164)."""
    samples = make_signal(rng, 1000, channels=2, depth=16, kind="sine")
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    raw = bytearray(buf.getvalue())
    # splice a LIST chunk between fmt and data
    fmt_end = 12 + 8 + 16
    junk = b"LIST" + (6).to_bytes(4, "little") + b"INFOxy"
    raw2 = bytes(raw[:fmt_end]) + junk + bytes(raw[fmt_end:])
    # fix RIFF size
    riff_len = len(raw2) - 8
    raw3 = raw2[:4] + riff_len.to_bytes(4, "little") + raw2[8:]
    wav = WavReader.from_bytes(raw3)
    np.testing.assert_array_equal(wav.planar_samples(), samples)


def test_wav_errors(rng):
    with pytest.raises(WavFormatError):
        WavReader.from_bytes(b"RIFX" + b"\x00" * 100)
    with pytest.raises(WavFormatError):
        WavReader.from_bytes(b"RIFF\x00\x00\x00\x00WAVX" + b"\x00" * 100)
    # truncated mid-header
    with pytest.raises((WavFormatError, EOFError)):
        WavReader.from_bytes(b"RIFF\x04\x00\x00\x00WAVE")


def test_wav_bad_block_align(rng):
    """block_align inconsistent with channels/bit_depth must raise a typed
    error, never reach the native de-interleave (which would SIGFPE on
    stride 0 or hit negative-shift UB on stride > 4)."""
    samples = make_signal(rng, 256, channels=2, depth=16, kind="sine")
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    good = bytearray(buf.getvalue())
    # fmt fields start at offset 20: codec(2) ch(2) rate(4) brate(4) align(2) depth(2)
    for bad_align in (0, 1, 3, 10, 255):
        raw = bytearray(good)
        raw[32:34] = bad_align.to_bytes(2, "little")
        # keep byte_rate consistent so the align check is what fires
        rate = int.from_bytes(raw[24:28], "little")
        raw[28:32] = (rate * (bad_align // 2) * 2).to_bytes(4, "little")
        with pytest.raises(WavFormatError):
            WavReader.from_bytes(bytes(raw))


def test_verify_flac_truncation_returns_false(rng):
    """verify_flac reports False on truncated streams instead of leaking
    EOFError/IndexError (the CLI maps False to exit 3)."""
    from zigflac_tpu.decoder import verify_flac

    flac = make_flac(rng)
    assert verify_flac(flac)
    for cut in [4, 10, 50, len(flac) // 2, len(flac) - 3]:
        assert verify_flac(flac[:cut]) is False


def test_pcm_extend_format(rng):
    """PCM_EXTEND (0xFFFE) with valid-bits override parses like the
    reference (src/WavReader.zig:147-155)."""
    samples = make_signal(rng, 500, channels=2, depth=24, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, samples, 48000, 24)
    raw = bytearray(buf.getvalue())
    # rewrite the fmt chunk as extensible: codec 0xFFFE, size 40
    # original fmt: offset 12: "fmt " + size(16) + fields(16)
    fields = bytes(raw[20:36])
    ext = (
        b"fmt " + (40).to_bytes(4, "little")
        + b"\xfe\xff" + fields[2:]
        + (22).to_bytes(2, "little")
        + (24).to_bytes(2, "little")  # valid bits
        + (0).to_bytes(4, "little")   # channel mask
        + b"\x01\x00\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    )
    rest = bytes(raw[36:])
    out = bytes(raw[:12]) + ext + rest
    out = out[:4] + (len(out) - 8).to_bytes(4, "little") + out[8:]
    wav = WavReader.from_bytes(out)
    assert wav.bit_depth == 24
    np.testing.assert_array_equal(wav.planar_samples(), samples)


def test_seek_interval_must_be_positive(rng, tmp_path):
    """A non-positive seek interval raises up front instead of looping
    forever in the seekpoint counter (or emitting a garbage table)."""
    from zigflac_tpu.metadata import StreamInfo
    from zigflac_tpu.models.encoder import Encoder, encode_file_streaming
    from zigflac_tpu.utils.config import EncoderConfig

    samples = make_signal(rng, 1000, channels=2, depth=16, kind="sine")
    wav_path = tmp_path / "in.wav"
    write_wav(str(wav_path), samples, 44100, 16)
    for bad in (0, -1, -44100):
        with pytest.raises(ValueError, match="seek_interval"):
            encode_file_streaming(
                str(wav_path), str(tmp_path / "out.flac"),
                backend="golden", seek_interval=bad,
            )
    info = StreamInfo(
        sample_rate=44100, channels=2, bit_depth=16,
        interchannel_samples=1000, min_block_size=4096, max_block_size=4096,
    )
    enc = Encoder(EncoderConfig(channels="stereo_auto"), 16, backend="golden")
    with pytest.raises(ValueError, match="seek_interval"):
        enc.encode_stream(samples, info, seek_interval=-1)


def test_truncated_wav_fails_before_output(rng, tmp_path):
    """A data chunk shorter than its declared length fails at open time
    (WavFormatError) and never leaves a partial .flac on disk."""
    from zigflac_tpu.models.encoder import encode_file
    from zigflac_tpu.wav import WavStreamReader

    samples = make_signal(rng, 5000, channels=2, depth=16, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    raw = buf.getvalue()
    wav_path = tmp_path / "trunc.wav"
    wav_path.write_bytes(raw[: len(raw) - 1000])  # cut into the data chunk
    out_path = tmp_path / "out.flac"
    with pytest.raises(WavFormatError, match="IncompleteStream"):
        encode_file(str(wav_path), str(out_path), backend="golden")
    assert not out_path.exists()
    with pytest.raises(WavFormatError, match="IncompleteStream"):
        WavStreamReader.open(str(wav_path))


def test_partial_output_removed_on_midstream_failure(rng, tmp_path, monkeypatch):
    """Failures raised after frames started streaming delete the partial
    output file instead of leaving a half-written .flac behind."""
    from zigflac_tpu.models import encoder as enc_mod

    samples = make_signal(rng, 5000, channels=2, depth=16, kind="mixed")
    wav_path = tmp_path / "in.wav"
    write_wav(str(wav_path), samples, 44100, 16)
    out_path = tmp_path / "out.flac"

    def boom(*a, **k):
        raise RuntimeError("injected mid-encode failure")

    monkeypatch.setattr(enc_mod, "build_seekpoints", boom)
    with pytest.raises(RuntimeError, match="injected"):
        enc_mod.encode_file(
            str(wav_path), str(out_path), backend="golden",
            seek_interval=1000,
        )
    assert not out_path.exists()


def test_native_synthesize_validates_geometry():
    """Mismatched buffer lengths raise ValueError instead of reading or
    writing out of bounds in native code."""
    _n = pytest.importorskip("_zf_native")
    if not hasattr(_n, "synthesize"):
        pytest.skip("native synthesize not built")
    n, C, B = 1, 2, 16
    vb = bytes(n * C * B * 8)
    qb = bytes(n * C * 32 * 8)
    sb = bytes(n * C * 3 * 4)
    cb = bytes(n * 4)
    # the well-formed call works
    out = _n.synthesize(vb, qb, sb, cb, n, C, B)
    assert len(out) == n * C * B * 8
    for bad in (
        (vb[:-8], qb, sb, cb),
        (vb, qb[:-8], sb, cb),
        (vb, qb, sb[:-4], cb),
        (vb, qb, sb, cb + b"\x00" * 4),
    ):
        with pytest.raises(ValueError, match="geometry"):
            _n.synthesize(*bad, n, C, B)
    with pytest.raises(ValueError, match="geometry"):
        _n.synthesize(vb, qb, sb, cb, n, C, B + 1)


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu_python(code, **env_over):
    """Run ``code`` in a fresh CPU-only interpreter at the repo root."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_over)
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, cwd=_REPO, timeout=300,
    )


def test_compile_cache_follows_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the package keeps its persistent
    compile cache there and nowhere else: a compiled program lands in it."""
    cache = tmp_path / "cc"
    code = (
        "import jax, jax.numpy as jnp, zigflac_tpu\n"
        "print(zigflac_tpu.CACHE_DIR)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.jit(lambda x: x * 3 + 1)(jnp.arange(8)).block_until_ready()\n"
    )
    r = _run_cpu_python(code, JAX_COMPILATION_CACHE_DIR=str(cache))
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [str(cache), str(cache)]
    assert any(cache.iterdir()), "nothing was cached in the env directory"


def test_compile_cache_defaults_to_checkout():
    """Without JAX_COMPILATION_CACHE_DIR the cache is the checkout's fixed
    .jax_cache directory (git-ignored), never a temporary path."""
    code = (
        "import jax, zigflac_tpu\n"
        "print(zigflac_tpu.CACHE_DIR)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
    )
    r = _run_cpu_python(code)
    assert r.returncode == 0, r.stderr
    want = os.path.join(_REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_backend_auto_never_falls_back_to_golden(rng, monkeypatch):
    """backend='auto' means the device pipeline: when that pipeline cannot
    be imported, encoding raises instead of quietly running the scalar
    host oracle."""
    import sys

    samples = make_signal(rng, 4096 + 300, channels=2, depth=16, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    wav = buf.getvalue()
    golden = encode_wav_bytes(wav, backend="golden")
    monkeypatch.setitem(sys.modules, "zigflac_tpu.models.pipeline", None)
    with pytest.raises(ImportError):
        encode_wav_bytes(wav)
    with pytest.raises(ImportError):
        encode_wav_bytes(wav, backend="device")
    assert encode_wav_bytes(wav, backend="golden") == golden


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py pins JAX to the CUDA platform: on a machine with no
    card (JAX_PLATFORMS=cpu asked for) it exits non-zero and never prints
    an ``"ok": true`` result line."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=_REPO, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_cli_decode_forwards_backend(rng, tmp_path, monkeypatch):
    """--decode honors --backend: golden maps to the decoder's scalar host
    path (previously the flag was silently ignored)."""
    import zigflac_tpu.cli as cli
    import zigflac_tpu.decoder as dec

    flac = make_flac(rng)
    fp = tmp_path / "x.flac"
    fp.write_bytes(flac)
    seen = {}
    real = dec.decode_file

    def spy(inp, outp, **kw):
        seen["backend"] = kw.get("backend", "auto")
        return real(inp, outp, **kw)

    monkeypatch.setattr(dec, "decode_file", spy)
    rc = cli.main([str(fp), str(tmp_path / "x.wav"), "--decode",
                   "--backend", "golden"])
    assert rc == 0
    assert seen["backend"] == "host"


def test_cli_list_metadata(rng, tmp_path, capsys):
    """--list dumps every metadata block of native and Ogg-FLAC files
    without an output path; a missing output without --list is a usage
    error (exit 1, the reference CLI contract)."""
    import io

    from zigflac_tpu import ogg
    from zigflac_tpu.cli import main
    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.wav import write_wav

    pcm = make_signal(rng, 4096 * 2 + 100, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, pcm, 44100, 16)
    flac = encode_wav_bytes(
        buf.getvalue(), backend="golden",
        tags=[("TITLE", "listme"), ("ARTIST", "x")], padding=512,
    )
    p = tmp_path / "a.flac"
    p.write_bytes(flac)
    assert main(["--list", str(p)]) == 0
    out = capsys.readouterr().out
    assert "STREAMINFO" in out and "44100 Hz, 2 ch, 16-bit" in out
    assert "TITLE=listme" in out and "PADDING: 512 bytes" in out

    oga = tmp_path / "a.oga"
    sink = io.BytesIO()
    ogg.flac_to_ogg(flac, sink)
    oga.write_bytes(sink.getvalue())
    assert main(["--list", str(oga)]) == 0
    out = capsys.readouterr().out
    assert "Ogg-FLAC" in out and "ARTIST=x" in out

    with pytest.raises(SystemExit) as ei:
        main([str(p)])
    assert ei.value.code == 1


def test_cli_test_mode(rng, tmp_path, capsys):
    """-t/--test verifies without writing output: ok on a clean file (exit
    0), exit 3 on a corrupted MD5, exit 2 on garbage."""
    import io

    from zigflac_tpu.cli import main
    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.wav import write_wav

    pcm = make_signal(rng, 4096 + 777, kind="mixed")
    buf = io.BytesIO()
    write_wav(buf, pcm, 44100, 16)
    flac = bytearray(encode_wav_bytes(buf.getvalue(), backend="golden"))
    p = tmp_path / "ok.flac"
    p.write_bytes(bytes(flac))
    assert main(["-t", str(p)]) == 0
    assert ": ok (" in capsys.readouterr().out

    bad = tmp_path / "badmd5.flac"
    corrupt = bytearray(flac)
    corrupt[26] ^= 0xFF  # flip a byte inside the STREAMINFO MD5 field
    bad.write_bytes(bytes(corrupt))
    assert main(["-t", str(bad)]) == 3

    garbage = tmp_path / "garbage.flac"
    garbage.write_bytes(b"not a flac stream at all")
    assert main(["-t", str(garbage)]) == 2


def test_cli_cuesheet_and_range(rng, tmp_path, capsys):
    """--cuesheet imports a .cue file as a CUESHEET block (round-trips
    through --list); --decode --range extracts a time slice via
    decode_range that matches the full decode's samples."""
    import io

    from zigflac_tpu.cli import main
    from zigflac_tpu.wav import WavReader, write_wav

    rate = 44100
    pcm = make_signal(rng, rate * 2 + 100, kind="mixed")
    wav_path = tmp_path / "in.wav"
    write_wav(str(wav_path), pcm, rate, 16)
    cue = tmp_path / "album.cue"
    cue.write_text(
        "CATALOG 1234567890123\n"
        "FILE \"in.wav\" WAVE\n"
        "  TRACK 01 AUDIO\n"
        "    INDEX 01 00:00:00\n"
        "  TRACK 02 AUDIO\n"
        "    INDEX 00 00:00:60\n"
        "    INDEX 01 00:01:00\n"
    )
    flac_path = tmp_path / "out.flac"
    rc = main([str(wav_path), str(flac_path), "--backend", "golden",
               "--cuesheet", str(cue), "--seek-interval", "0.5"])
    assert rc == 0
    assert main(["--list", str(flac_path)]) == 0
    out = capsys.readouterr().out
    assert "CUESHEET" in out and "3 tracks, catalog 1234567890123" in out

    # range decode: 0.5s..1.25s must equal the same slice of the input
    part = tmp_path / "part.wav"
    rc = main(["--decode", str(flac_path), str(part),
               "--range", "0.5:1.25", "--backend", "golden"])
    assert rc == 0
    got = WavReader.from_file(str(part)).planar_samples()
    lo, hi = int(0.5 * rate), int(0.5 * rate) + int(round(0.75 * rate))
    np.testing.assert_array_equal(got, pcm[:, lo:hi])

    # malformed range and malformed cue fail cleanly
    assert main(["--decode", str(flac_path), str(part),
                 "--range", "2:1"]) == 1
    badcue = tmp_path / "bad.cue"
    badcue.write_text("TRACK xx AUDIO\n")
    assert main([str(wav_path), str(flac_path), "--backend", "golden",
                 "--cuesheet", str(badcue)]) == 1
