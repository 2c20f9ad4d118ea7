"""Run the FLAC encode path on an NVIDIA GPU and check every result.

    python chip_smoke.py              # every phase, on one card
    python chip_smoke.py --cards 4    # only the 4-card mesh path and what
                                      # it is compared with

One process holds the card(s) throughout. JAX is pinned to the CUDA
platform before it is imported, so a machine without a card fails here
instead of running on the CPU. The C++ host runtime is rebuilt from
native/zf_native.cpp first (``python native/build.py``): a library copied
from another machine is never trusted.

Phases on one card, all through the public entry points with
``backend="device"`` on seeded WAVs (bench.make_wav_bytes):

  (a) config 1: a 285 s 16-bit/44.1 kHz stereo stream (three 1024-frame
      batches + a ragged tail) through encode_file (streaming) and
      encode_wav_bytes, fixed prediction
  (b) the same stream with LPC
  (c) 24-bit/96 kHz stereo, one full 1024-frame batch + tail
  (d) encode_wav_bytes_many over four 256-frame files
  (e) 32-bit stereo: the 33-bit side channel (i64 planes, u64 deposits)
  (f) one 8-channel 24-bit file
  (g) a lone impulse in a ragged tail, coded as one Rice symbol of 4001
      bits: TF32 rounding in the bit-offset prefix sum would corrupt it

Each phase times its first call (compilation included) apart from a warm
repeat, decodes the whole output with the native decoder (MD5 and samples
must match the input), and requires byte identity with
``backend="golden"`` over at least one full batch plus a ragged tail of 64
samples or more. Every comparison is exact. Then the deposit A/B (segsum
vs windowed on the config-1 and LPC 1024-frame batches, alternating A, B,
B, A) and the ``gpu``-marked tests run in this same process.

The last line of standard output is ``{"ok": true, "device": {...}}``, and
it is printed only when every phase passed; any failure exits 1.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

BLOCK = 4096
BATCH = 1024
STREAM_SECONDS = 285.0
RATE = 44100
WIDE_TAIL = 2047  # odd: one Rice partition, so the impulse stays one symbol
AB_ROUNDS = 6


def log(*parts) -> None:
    print(*parts, flush=True)


def card_lines() -> list:
    """The cards' names and power limits, from a child that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def open_cards(cards: int):
    """Pin JAX to CUDA, import it, and return the devices; exits 2 when
    the platform is not a GPU or the card count is wrong."""
    os.environ["JAX_PLATFORMS"] = "cuda"
    if cards == 1:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) != cards:
        log(f"error: need {cards} GPU device(s), JAX has {devices}")
        sys.exit(2)
    return devices


def build_native() -> None:
    subprocess.run([sys.executable, os.path.join(ROOT, "native", "build.py")],
                   check=True, cwd=ROOT, timeout=600)


# -- inputs and checks --------------------------------------------------------

def stream_samples() -> int:
    return int(STREAM_SECONDS * RATE)


def tail_len() -> int:
    """Config 1's ragged tail; golden prefixes reuse it, so they run the
    stream's own compiled programs."""
    return stream_samples() % BLOCK


def make_wav(n, rate=RATE, depth=16, channels=2, seed=0xBEEF) -> bytes:
    from bench import make_wav_bytes

    return make_wav_bytes(None, rate=rate, depth=depth, n_samples=n,
                          seed=seed, channels=channels)


def impulse_wav(n_full: int) -> bytes:
    """Silence with one impulse per channel in a WIDE_TAIL-sample tail."""
    from zigflac_tpu.wav import write_wav

    base = n_full * BLOCK
    x = np.zeros((2, base + WIDE_TAIL), np.int64)
    x[0, base + WIDE_TAIL // 3] = 2000
    x[1, base + (2 * WIDE_TAIL) // 3] = -1500
    buf = io.BytesIO()
    write_wav(buf, x, RATE, 16)
    return buf.getvalue()


def timed(fn):
    t = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t


def first_and_warm(fn):
    """Run ``fn`` twice: the first call compiles, the second is warm. Both
    outputs must be identical."""
    a, first = timed(fn)
    b, warm = timed(fn)
    if a != b:
        raise AssertionError("a warm repeat changed the output")
    return a, first, warm


def verify_decode(flac: bytes, wav: bytes) -> None:
    """The whole stream decodes with the native decoder, its MD5 checks,
    and its samples are the input's."""
    from zigflac_tpu.decoder import decode_flac
    from zigflac_tpu.wav import WavReader

    dec = decode_flac(flac, backend="native")
    if not dec.md5_ok:
        raise AssertionError("decoded MD5 does not match STREAMINFO")
    want = WavReader.from_bytes(wav).planar_samples()
    if not np.array_equal(dec.samples, want):
        raise AssertionError("decoded samples differ from the input")


def assert_same(device: bytes, golden: bytes, what: str) -> None:
    if device != golden:
        n = min(len(device), len(golden))
        at = next((i for i in range(n) if device[i] != golden[i]), n)
        raise AssertionError(
            f"{what}: device {len(device)} B != golden {len(golden)} B, "
            f"first difference at byte {at}"
        )


def golden_identity(wav: bytes, config=None, device: bytes | None = None):
    """Device bytes (given, or encoded now) == golden bytes of ``wav``.
    Returns the golden encode's seconds."""
    from zigflac_tpu.models.encoder import encode_wav_bytes

    if device is None:
        device = encode_wav_bytes(wav, config=config, backend="device")
    golden, secs = timed(
        lambda: encode_wav_bytes(wav, config=config, backend="golden")
    )
    assert_same(device, golden, "golden identity")
    return secs


def frames_of(n_samples: int) -> str:
    full, tail = divmod(n_samples, BLOCK)
    return f"{full} frames + {tail}-sample tail"


# -- phases -------------------------------------------------------------------

def phase_a(workdir):
    from zigflac_tpu.models.encoder import encode_file, encode_wav_bytes

    wav = make_wav(stream_samples())
    src = os.path.join(workdir, "config1.wav")
    dst = os.path.join(workdir, "config1.flac")
    with open(src, "wb") as f:
        f.write(wav)

    def streamed():
        encode_file(src, dst, backend="device")
        with open(dst, "rb") as f:
            return f.read()

    flac, first, warm = first_and_warm(streamed)
    mem, _, mem_warm = first_and_warm(
        lambda: encode_wav_bytes(wav, backend="device"))
    assert_same(flac, mem, "encode_file vs encode_wav_bytes")
    verify_decode(flac, wav)
    gold_s = golden_identity(make_wav(BATCH * BLOCK + tail_len()))
    return (f"{frames_of(stream_samples())}; encode_file first {first:.2f} s "
            f"warm {warm:.3f} s; encode_wav_bytes warm {mem_warm:.3f} s; "
            f"golden prefix {frames_of(BATCH * BLOCK + tail_len())} "
            f"in {gold_s:.1f} s")


def phase_b(_workdir):
    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.utils.config import EncoderConfig

    cfg = replace(EncoderConfig.default(2), prediction="lpc")
    wav = make_wav(stream_samples())
    flac, first, warm = first_and_warm(
        lambda: encode_wav_bytes(wav, config=cfg, backend="device"))
    verify_decode(flac, wav)
    gold_s = golden_identity(make_wav(BATCH * BLOCK + tail_len()), cfg)
    return (f"LPC {frames_of(stream_samples())}; first {first:.2f} s warm "
            f"{warm:.3f} s; golden prefix in {gold_s:.1f} s")


def _whole_file_phase(wav, label, config=None):
    from zigflac_tpu.models.encoder import encode_wav_bytes

    flac, first, warm = first_and_warm(
        lambda: encode_wav_bytes(wav, config=config, backend="device"))
    verify_decode(flac, wav)
    gold_s = golden_identity(wav, config, device=flac)
    return (f"{label}; first {first:.2f} s warm {warm:.3f} s; golden whole "
            f"file in {gold_s:.1f} s")


def phase_c(_workdir):
    n = BATCH * BLOCK + tail_len()
    return _whole_file_phase(make_wav(n, rate=96000, depth=24),
                             f"24-bit/96 kHz {frames_of(n)}")


def phase_d(_workdir):
    from zigflac_tpu.models.encoder import (
        encode_wav_bytes, encode_wav_bytes_many)

    n = (BATCH // 4) * BLOCK + tail_len()
    wavs = [make_wav(n, seed=0xBEEF + i) for i in range(4)]
    many, first, warm = first_and_warm(
        lambda: encode_wav_bytes_many(wavs, backend="device"))
    gold_s = 0.0
    for wav, flac in zip(wavs, many):
        verify_decode(flac, wav)
        golden, secs = timed(lambda: encode_wav_bytes(wav, backend="golden"))
        assert_same(flac, golden, "multi-file golden identity")
        gold_s += secs
    return (f"4 files x {frames_of(n)}; first {first:.2f} s warm "
            f"{warm:.3f} s; golden in {gold_s:.1f} s")


def phase_e(_workdir):
    n = 16 * BLOCK + tail_len()
    return _whole_file_phase(make_wav(n, depth=32),
                             f"32-bit stereo {frames_of(n)}")


def phase_f(_workdir):
    n = 64 * BLOCK + tail_len()
    return _whole_file_phase(
        make_wav(n, rate=48000, depth=24, channels=8),
        f"8-channel 24-bit/48 kHz {frames_of(n)}")


def phase_g(_workdir):
    return _whole_file_phase(
        impulse_wav(BATCH),
        f"impulse tail, {frames_of(BATCH * BLOCK + WIDE_TAIL)}")


def deposit_ab(_workdir):
    """segsum vs windowed on the config-1 and LPC 1024-frame batches: both
    programs built explicitly, byte-identical output required, timed
    A, B, B, A with block_until_ready around each run."""
    import jax
    import jax.numpy as jnp

    from zigflac_tpu.models.pipeline import (
        _compiled_encode_compact, _default_deposit)
    from zigflac_tpu.utils.config import EncoderConfig
    from zigflac_tpu.wav import WavReader

    samples = WavReader.from_bytes(make_wav(BATCH * BLOCK)).planar_samples()
    batch = jnp.asarray(
        samples.reshape(2, BATCH, BLOCK).transpose(1, 0, 2).astype(np.int16))
    fns = jnp.arange(BATCH, dtype=jnp.int64)
    lines = []
    for mode in ("fixed", "lpc"):
        cfg = replace(EncoderConfig.default(2), prediction=mode)
        progs, outs = {}, {}
        for dep in ("segsum", "windowed"):
            progs[dep] = _compiled_encode_compact(
                cfg, 16, 2, BLOCK, RATE, 0, BATCH, deposit=dep)[0]
            out, secs = timed(
                lambda: jax.block_until_ready(progs[dep](batch, fns)))
            outs[dep] = [np.asarray(o) for o in out]
            lines.append(f"{mode} {dep}: compile + first run {secs:.2f} s")
        (s0, m0), (s1, m1) = outs["segsum"], outs["windowed"]
        used = int(m0[-2])
        if m0[-1] or m1[-1]:
            raise AssertionError(f"{mode}: a deposit path flagged overflow")
        if not (np.array_equal(m0, m1)
                and np.array_equal(s0[:used], s1[:used])):
            raise AssertionError(f"{mode}: segsum and windowed words differ")
        times = {"segsum": [], "windowed": []}
        for _ in range(AB_ROUNDS):
            for dep in ("segsum", "windowed", "windowed", "segsum"):
                _, secs = timed(
                    lambda: jax.block_until_ready(progs[dep](batch, fns)))
                times[dep].append(secs * 1e3)
        for dep, ts in times.items():
            lines.append(
                f"{mode} {dep}: median {np.median(ts):.3f} ms, min "
                f"{min(ts):.3f} ms per {BATCH}-frame batch "
                f"({len(ts)} runs)")
        if mode == "fixed":
            mem = progs[_default_deposit()].lower(batch, fns).compile()
            lines.append(f"memory_analysis (fixed, {BATCH} frames, default "
                         f"deposit): {mem.memory_analysis()}")
    lines.append(f"default deposit on this platform: {_default_deposit()}")
    return "\n    ".join(lines)


def gpu_tests(_workdir):
    """The gpu-marked tests, in this process (a child would open the card
    a second time)."""
    import pytest

    rc = pytest.main([
        os.path.join(ROOT, "tests", "test_gpu.py"), "-q", "-m", "gpu",
        "-p", "no:cacheprovider", "-p", "no:randomly",
    ])
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (pytest exit {rc})")
    return "gpu-marked tests passed"


# -- four cards -----------------------------------------------------------------

def four_card_mesh(_workdir):
    """The default multi-card path: DevicePipeline shards the frame axis
    over every local card. Config 1 and a ragged batch whose last shard
    overflows tier 0 are compared with a one-card run (ZIGFLAC_MESH=0) in
    this process, and with golden on a prefix."""
    import jax

    from zigflac_tpu.models import pipeline
    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.wav import WavReader, write_wav

    ndev = len(jax.devices())
    wav = make_wav(stream_samples())
    # ragged: the pipeline pads nf frames to the BATCH bucket, so the last
    # shard holds padding rows; its 7/8 real frames are full-scale noise,
    # which out-sizes that shard's tier-0 stream budget (3/4 of its raw
    # PCM) while the other shards stay within theirs
    per_shard = BATCH // ndev
    nf = BATCH - max(1, per_shard // 8)
    x = WavReader.from_bytes(make_wav(nf * BLOCK, seed=11)).planar_samples()
    x = x.astype(np.int64)
    noisy = (ndev - 1) * per_shard * BLOCK
    x[:, noisy:] = np.random.default_rng(11).integers(
        -32768, 32768, size=(2, x.shape[1] - noisy))
    buf = io.BytesIO()
    write_wav(buf, x, RATE, 16)
    ragged = buf.getvalue()

    calls = []
    real = pipeline.DevicePipeline._encode_overflow

    def spy(self, chunk, *rest):
        calls.append(chunk.shape[0])
        return real(self, chunk, *rest)

    pipeline.DevicePipeline._encode_overflow = spy
    try:
        mesh_c1, first, warm = first_and_warm(
            lambda: encode_wav_bytes(wav, backend="device"))
        calls.clear()
        mesh_rg, rg_first, _ = first_and_warm(
            lambda: encode_wav_bytes(ragged, backend="device"))
    finally:
        pipeline.DevicePipeline._encode_overflow = real
    if not calls or any(c != per_shard for c in calls):
        raise AssertionError(f"ladder re-encodes {calls}: expected only the "
                             f"overflowing {per_shard}-frame shard")
    verify_decode(mesh_c1, wav)
    verify_decode(mesh_rg, ragged)

    prior = os.environ.get("ZIGFLAC_MESH")
    os.environ["ZIGFLAC_MESH"] = "0"
    try:
        one_c1, one_first, one_warm = first_and_warm(
            lambda: encode_wav_bytes(wav, backend="device"))
        one_rg = encode_wav_bytes(ragged, backend="device")
    finally:
        if prior is None:
            del os.environ["ZIGFLAC_MESH"]
        else:
            os.environ["ZIGFLAC_MESH"] = prior
    assert_same(mesh_c1, one_c1, "config 1: 4-card mesh vs one card")
    assert_same(mesh_rg, one_rg, "ragged overflow: 4-card mesh vs one card")
    gold_s = golden_identity(make_wav(BATCH * BLOCK + tail_len()))
    gold_s += golden_identity(ragged, device=mesh_rg)
    return (f"{ndev}-card mesh: config 1 first {first:.2f} s warm "
            f"{warm:.3f} s; one card first {one_first:.2f} s warm "
            f"{one_warm:.3f} s; ragged {nf} frames with an overflowing last "
            f"shard (first {rg_first:.2f} s, ladder re-encodes {calls}); "
            f"both byte-identical to one card, golden in {gold_s:.1f} s")


ONE_CARD = [
    ("a config 1 fixed", phase_a),
    ("b config 1 LPC", phase_b),
    ("c 24/96", phase_c),
    ("d multi-file", phase_d),
    ("e 32-bit", phase_e),
    ("f 8-channel", phase_f),
    ("g wide symbol", phase_g),
    ("deposit A/B", deposit_ab),
    ("gpu tests", gpu_tests),
]
FOUR_CARDS = [("4-card mesh", four_card_mesh)]


def run_phases(phases) -> list:
    """Run every phase; returns the names of those that failed."""
    failed = []
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as wd:
        for name, fn in phases:
            t = time.perf_counter()
            try:
                msg = fn(wd)
            except Exception:
                failed.append(name)
                log(f"FAIL {name} after {time.perf_counter() - t:.1f} s")
                log(traceback.format_exc())
                continue
            log(f"PASS {name} in {time.perf_counter() - t:.1f} s: {msg}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4 runs only the 4-card mesh path and its "
                         "comparison")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    devices = open_cards(args.cards)
    build_native()
    sys.path.insert(0, ROOT)
    import jax

    from zigflac_tpu import native

    for line in card_lines():
        log(line)
    log(f"device_kind: {devices[0].device_kind}; devices: {len(devices)}; "
        f"jax {jax.__version__}")
    log(f"_zf_native loaded: {native.HAVE_NATIVE}"
        + (f" ({native._n.__file__})" if native.HAVE_NATIVE else ""))
    if not native.HAVE_NATIVE:
        log("FAIL: the native host runtime did not load")
        return 1
    failed = run_phases(ONE_CARD if args.cards == 1 else FOUR_CARDS)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failed:
        log(f"FAILED phases: {', '.join(failed)}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
