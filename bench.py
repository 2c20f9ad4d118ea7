"""Headline benchmark: all five BASELINE.json configs in one JSON line.

The primary metric (value) is end-to-end wav2flac throughput of 16-bit /
44.1 kHz stereo PCM -> FLAC on the device backend (BASELINE.json config 1),
measured as x-realtime of input audio encoded per wall-clock second, WAV
bytes in -> valid FLAC bytes out (includes host WAV parse, MD5, and stream
assembly). It runs on a GPU only: without one it exits 1, and every result
names the device and the card's power limit.

``detail.configs`` carries every BASELINE config:
  1. 16/44.1 fixed-prediction encode  — e2e + device-only x-realtime
  2. 24-bit / 96 kHz hi-res encode    — e2e x-realtime + ratio
  3. LPC encode                       — e2e + device-only x-realtime
  4. batched multi-file encode        — e2e x-realtime over N fused WAVs
  5. decoder round-trip               — native-backend x-realtime + MD5

Compiled-shape budget: fixed-1024, fixed-tail, lpc-1024, hires24-1024 = 4
programs. Config 3's e2e and config 4 are sized to EXACTLY 1024-frame
batches so they reuse the already-compiled bucket programs.
"""

import io
import json
import os
import sys
import time

import numpy as np

BLOCK = 4096
BATCH_FRAMES = 1024


def make_wav_bytes(
    seconds: float | None,
    rate: int = 44100,
    depth: int = 16,
    n_samples: int | None = None,
    seed: int = 0xBEEF,
    channels: int = 2,
) -> bytes:
    """Seeded tonal-plus-noise PCM as WAV bytes: two sines under Gaussian
    noise, channel k scaled by 0.8**k, the same recipe at every depth."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from zigflac_tpu.wav import write_wav

    rng = np.random.default_rng(seed)
    n = n_samples if n_samples is not None else int(seconds * rate)
    t = np.arange(n)
    scale = 2.0 ** (depth - 16)  # same spectral recipe at every depth
    base = scale * (
        9000 * np.sin(2 * np.pi * 440 * t / rate)
        + 3000 * np.sin(2 * np.pi * 97 * t / rate)
    )
    noise = rng.normal(0, 120 * scale, size=(channels, n))
    x = np.stack([0.8**k * base + noise[k] for k in range(channels)])
    lim = float(1 << (depth - 1))
    samples = np.clip(np.round(x), -lim, lim - 1).astype(np.int64)
    buf = io.BytesIO()
    write_wav(buf, samples, rate, depth)
    return buf.getvalue()


def _best_e2e(encode, wav_bytes: bytes, seconds: float, reps: int):
    flac = encode(wav_bytes)  # warmup: compile + first run
    assert flac[:4] == b"fLaC"
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        flac = encode(wav_bytes)
        best = min(best, time.perf_counter() - t0)
    return seconds / best, flac, best


def _device_only_x(fn, batch, fns, N: int = 10):
    """Sustained batch throughput: N back-to-back executions amortized
    against ONE closing fetch."""
    import jax

    out = fn(batch, fns)
    jax.block_until_ready(out)
    np.asarray(out[1])
    dev_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        for _i in range(N):
            out = fn(batch, fns)
        np.asarray(out[1])
        dev_s = min(dev_s, (time.perf_counter() - t0) / N)
    return batch.shape[0] * BLOCK / 44100 / dev_s


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dataclasses import replace as _replace

    import subprocess

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX's device is {dev.platform!r}",
              file=sys.stderr)
        sys.exit(1)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    device = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": len(jax.devices()),
        "card": card,
    }
    print(json.dumps({"device": device}), file=sys.stderr)

    from zigflac_tpu.decoder import decode_flac
    from zigflac_tpu.models.encoder import encode_wav_bytes, encode_wav_bytes_many
    from zigflac_tpu.models.pipeline import _compiled_encode_compact
    from zigflac_tpu.utils.config import EncoderConfig
    from zigflac_tpu.wav import WavReader

    # ---- config 1: 16/44.1 fixed, end-to-end (the primary metric) ----
    # THREE 1024-frame batches + a ragged tail: the overlapped collection
    # pipelines batch k+1's h2d/compute with batch k's d2h, so the
    # sustained stream is the number a long encode sees. Same compiled
    # programs as any long encode (fixed-1024 + one tail shape).
    seconds = float(os.environ.get("BENCH_SECONDS", "285"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    wav_bytes = make_wav_bytes(seconds)
    x_realtime, flac, best = _best_e2e(
        lambda w: encode_wav_bytes(w, backend="device"), wav_bytes, seconds, reps
    )

    # transfer-budget accounting for one encode run: bytes shipped each way + fetch overshoot, from the pipeline's own
    # counters (models/pipeline.TRANSFER_STATS)
    from zigflac_tpu.models import pipeline as _pl

    _pl.reset_transfer_stats()
    t0 = time.perf_counter()
    encode_wav_bytes(wav_bytes, backend="device")
    budget_wall = time.perf_counter() - t0
    ts = dict(_pl.TRANSFER_STATS)
    transfer_budget = {
        "h2d_MB": round(ts["h2d_bytes"] / 1e6, 2),
        "d2h_MB": round(ts["d2h_bytes"] / 1e6, 2),
        "d2h_overshoot_pct": round(
            100 * ts["d2h_overshoot_bytes"] / max(ts["d2h_bytes"], 1), 2
        ),
        "wall_s": round(budget_wall, 3),
        "transfer_MBps": round(
            (ts["h2d_bytes"] + ts["d2h_bytes"]) / budget_wall / 1e6, 1
        ),
    }

    # ---- config 1 + 3 device-only: the batched encode program alone,
    # excluding host<->device transfers ----
    wav = WavReader.from_bytes(wav_bytes)
    samples = wav.planar_samples()
    nf = min(samples.shape[1] // BLOCK, BATCH_FRAMES)
    fr = samples[:, : nf * BLOCK].reshape(2, nf, BLOCK).transpose(1, 0, 2)
    if nf < BATCH_FRAMES:  # pad to the pipeline's bucket: no extra compiles
        fr = np.concatenate(
            [fr, np.repeat(fr[-1:], BATCH_FRAMES - nf, axis=0)], axis=0
        )
    batch = jnp.asarray(fr.astype(np.int16))
    fns = jnp.arange(batch.shape[0], dtype=jnp.int64)
    fixed_cfg = EncoderConfig.default(2)
    fn, _cap = _compiled_encode_compact(
        fixed_cfg, 16, 2, BLOCK, 44100, 0, batch.shape[0]
    )
    device_x = _device_only_x(fn, batch, fns)

    lpc_cfg = _replace(fixed_cfg, prediction="lpc")
    lfn, _lcap = _compiled_encode_compact(
        lpc_cfg, 16, 2, BLOCK, 44100, 0, batch.shape[0]
    )
    lpc_x = _device_only_x(lfn, batch, fns)

    # ---- config 3: LPC end-to-end (exactly 1024 frames -> reuses the
    # lpc-1024 program; no tail shape) ----
    lpc_n = BATCH_FRAMES * BLOCK
    lpc_seconds = lpc_n / 44100
    lpc_wav = make_wav_bytes(None, n_samples=lpc_n)
    lpc_e2e_x, lpc_flac, _ = _best_e2e(
        lambda w: encode_wav_bytes(w, config=lpc_cfg, backend="device"),
        lpc_wav, lpc_seconds, max(1, reps - 1),
    )

    # ---- config 2: 24-bit / 96 kHz hi-res, end-to-end (one new program:
    # hires24-1024) ----
    h_n = BATCH_FRAMES * BLOCK
    h_seconds = h_n / 96000
    h_wav = make_wav_bytes(None, rate=96000, depth=24, n_samples=h_n)
    h_e2e_x, h_flac, _ = _best_e2e(
        lambda w: encode_wav_bytes(w, backend="device"),
        h_wav, h_seconds, max(1, reps - 1),
    )

    # ---- config 4: batched multi-file encode (4 WAVs fused into shared
    # device batches; 256 frames each = 1024 total -> reuses fixed-1024) ----
    mf_each = (BATCH_FRAMES // 4) * BLOCK
    mf_wavs = [
        make_wav_bytes(None, n_samples=mf_each, seed=0xBEEF + i) for i in range(4)
    ]
    mf_seconds = 4 * mf_each / 44100
    mf_out = encode_wav_bytes_many(mf_wavs, backend="device")  # warmup
    mf_best = float("inf")
    for _ in range(max(1, reps - 1)):
        t0 = time.perf_counter()
        mf_out = encode_wav_bytes_many(mf_wavs, backend="device")
        mf_best = min(mf_best, time.perf_counter() - t0)
    assert all(f[:4] == b"fLaC" for f in mf_out)
    mf_x = mf_seconds / mf_best

    # ---- config 5: decoder round-trip on config 1's stream — the
    # flac2wav product path (fused C++ parse + IIR synthesis + container
    # serialization, no device transfers), timed file-to-file ----
    import tempfile

    from zigflac_tpu.decoder import decode_file

    with tempfile.TemporaryDirectory() as td:
        fp = os.path.join(td, "bench.flac")
        wp = os.path.join(td, "bench.wav")
        with open(fp, "wb") as f:
            f.write(flac)
        decode_file(fp, wp, backend="native")  # warmup
        d_best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            decode_file(fp, wp, backend="native")
            d_best = min(d_best, time.perf_counter() - t0)
        dec_x = seconds / d_best
        with open(wp, "rb") as f:
            roundtrip_ok = f.read() == wav_bytes
    # the API-level decode (samples + MD5) exercised once for the check
    dec = decode_flac(flac, backend="native")
    roundtrip_ok = roundtrip_ok and bool(dec.md5_ok)

    # ---- wide-symbol verify (on-card leg of the deposit prefix-sum
    # precision regression, tests/test_device_vs_golden.py
    # ::test_wide_rice_symbol_ragged_tail): a lone impulse over
    # near-silence in config 1's OWN ragged tail (same n -> same
    # compiled programs, no new shapes). The tail's ctz partition clamp
    # makes Rice beat escape on a ~1000-bit unary quotient; bf16-level
    # rounding in the matmul prefix sum would corrupt the stream and fail
    # MD5. (TF32 rounds only past 2048 bits: chip_smoke.py phase (g)
    # and tests/test_gpu.py cover that width.) ----
    n_total = int(seconds * 44100)
    tail = n_total % BLOCK
    ws = np.zeros((2, n_total), dtype=np.int64)
    if tail >= 64:
        base = n_total - tail
        ws[0, base + tail // 3] = 2000
        ws[1, base + (2 * tail) // 3] = -1500
    ws_buf = io.BytesIO()
    from zigflac_tpu.wav import write_wav

    write_wav(ws_buf, ws, 44100, 16)
    ws_flac = encode_wav_bytes(ws_buf.getvalue(), backend="device")
    ws_dec = decode_flac(ws_flac, backend="native")
    wide_symbol_ok = bool(ws_dec.md5_ok)

    pcm_bytes = seconds * 44100 * 2 * 2
    result = {
        "metric": "wav2flac 16-bit/44.1kHz stereo encode speed (device backend, end-to-end)",
        "value": round(x_realtime, 1),
        "unit": "x realtime",
        "device": device,
        "detail": {
            "wall_s": round(best, 4),
            "audio_s": seconds,
            "input_MBps": round(pcm_bytes / best / 1e6, 1),
            "flac_bytes": len(flac),
            "ratio": round(len(flac) / len(wav_bytes), 4),
            "device_only_x_realtime": round(device_x, 1),
            "lpc_device_only_x_realtime": round(lpc_x, 1),
            "transfer_budget": transfer_budget,
            "configs": {
                "1_fixed_16_44": {
                    "e2e_x_realtime": round(x_realtime, 1),
                    "device_only_x_realtime": round(device_x, 1),
                    "ratio": round(len(flac) / len(wav_bytes), 4),
                },
                "2_hires_24_96": {
                    "e2e_x_realtime": round(h_e2e_x, 1),
                    "ratio": round(len(h_flac) / len(h_wav), 4),
                },
                "3_lpc_16_44": {
                    "e2e_x_realtime": round(lpc_e2e_x, 1),
                    "device_only_x_realtime": round(lpc_x, 1),
                    "ratio": round(len(lpc_flac) / len(lpc_wav), 4),
                },
                "4_multifile_batch": {
                    "e2e_x_realtime": round(mf_x, 1),
                    "files": len(mf_wavs),
                    "audio_s": round(mf_seconds, 2),
                },
                "5_decode_roundtrip": {
                    "native_x_realtime": round(dec_x, 1),
                    "md5_ok": roundtrip_ok,
                },
                "wide_symbol_ok": wide_symbol_ok,
            },
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
