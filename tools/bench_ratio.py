"""Compression-ratio benchmark vs canonical libFLAC presets (the BASELINE
quality axis).

Encodes three content classes (tonal+noise music-like, AR-filtered
speech-like, dense music-like) with this framework's fixed and LPC modes
and with the CANONICAL Xiph libFLAC (via the vendored libsndfile,
utils/sndfile.py) at presets 0 / 5 / 8, then prints a ratio table.

Preset geometry notes (flac(1) / libFLAC stream_encoder.c):
  -0: block 1152, fixed-only-ish (adaptive mid-side, no LPC)
  -5: block 4096, LPC order 8, one apodization window (tukey 0.5)
  -8: block 4096, LPC order 12, multiple apodization windows
Our modes use block 4096 throughout (the reference's only geometry,
libFLAC/Encoder.zig:472-480); ratios are FLAC stream bytes / raw PCM
bytes so container overheads (both sides write a small metadata head)
wash out at these stream lengths.

Runs entirely on host CPU (forces JAX cpu; the device pipeline is
byte-identical across backends by the suite's bit-exactness invariant).

Usage: python tools/bench_ratio.py [seconds per class, default 30]
"""

import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RATE = 44100
DEPTH = 16


def tonal_noise(n: int, seed: int = 0xBEEF) -> np.ndarray:
    """bench.py's recipe: two tones + noise, stereo-correlated."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    base = 9000 * np.sin(2 * np.pi * 440 * t / RATE) + 3000 * np.sin(
        2 * np.pi * 97 * t / RATE
    )
    noise = rng.normal(0, 120, size=(2, n))
    return np.stack([base + noise[0], 0.8 * base + noise[1]])


def speech_like(n: int, seed: int = 5) -> np.ndarray:
    """AR(2)-filtered excitation bursts with gaps (pitch-pulse train +
    noise floor) — formant-ish spectra that LPC models well."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    e = rng.normal(0, 600, size=(2, n))
    pulses = np.zeros(n)
    pulses[:: RATE // 160] = 6000  # ~160 Hz pitch pulses
    e += pulses
    gate = (np.arange(n) // (RATE // 4)) % 4 != 3  # 750ms voiced, 250ms gap
    e *= gate
    return lfilter([1.0], [1.0, -1.6, 0.68], e, axis=-1)


def dense_music(n: int, seed: int = 11) -> np.ndarray:
    """Dense music-like: harmonic stack with vibrato + AM + broadband
    percussion bursts + pink-ish noise bed."""
    from scipy.signal import lfilter

    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = np.zeros((2, n))
    for f0, amp in ((220.0, 4000), (277.2, 2500), (329.6, 2000)):
        vib = f0 * (1 + 0.002 * np.sin(2 * np.pi * 5.1 * t))
        ph = 2 * np.pi * np.cumsum(vib) / RATE
        for h in range(1, 6):
            x[0] += amp / h * np.sin(h * ph)
            x[1] += amp / h * np.sin(h * ph + 0.1 * h)
    am = 0.6 + 0.4 * np.sin(2 * np.pi * 1.7 * t)
    x *= am
    # percussion: exponentially decaying noise bursts every ~0.5 s
    perc = rng.normal(0, 1, size=(2, n))
    env = np.zeros(n)
    period = RATE // 2
    idx = np.arange(n) % period
    env = 2500 * np.exp(-idx / (0.03 * RATE))
    x += perc * env
    # pink-ish bed
    bed = lfilter([1.0], [1.0, -0.95], rng.normal(0, 40, size=(2, n)), axis=-1)
    return x + bed


def clip16(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), -32768, 32767).astype(np.int64)


def main() -> None:
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 30.0
    n = int(seconds * RATE)

    import jax

    jax.config.update("jax_platforms", "cpu")

    from dataclasses import replace

    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.utils import sndfile
    from zigflac_tpu.utils.config import EncoderConfig
    from zigflac_tpu.wav import write_wav

    if not sndfile.available():
        print("libsndfile unavailable — no canonical side", file=sys.stderr)
        sys.exit(1)

    classes = {
        "tonal_noise": clip16(tonal_noise(n)),
        "speech_like": clip16(speech_like(n)),
        "dense_music": clip16(dense_music(n)),
    }

    fixed_cfg = EncoderConfig.default(2)
    ours = {
        "fixed": fixed_cfg,
        "lpc8": replace(fixed_cfg, prediction="lpc", lpc_order=8),
        "lpc12": replace(fixed_cfg, prediction="lpc", lpc_order=12),
    }

    results = {}
    for name, pcm in classes.items():
        raw = pcm.size * 2  # bytes of 16-bit PCM
        buf = io.BytesIO()
        write_wav(buf, pcm, RATE, DEPTH)
        wav_bytes = buf.getvalue()
        row = {"raw_bytes": raw}
        for mode, cfg in ours.items():
            flac = encode_wav_bytes(wav_bytes, config=cfg, backend="device")
            row[f"ours_{mode}"] = round(len(flac) / raw, 4)
        for level in (0, 5, 8):
            ref = sndfile.encode_flac(
                pcm.astype(np.int32), RATE, DEPTH, compression_level=level
            )
            row[f"libflac_{level}"] = round(len(ref) / raw, 4)
        results[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)

    # summary: our best LPC vs -8, our fixed vs -0
    print("\n| class | ours fixed | ours lpc8 | ours lpc12 | "
          "flac -0 | flac -5 | flac -8 | lpc8 vs -8 |")
    print("|---|---|---|---|---|---|---|---|")
    for name, r in results.items():
        delta = (r["ours_lpc8"] - r["libflac_8"]) / r["libflac_8"] * 100
        print(
            f"| {name} | {r['ours_fixed']} | {r['ours_lpc8']} | "
            f"{r['ours_lpc12']} | {r['libflac_0']} | {r['libflac_5']} | "
            f"{r['libflac_8']} | {delta:+.2f}% |"
        )


if __name__ == "__main__":
    main()
