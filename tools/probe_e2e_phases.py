"""Per-phase e2e budget on the accelerator + fetch-strategy A/B + the
two-batch pipelining check — one process, so compiles amortize and the
comparisons are back-to-back (CLAUDE.md).

Phases measured for the 95 s config-1 encode:
  parse    WavReader.from_bytes + planar_samples (native de-interleave)
  prep     [C,n] -> [N,C,B] transpose + int16 feed copy
  h2d+comp dispatch + block_until_ready on the batch outputs
  md5      native MD5 over the raw 16.8 MB PCM byte stream
  collect  meta + page fetches + host assembly

Usage: python tools/probe_e2e_phases.py [reps]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3

    import jax

    from bench import make_wav_bytes
    from zigflac_tpu import native
    from zigflac_tpu.metadata import StreamInfo  # noqa: F401
    from zigflac_tpu.models.encoder import encode_wav_bytes
    from zigflac_tpu.models.pipeline import DevicePipeline
    from zigflac_tpu.utils.config import EncoderConfig
    from zigflac_tpu.wav import WavReader

    seconds = 95.0
    wav_bytes = make_wav_bytes(seconds)
    t0 = time.perf_counter()
    flac = encode_wav_bytes(wav_bytes, backend="device")
    print(f"warmup (compiles): {time.perf_counter() - t0:.1f}s "
          f"flac={len(flac)}", flush=True)

    # -- phase breakdown (one representative pass) --
    for _ in range(2):
        t0 = time.perf_counter()
        wav = WavReader.from_bytes(wav_bytes)
        samples = wav.planar_samples()
        raw = bytes(wav.raw_pcm_bytes())
        t_parse = time.perf_counter() - t0

        cfg = EncoderConfig.default(2)
        info = wav.flac_streaminfo(cfg.block_size)
        pipe = DevicePipeline(cfg, 16)
        c, n = samples.shape
        B = cfg.block_size
        nf = n // B
        t0 = time.perf_counter()
        batch = samples[:, : nf * B].reshape(c, nf, B).transpose(1, 0, 2)
        fns = np.arange(nf, dtype=np.int64)
        t_prep = time.perf_counter() - t0

        t0 = time.perf_counter()
        rec = pipe.dispatch_batch(batch, fns, info)
        trec = pipe.dispatch_tail(samples[:, nf * B:], nf, info)
        t_dispatch = time.perf_counter() - t0
        t0 = time.perf_counter()
        md5 = native.md5(raw)
        t_md5 = time.perf_counter() - t0
        t0 = time.perf_counter()
        jax.block_until_ready(rec["out"][0])
        t_compute = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = pipe.collect_batch(rec, info)
        tgot = pipe.collect_batch(trec, info)
        t_collect = time.perf_counter() - t0
        total = t_parse + t_prep + t_dispatch + t_md5 + t_compute + t_collect
        print(
            f"phases: parse={t_parse:.3f} prep={t_prep:.3f} "
            f"dispatch={t_dispatch:.3f} md5(ovl)={t_md5:.3f} "
            f"h2d+comp_wait={t_compute:.3f} collect={t_collect:.3f} "
            f"sum={total:.3f}s bytes={len(got[0]) + len(tgot[0])}",
            flush=True,
        )
        del md5

    # -- fetch A/B at head (md5 overlap + dyn tail pages active) --
    results = {}
    for mode in ("seq", "ovl") * reps:
        os.environ["ZIGFLAC_FETCH_SEQ"] = "1" if mode == "seq" else "0"
        t0 = time.perf_counter()
        f2 = encode_wav_bytes(wav_bytes, backend="device")
        dt = time.perf_counter() - t0
        assert f2 == flac
        results.setdefault(mode, []).append(dt)
        print(f"{mode}: {dt:.3f}s {seconds / dt:7.1f}x RT", flush=True)
    os.environ["ZIGFLAC_FETCH_SEQ"] = "0"
    for mode, ts in results.items():
        print(f"best {mode}: {min(ts):.3f}s {seconds / min(ts):7.1f}x RT")

    # -- two-batch stream (same tail length -> same compiled programs):
    # batch 2's h2d/compute overlaps batch 1's d2h --
    n1 = int(seconds * 44100)
    tail_n = n1 - (n1 // 4096) * 4096
    n2 = 2046 * 4096 + tail_n
    sec2 = n2 / 44100
    wav2 = make_wav_bytes(None, n_samples=n2)
    f2 = encode_wav_bytes(wav2, backend="device")  # warm (no new compiles)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        encode_wav_bytes(wav2, backend="device")
        best = min(best, time.perf_counter() - t0)
    print(f"two-batch {sec2:.1f}s audio: {best:.3f}s "
          f"{sec2 / best:7.1f}x RT (vs single-batch best "
          f"{seconds / min(results['ovl']):.1f})")


if __name__ == "__main__":
    main()
