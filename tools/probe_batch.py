"""Device-only throughput vs batch size on the accelerator.

Measures the production compact encode program (16-bit/44.1 kHz stereo,
tier 0) at one or more frame-batch sizes, N=10 executions amortized
against one closing fetch. Sizes models/pipeline.DEFAULT_BATCH: per-batch
overhead that is not device work amortizes over larger buckets.

Usage: python tools/probe_batch.py [sizes...]   (default: 1024 2048)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from zigflac_tpu.models.pipeline import _compiled_encode_compact
from zigflac_tpu.utils.config import EncoderConfig

B, rate = 4096, 44100
sizes = [int(a) for a in sys.argv[1:]] or [1024, 2048]
nmax = max(sizes)
rng = np.random.default_rng(0xBEEF)
t = np.arange(nmax * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(2 * np.pi * 97 * t / rate)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
frames_np = np.stack([L.reshape(nmax, B), R.reshape(nmax, B)], axis=1).astype(np.int16)
cfg = EncoderConfig.default(2)

for n in sizes:
    batch = jnp.asarray(frames_np[:n])
    fns = jnp.arange(n, dtype=jnp.int64)
    t0 = time.perf_counter()
    fn, _cap = _compiled_encode_compact(cfg, 16, 2, B, rate, 0, n)
    out = fn(batch, fns)
    jax.block_until_ready(out)
    np.asarray(out[1])
    print(f"n={n}: compile+first {time.perf_counter() - t0:.1f}s", flush=True)
    N = 10
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _i in range(N):
            out = fn(batch, fns)
        np.asarray(out[1])
        best = min(best, (time.perf_counter() - t0) / N)
    x = n * B / rate / best
    print(f"n={n}: {best*1e3:.2f} ms/batch  {x:,.0f}x realtime", flush=True)
