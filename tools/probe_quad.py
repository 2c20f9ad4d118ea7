"""A/B: quad-merged vs pair-merged windowed deposits on the accelerator.

Alternates the two variants back-to-back in one process (the only valid
comparison — see CLAUDE.md), full production
program (16-bit stereo, tier 0, batch 1024), N=10 executions amortized.
"""
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from zigflac_tpu.models.pipeline import (
    CAPACITY_LADDER, _encode_batch_compact,
)
from zigflac_tpu.ops.bitpack import ALIGN_W, max_frame_words
from zigflac_tpu.ops.header import header_static
from zigflac_tpu.utils.config import EncoderConfig

B, rate, n = 4096, 44100, 1024
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(2 * np.pi * 97 * t / rate)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
batch = jnp.asarray(
    np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int16)
)
fns = jnp.arange(n, dtype=jnp.int64)
cfg = EncoderConfig.default(2)
hstatic = header_static(B, rate, 16)
stream_ratio, words_ratio = CAPACITY_LADDER[0]
max_words = max_frame_words(B, 2, 16, words_ratio)
raw = n * B * 2 * 2
capb = int(raw * stream_ratio) + (4 * ALIGN_W + 32) * n

fns_by_mode = {}
for mode in ("windowed", "windowed_pair"):
    fns_by_mode[mode] = jax.jit(
        partial(
            _encode_batch_compact, config=cfg, depth=16, hstatic=hstatic,
            block_size=B, max_words=max_words, capb=capb, deposit=mode,
            speculate=True,
        )
    )
    t0 = time.perf_counter()
    out = fns_by_mode[mode](batch, fns)
    jax.block_until_ready(out)
    ref = np.asarray(out[1])
    print(f"{mode}: compile+first {time.perf_counter()-t0:.1f}s "
          f"overflow={ref[-1]}", flush=True)

results = {m: [] for m in fns_by_mode}
N = 10
for rep in range(3):
    for mode, fn in fns_by_mode.items():
        t0 = time.perf_counter()
        for _ in range(N):
            out = fn(batch, fns)
        np.asarray(out[1])
        dt = (time.perf_counter() - t0) / N
        results[mode].append(dt)
        print(f"rep{rep} {mode}: {dt*1e3:.2f} ms/batch "
              f"({n*B/rate/dt:,.0f}x)", flush=True)
for mode, ds in results.items():
    best = min(ds)
    print(f"BEST {mode}: {best*1e3:.2f} ms  {n*B/rate/best:,.0f}x")
