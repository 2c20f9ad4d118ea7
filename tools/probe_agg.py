"""A/B the aggregate-u32 rice-sweep proof on the accelerator (one process).

Variant A = head (agg_proven_rows: the 16-bit fixed rows sweep every rice
level in u32 by the argmin aggregate bound — no u64 leg, no detector).
Variant B = the sweep without the proof, reproduced by stripping the agg kwarg before
rice_estimate so the proof never engages. Both variants compile the full
production compact program (fixed AND lpc configs) in this process and
interleave N=10-execution measurements A/B/A/B (CLAUDE.md: numbers from
different processes are not comparable).

Usage: python tools/probe_agg.py [nreps]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

import zigflac_tpu.ops.analyze as an
from zigflac_tpu.models.pipeline import _compiled_encode_compact
from zigflac_tpu.utils.config import EncoderConfig

B, rate, n = 4096, 44100, 1024
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(
    2 * np.pi * 97 * t / rate
)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
frames = jnp.asarray(
    np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int16)
)
fns = jnp.arange(n, dtype=jnp.int64)

orig_rice = an.rice_estimate


def rice_no_agg(*a, **k):
    k.pop("agg_proven_rows", None)
    return orig_rice(*a, **k)


def build(mode: str, agg: bool):
    an.rice_estimate = orig_rice if agg else rice_no_agg
    try:
        cfg = EncoderConfig.default(2)
        if mode == "lpc":
            from dataclasses import replace

            cfg = replace(cfg, prediction="lpc")
        _compiled_encode_compact.cache_clear()
        t0 = time.perf_counter()
        fn, _cap = _compiled_encode_compact(cfg, 16, 2, B, rate, 0, n)
        out = fn(frames, fns)
        jax.block_until_ready(out)
        ref = np.asarray(out[1])
        print(f"{mode} agg={agg}: compile+first "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return fn, ref
    finally:
        an.rice_estimate = orig_rice


def measure(fn, N=10):
    t0 = time.perf_counter()
    for _ in range(N):
        out = fn(frames, fns)
    np.asarray(out[1])
    return (time.perf_counter() - t0) / N


nreps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
for mode in ("fixed", "lpc"):
    fa, ra = build(mode, True)
    fb, rb = build(mode, False)
    assert (ra == rb).all(), f"{mode}: agg variant changed the metadata!"
    rows = []
    for r in range(nreps):
        a = measure(fa)
        b = measure(fb)
        rows.append((a, b))
        print(f"{mode} rep{r}: agg {a*1e3:.2f} ms  no-agg {b*1e3:.2f} ms",
              flush=True)
    ba, bb = min(r[0] for r in rows), min(r[1] for r in rows)
    x = n * B / rate
    print(f"{mode}: BEST agg {ba*1e3:.2f} ms ({x/ba:,.0f}x)  "
          f"no-agg {bb*1e3:.2f} ms ({x/bb:,.0f}x)", flush=True)
