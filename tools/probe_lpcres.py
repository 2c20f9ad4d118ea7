"""A/B the two lpc_residuals forms in ONE process on the accelerator.

Form A (i64 signal copy): s = planes.astype(i64) once, taps pad/shift s.
Form B (narrow taps): taps pad/shift the native i32 planes and widen
inside the multiply. Cross-run numbers are not comparable (CLAUDE.md) —
this probe times A/B/A back-to-back.
"""
import sys, time
import os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from zigflac_tpu.ops.lpc import (
    fixed_point_levinson, lag_sums, lpc_candidate_orders,
    select_lpc_candidate,
)
from zigflac_tpu.utils.config import EncoderConfig

B, n = 4096, 1024
cfg = EncoderConfig.default(2)
from dataclasses import replace
cfg = replace(cfg, prediction="lpc")
rng = np.random.default_rng(0xBEEF)
rate = 44100
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(2 * np.pi * 97 * t / rate)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
M = np.stack([L.reshape(n, B), R.reshape(n, B),
              ((L.astype(np.int64) + R.astype(np.int64)) >> 1).reshape(n, B),
              (L.astype(np.int64) - R.astype(np.int64)).reshape(n, B)], 0)
planes = jnp.asarray(M.reshape(4 * n, B).astype(np.int32))
orders = lpc_candidate_orders(cfg.lpc_order)
MAXO = cfg.lpc_order


def red(x):
    return jnp.sum(jax.lax.bitcast_convert_type(x.astype(jnp.uint32), jnp.int32), dtype=jnp.int32)


def prefix(pl):
    lg = lag_sums(pl, MAXO, 16)
    pre = fixed_point_levinson(lg, orders, cfg.lpc_precision, jnp)
    return select_lpc_candidate(pre, B, cfg.lpc_precision, jnp)


def res_wide(pl, qc, shift, order):
    s = pl.astype(jnp.int64)
    pred = jnp.zeros_like(s)
    for j in range(MAXO):
        sh = jnp.pad(s, [(0, 0)] * (s.ndim - 1) + [(j + 1, 0)])[..., :B]
        pred = pred + qc[..., j : j + 1].astype(jnp.int64) * sh
    pred = pred >> shift[..., None].astype(jnp.int64)
    res = s - pred
    idx = jax.lax.broadcasted_iota(jnp.int32, pl.shape, pl.ndim - 1)
    res = jnp.where(idx < order[..., None], 0, res)
    return res.astype(jnp.int32)


def res_narrow(pl, qc, shift, order):
    pred = jnp.zeros(pl.shape, dtype=jnp.int64)
    for j in range(MAXO):
        sh = jnp.pad(pl, [(0, 0)] * (pl.ndim - 1) + [(j + 1, 0)])[..., :B]
        pred = pred + qc[..., j : j + 1].astype(jnp.int64) * sh.astype(jnp.int64)
    pred = pred >> shift[..., None].astype(jnp.int64)
    res = pl.astype(jnp.int64) - pred
    idx = jax.lax.broadcasted_iota(jnp.int32, pl.shape, pl.ndim - 1)
    res = jnp.where(idx < order[..., None], 0, res)
    return res.astype(jnp.int32)


@jax.jit
def p_base(pl):
    lo, lq, lsh, lok = prefix(pl)
    return red(lo) + red(lq) + red(lsh)


@jax.jit
def p_wide(pl):
    lo, lq, lsh, lok = prefix(pl)
    return red(res_wide(pl, lq, lsh, lo)) + red(lo)


@jax.jit
def p_narrow(pl):
    lo, lq, lsh, lok = prefix(pl)
    return red(res_narrow(pl, lq, lsh, lo)) + red(lo)


def timeit(name, fn, *args, N=10):
    out = fn(*args); jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N):
            out = fn(*args)
        np.asarray(out)
        best = min(best, (time.perf_counter() - t0) / N)
    print(f"{name:10s} {best*1e3:8.2f} ms", flush=True)
    return best


print("device:", jax.devices()[0].platform, flush=True)
tb = timeit("base", p_base, planes)
tw1 = timeit("wide", p_wide, planes)
tn = timeit("narrow", p_narrow, planes)
tw2 = timeit("wide(2)", p_wide, planes)
print(f"deltas over base: wide {1e3*(min(tw1,tw2)-tb):.2f}  narrow {1e3*(tn-tb):.2f}", flush=True)
