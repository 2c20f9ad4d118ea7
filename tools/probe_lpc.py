"""Per-stage timing of the LPC analysis path on the accelerator.

Attributes LPC mode's extra cost over fixed mode across the LPC
pipeline: lag sums -> integer Levinson + candidate selection -> LPC
residuals -> the extra Rice sweep. Cumulative jitted programs, each
ending in a tiny i32 reduction; N executions amortized against one
closing fetch.
"""
import sys, time
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from zigflac_tpu.ops.analyze import (
    MAX_RICE_PARAM_4BIT, best_fixed_order, residuals_for_order, rice_estimate,
)
from zigflac_tpu.ops.lpc import (
    fixed_point_levinson, lag_sums, lpc_candidate_orders, lpc_residuals,
    select_lpc_candidate,
)
from zigflac_tpu.utils.config import EncoderConfig
from zigflac_tpu.ops.analyze import plan_frames

B, n = 4096, 1024
cfg_f = EncoderConfig.default(2)
from dataclasses import replace
cfg_l = replace(cfg_f, prediction="lpc")
rate = 44100
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(2 * np.pi * 97 * t / rate)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
frames_np = np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int32)
batch = jnp.asarray(frames_np)
# the 4 stereo plane variants analyze_planes sees, flattened like production
M = np.stack([L.reshape(n, B), R.reshape(n, B),
              ((L.astype(np.int64) + R.astype(np.int64)) >> 1).reshape(n, B),
              (L.astype(np.int64) - R.astype(np.int64)).reshape(n, B)], 0)
planes_np = M.reshape(4 * n, B).astype(np.int32)
planes = jnp.asarray(planes_np)
orders = lpc_candidate_orders(cfg_l.lpc_order)
max_param = MAX_RICE_PARAM_4BIT


def red(x):
    return jnp.sum(jax.lax.bitcast_convert_type(x.astype(jnp.uint32), jnp.int32), dtype=jnp.int32)


@jax.jit
def p_fixedcore(pl):
    order, ok, _ = best_fixed_order(pl, False)
    res = residuals_for_order(pl, order)
    bits, method, po, params, uns = rice_estimate(
        res, order, B, cfg_f.max_rice_order, max_param,
        zz_bits=min(16 + 6, 32), speculate=True)
    return red(bits) + red(params) + red(res) + red(ok)


@jax.jit
def p_lags(pl):
    order, ok, _ = best_fixed_order(pl, False)
    res = residuals_for_order(pl, order)
    bits, method, po, params, uns = rice_estimate(
        res, order, B, cfg_f.max_rice_order, max_param,
        zz_bits=min(16 + 6, 32), speculate=True)
    lg = lag_sums(pl, cfg_l.lpc_order, 16)
    return red(bits) + red(params) + red(res) + red(ok) + red(lg.astype(jnp.int32))


@jax.jit
def p_lev(pl):
    order, ok, _ = best_fixed_order(pl, False)
    res = residuals_for_order(pl, order)
    bits, method, po, params, uns = rice_estimate(
        res, order, B, cfg_f.max_rice_order, max_param,
        zz_bits=min(16 + 6, 32), speculate=True)
    lg = lag_sums(pl, cfg_l.lpc_order, 16)
    pre = fixed_point_levinson(lg, orders, cfg_l.lpc_precision, jnp)
    lo, lq, lsh, lok = select_lpc_candidate(pre, B, cfg_l.lpc_precision, jnp)
    return red(bits) + red(res) + red(ok) + red(lo) + red(lq) + red(lsh) + red(lok)


@jax.jit
def p_lres(pl):
    order, ok, _ = best_fixed_order(pl, False)
    res = residuals_for_order(pl, order)
    bits, method, po, params, uns = rice_estimate(
        res, order, B, cfg_f.max_rice_order, max_param,
        zz_bits=min(16 + 6, 32), speculate=True)
    lg = lag_sums(pl, cfg_l.lpc_order, 16)
    pre = fixed_point_levinson(lg, orders, cfg_l.lpc_precision, jnp)
    lo, lq, lsh, lok = select_lpc_candidate(pre, B, cfg_l.lpc_precision, jnp)
    lr, lf = lpc_residuals(pl, lq, lsh, lo, cfg_l.lpc_order, jnp)
    return red(bits) + red(res) + red(ok) + red(lo) + red(lr) + red(lf)


@jax.jit
def p_lsweep(pl):
    order, ok, _ = best_fixed_order(pl, False)
    res = residuals_for_order(pl, order)
    bits, method, po, params, uns = rice_estimate(
        res, order, B, cfg_f.max_rice_order, max_param,
        zz_bits=min(16 + 6, 32), speculate=True)
    lg = lag_sums(pl, cfg_l.lpc_order, 16)
    pre = fixed_point_levinson(lg, orders, cfg_l.lpc_precision, jnp)
    lo, lq, lsh, lok = select_lpc_candidate(pre, B, cfg_l.lpc_precision, jnp)
    lr, lf = lpc_residuals(pl, lq, lsh, lo, cfg_l.lpc_order, jnp)
    lbits, lm, lpo, lpar, luns = rice_estimate(
        lr, lo, B, cfg_l.max_rice_order, max_param, speculate=True)
    return red(bits) + red(res) + red(lo) + red(lr) + red(lbits) + red(lpar)


@jax.jit
def p_plan_fixed(fr):
    plan = plan_frames(fr, 16, cfg_f)
    return red(plan.params) + red(plan.kind) + red(plan.order)


@jax.jit
def p_plan_lpc(fr):
    plan = plan_frames(fr, 16, cfg_l)
    return red(plan.params) + red(plan.kind) + red(plan.order)


def timeit(name, fn, *args, N=10):
    out = fn(*args); jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N):
            out = fn(*args)
        np.asarray(out)
        best = min(best, (time.perf_counter() - t0) / N)
    print(f"{name:14s} {best*1e3:8.2f} ms", flush=True)
    return best


print("device:", jax.devices()[0].platform, flush=True)
t0_ = timeit("fixed-core", p_fixedcore, planes)
t1_ = timeit("+lags", p_lags, planes)
t2_ = timeit("+levinson", p_lev, planes)
t3_ = timeit("+lpc-res", p_lres, planes)
t4_ = timeit("+lpc-sweep", p_lsweep, planes)
print(f"deltas: lags {1e3*(t1_-t0_):.2f}  levinson+sel {1e3*(t2_-t1_):.2f}  "
      f"lpc-res {1e3*(t3_-t2_):.2f}  lpc-sweep {1e3*(t4_-t3_):.2f}", flush=True)
tf = timeit("plan(fixed)", p_plan_fixed, batch)
tl = timeit("plan(lpc)", p_plan_lpc, batch)
print(f"full plan delta (lpc - fixed): {1e3*(tl-tf):.2f} ms", flush=True)
