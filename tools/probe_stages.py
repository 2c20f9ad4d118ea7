"""Serial per-stage timing of the compact encode program on the accelerator.

Run ALONE (no other process on the card). Each probe is its own jitted
program ending in a tiny i32 reduction so the d2h fetch is negligible;
N executions amortized against one closing fetch.
"""
import sys, time
sys.path.insert(0, __import__("os").path.dirname(__import__("os").path.dirname(__import__("os").path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from zigflac_tpu.ops.analyze import plan_frames
from zigflac_tpu.ops.bitpack import (
    frame_symbol_stream, deposit_stream_windowed, compact_stream_aligned,
    deposit_crc16, max_frame_words,
)
from zigflac_tpu.ops.crc16 import crc16_words
from zigflac_tpu.ops.header import header_static
from zigflac_tpu.utils.config import EncoderConfig

B, n = 4096, 1024
cfg = EncoderConfig.default(2)
rate = 44100
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(2 * np.pi * 97 * t / rate)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
frames_np = np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int32)
batch = jnp.asarray(frames_np)
fns = jnp.arange(n, dtype=jnp.int64)
hs = header_static(B, rate, 16)
W = max_frame_words(B, 2, 16)
capb = 4 * ((W * n) // 8)  # generous

def red(x):
    return jnp.sum(jax.lax.bitcast_convert_type(x.astype(jnp.uint32), jnp.int32), dtype=jnp.int32)

@jax.jit
def p_plan(fr):
    plan = plan_frames(fr, 16, cfg)
    return (red(plan.params) + red(plan.residuals.astype(jnp.int32).sum(axis=(2,))) +
            red(plan.kind) + red(plan.order))

@jax.jit
def p_symbols(fr, f):
    plan = plan_frames(fr, 16, cfg)
    dep_cum, total_bits, parts, nbv = frame_symbol_stream(plan, f, hs, B, cfg.max_rice_order)
    acc = red(dep_cum) + red(total_bits) + red(nbv)
    for v in parts:
        acc = acc + red(v.astype(jnp.uint32))
    return acc

@jax.jit
def p_deposit(fr, f):
    plan = plan_frames(fr, 16, cfg)
    dep_cum, total_bits, parts, nbv = frame_symbol_stream(plan, f, hs, B, cfg.max_rice_order)
    dep_val = jnp.concatenate([v.astype(jnp.uint64) for v in parts], axis=1)
    words, ovf = deposit_stream_windowed(dep_cum, dep_val, nbv, W, chunk=128, win_rows=8, row_words=32)
    return red(words) + red(total_bits)

@jax.jit
def p_crc(fr, f):
    plan = plan_frames(fr, 16, cfg)
    dep_cum, total_bits, parts, nbv = frame_symbol_stream(plan, f, hs, B, cfg.max_rice_order)
    dep_val = jnp.concatenate([v.astype(jnp.uint64) for v in parts], axis=1)
    words, ovf = deposit_stream_windowed(dep_cum, dep_val, nbv, W, chunk=128, win_rows=8, row_words=32)
    byte_len = (total_bits + 7) >> 3
    crcs = crc16_words(words, byte_len)
    words = deposit_crc16(words, byte_len, crcs)
    return red(words)

@jax.jit
def p_full(fr, f):
    plan = plan_frames(fr, 16, cfg)
    dep_cum, total_bits, parts, nbv = frame_symbol_stream(plan, f, hs, B, cfg.max_rice_order)
    dep_val = jnp.concatenate([v.astype(jnp.uint64) for v in parts], axis=1)
    words, ovf = deposit_stream_windowed(dep_cum, dep_val, nbv, W, chunk=128, win_rows=8, row_words=32)
    byte_len = (total_bits + 7) >> 3
    crcs = crc16_words(words, byte_len)
    words = deposit_crc16(words, byte_len, crcs)
    frame_bytes = byte_len + 2
    stream, total_words = compact_stream_aligned(words, frame_bytes, capb // 4)
    return red(stream) + red(total_words)

def timeit(name, fn, *args, N=10):
    out = fn(*args); jax.block_until_ready(out)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(N):
            out = fn(*args)
        np.asarray(out)
        best = min(best, (time.perf_counter() - t0) / N)
    print(f"{name:12s} {best*1e3:8.2f} ms   ({n*B/rate/best:7.0f}x RT)", flush=True)
    return best

print("device:", jax.devices()[0].platform, flush=True)
t_plan = timeit("plan", p_plan, batch)
t_sym = timeit("plan+sym", p_symbols, batch, fns)
t_dep = timeit("+deposit", p_deposit, batch, fns)
t_crc = timeit("+crc", p_crc, batch, fns)
t_full = timeit("full", p_full, batch, fns)
print(f"deltas: symbols {1e3*(t_sym-t_plan):.2f} deposit {1e3*(t_dep-t_sym):.2f} "
      f"crc {1e3*(t_crc-t_dep):.2f} compact {1e3*(t_full-t_crc):.2f}", flush=True)
