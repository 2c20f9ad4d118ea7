"""Bytes-moved roofline of the production encode programs on the GPU.

For each cumulative stage prefix of the PRODUCTION batch program
(models/pipeline._encode_batch_compact parameters: speculate=True,
deposit="windowed", tier-0 word budget) in both fixed and LPC modes:

  * measured ms/batch (best of 3 windows of N executions, each ending in
    block_until_ready; run ALONE, no concurrent load)
  * XLA cost-analysis "bytes accessed" (HBM traffic as the compiler
    accounts it: every buffer read + written across fusion boundaries)
  * flops, implied GB/s, and % of the device's published HBM peak
    (tools/peaks.py, keyed by device_kind; an unknown device is an error)

The stage DELTAS attribute traffic/time to plan / pack / crc / compact;
prefix programs fuse slightly differently than the full program at the cut
points, so deltas are approximate — the FULL row is exact.

Usage: python tools/roofline.py [--mode fixed|lpc|both] [--no-time]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from dataclasses import replace

from zigflac_tpu.models.pipeline import CAPACITY_LADDER
from zigflac_tpu.ops.analyze import plan_frames
from zigflac_tpu.ops.bitpack import (
    ALIGN_W, compact_stream_aligned, deposit_crc16, max_frame_words,
    pack_frames,
)
from zigflac_tpu.ops.crc16 import crc16_words
from zigflac_tpu.ops.header import header_static
from zigflac_tpu.utils.config import EncoderConfig
from peaks import hbm_peak_gbps

B, n = 4096, 1024
rate, depth = 44100, 16

cfg_f = EncoderConfig.default(2)
cfg_l = replace(cfg_f, prediction="lpc")
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(
    2 * np.pi * 97 * t / rate
)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
frames_np = np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int16)
fns_np = np.arange(n, dtype=np.int64)

hstatic = header_static(B, rate, depth)
stream_ratio, words_ratio = CAPACITY_LADDER[0]
max_words = max_frame_words(B, 2, depth, words_ratio)
raw_bytes = n * B * 2 * 2
capb = int(raw_bytes * stream_ratio) + (4 * ALIGN_W + 32) * n


def red(x):
    return jnp.sum(
        jax.lax.bitcast_convert_type(x.astype(jnp.uint32), jnp.int32),
        dtype=jnp.int32,
    )


def make_stages(cfg):
    """Cumulative prefixes of _encode_batch_compact (production params)."""
    lpc_order = cfg.lpc_order if cfg.prediction == "lpc" else 0

    def _plan(fr):
        return plan_frames(fr.astype(jnp.int32), depth, cfg, speculate=True)

    def _pack(fr, f):
        plan = _plan(fr)
        words, total_bits, overflow = pack_frames(
            plan, f, hstatic, B, cfg.max_rice_order, max_words,
            lpc_order=lpc_order, lpc_precision=cfg.lpc_precision,
            deposit="windowed", depth=depth,
        )
        return plan, words, total_bits, overflow

    def _crc(fr, f):
        plan, words, total_bits, overflow = _pack(fr, f)
        byte_len = (total_bits + 7) >> 3
        crcs = crc16_words(words, byte_len)
        words = deposit_crc16(words, byte_len, crcs)
        return plan, words, byte_len, overflow

    def p_plan(fr, f):
        plan = _plan(fr)
        return (
            red(plan.params)
            + red(plan.residuals.astype(jnp.int32).sum(axis=(2,)))
            + red(plan.kind)
            + red(plan.order)
        )

    def p_pack(fr, f):
        _plan_, words, total_bits, overflow = _pack(fr, f)
        return red(words) + red(total_bits) + red(overflow)

    def p_crc(fr, f):
        _plan_, words, byte_len, overflow = _crc(fr, f)
        return red(words) + red(byte_len) + red(overflow)

    def p_full(fr, f):
        plan, words, byte_len, overflow = _crc(fr, f)
        overflow = overflow | plan.sweep_unsafe
        frame_bytes = byte_len + 2
        stream, total_words = compact_stream_aligned(
            words, frame_bytes, capb // 4
        )
        meta = jnp.concatenate(
            [
                frame_bytes.astype(jnp.int64),
                total_words.astype(jnp.int64)[None],
                overflow.astype(jnp.int64)[None],
            ]
        )
        return red(stream) + red(meta)

    return [("plan", p_plan), ("+pack", p_pack), ("+crc", p_crc),
            ("full", p_full)]


def cost(compiled):
    ca = compiled.cost_analysis()
    d = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(d.get("bytes accessed", 0.0)), float(d.get("flops", 0.0))


def timeit(fn, batch, fns, N=10, reps=3):
    out = fn(batch, fns)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(N):
            out = fn(batch, fns)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / N)
    return best


def run_mode(name, cfg, do_time):
    print(f"\n== {name} mode ==", flush=True)
    HBM_GBPS = hbm_peak_gbps(jax.devices()[0].device_kind)
    batch = jnp.asarray(frames_np)
    fns = jnp.arange(n, dtype=jnp.int64)
    rows = []
    for sname, f in make_stages(cfg):
        jf = jax.jit(f)
        t0 = time.perf_counter()
        compiled = jf.lower(batch, fns).compile()
        bts, fl = cost(compiled)
        print(
            f"  compiled {sname:6s} in {time.perf_counter()-t0:6.1f}s  "
            f"bytes={bts/1e9:7.3f} GB  flops={fl/1e9:8.2f} G",
            flush=True,
        )
        ms = timeit(jf, batch, fns) * 1e3 if do_time else float("nan")
        rows.append((sname, ms, bts, fl))

    print(f"\n  {'stage':8s} {'ms':>8s} {'d_ms':>8s} {'GB':>8s} {'d_GB':>8s}"
          f" {'GB/s':>8s} {'%peak':>6s} {'min_ms':>7s}")
    prev_ms, prev_b = 0.0, 0.0
    for sname, ms, bts, fl in rows:
        gbs = bts / 1e9 / (ms / 1e3) if ms == ms and ms > 0 else float("nan")
        print(
            f"  {sname:8s} {ms:8.2f} {ms-prev_ms:8.2f} {bts/1e9:8.3f} "
            f"{(bts-prev_b)/1e9:8.3f} {gbs:8.1f} {100*gbs/HBM_GBPS:6.1f} "
            f"{bts/1e9/HBM_GBPS*1e3:7.2f}",
            flush=True,
        )
        prev_ms, prev_b = ms, bts
    full = rows[-1]
    if full[1] == full[1]:
        print(
            f"  => {name}: {full[1]:.2f} ms measured vs "
            f"{full[2]/1e9/HBM_GBPS*1e3:.2f} ms HBM-roofline "
            f"({100*full[2]/1e9/HBM_GBPS*1e3/full[1]:.0f}% utilization), "
            f"{n*B/rate/(full[1]/1e3):.0f}x RT",
            flush=True,
        )
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="both", choices=["fixed", "lpc", "both"])
    ap.add_argument("--no-time", action="store_true")
    args = ap.parse_args()
    print("device:", jax.devices()[0], flush=True)
    if args.mode in ("fixed", "both"):
        run_mode("fixed", cfg_f, not args.no_time)
    if args.mode in ("lpc", "both"):
        run_mode("lpc", cfg_l, not args.no_time)
