"""Per-fusion time attribution of the production encode program (GPU).

Runs the full production batch program under jax.profiler.trace and prints
the top-K device ops by total self time, with their HLO op names (which
embed the originating source lines via XLA metadata when available).

Usage: python tools/probe_fusions.py [--mode fixed|lpc] [--top 40]
"""
import argparse
import glob
import gzip
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax
import jax.numpy as jnp

from dataclasses import replace

from zigflac_tpu.models.pipeline import _compiled_encode_compact
from zigflac_tpu.utils.config import EncoderConfig
from peaks import hbm_peak_gbps

ap = argparse.ArgumentParser()
ap.add_argument("--mode", default="fixed", choices=["fixed", "lpc"])
ap.add_argument("--top", type=int, default=40)
ap.add_argument("--reps", type=int, default=10)
args = ap.parse_args()

B, n, rate = 4096, 1024, 44100
cfg = EncoderConfig.default(2)
if args.mode == "lpc":
    cfg = replace(cfg, prediction="lpc")
rng = np.random.default_rng(0xBEEF)
t = np.arange(n * B)
base = 9000 * np.sin(2 * np.pi * 440 * t / rate) + 3000 * np.sin(
    2 * np.pi * 97 * t / rate
)
L = np.clip(np.round(base + rng.normal(0, 120, t.size)), -32768, 32767)
R = np.clip(np.round(0.8 * base + rng.normal(0, 120, t.size)), -32768, 32767)
batch = jnp.asarray(
    np.stack([L.reshape(n, B), R.reshape(n, B)], axis=1).astype(np.int16)
)
fns = jnp.arange(n, dtype=jnp.int64)

fn, _cap = _compiled_encode_compact(cfg, 16, 2, B, rate, 0, n)
out = fn(batch, fns)
jax.block_until_ready(out)
np.asarray(out[1])

trace_dir = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build", "traces", f"zf_trace_{args.mode}",
)
shutil.rmtree(trace_dir, ignore_errors=True)
with jax.profiler.trace(trace_dir):
    for _ in range(args.reps):
        out = fn(batch, fns)
    np.asarray(out[1])

# pull per-op self times out of the trace protos (trace.json.gz viewer file)
paths = glob.glob(f"{trace_dir}/**/*.trace.json.gz", recursive=True)
if not paths:
    print("no trace found under", trace_dir)
    sys.exit(1)
with gzip.open(paths[0], "rt") as f:
    trace = json.load(f)
events = trace.get("traceEvents", [])
# device-lane complete events carrying XLA metadata: per-op duration +
# bytes_accessed (the compiler's true HBM traffic accounting) + long_name
# (result shape/layout + operand shapes)
agg = {}
for e in events:
    if e.get("ph") != "X" or "dur" not in e:
        continue
    a = e.get("args", {}) or {}
    if "device_duration_ps" not in a:
        continue
    name = e.get("name", "")
    d = agg.setdefault(name, [0.0, 0, 0.0, a.get("long_name", "")])
    d[0] += float(a["device_duration_ps"]) / 1e9  # -> ms
    d[1] += 1
    d[2] += float(a.get("bytes_accessed", 0))
tot_ms = sum(v[0] for v in agg.values()) / args.reps
tot_gb = sum(v[2] for v in agg.values()) / args.reps / 1e9
peak = hbm_peak_gbps(jax.devices()[0].device_kind)
print(f"device op time {tot_ms:.2f} ms/rep, bytes {tot_gb:.2f} GB/rep "
      f"(avg {tot_gb/tot_ms*1e3:.0f} GB/s vs {peak:.0f} peak), "
      f"{len(agg)} distinct ops, {args.reps} reps")
rows = sorted(agg.items(), key=lambda kv: -kv[1][0])[: args.top]
for name, (dur, cnt, bts, long_name) in rows:
    ms = dur / args.reps
    gb = bts / args.reps / 1e9
    gbs = gb / ms * 1e3 if ms > 0 else 0.0
    shape = long_name.split(" = ", 1)[1][:90] if " = " in long_name else ""
    print(f"  {ms:7.3f} ms {gb*1e3:8.1f} MB {gbs:6.0f} GB/s  "
          f"{name[:28]:28s} {shape}")
