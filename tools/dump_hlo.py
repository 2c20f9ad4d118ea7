"""Dump the compiled HLO of the production encode program (on JAX's
default device) to a file, for grepping layout copies / fusion structure.

Usage: python tools/dump_hlo.py [--mode fixed|lpc] [--out /tmp/hlo.txt]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np
import jax.numpy as jnp

from dataclasses import replace

from zigflac_tpu.models.pipeline import _compiled_encode_compact
from zigflac_tpu.utils.config import EncoderConfig

ap = argparse.ArgumentParser()
ap.add_argument("--mode", default="lpc", choices=["fixed", "lpc"])
ap.add_argument("--out", default="/tmp/hlo.txt")
ap.add_argument("-n", type=int, default=1024)
args = ap.parse_args()

B, rate = 4096, 44100
cfg = EncoderConfig.default(2)
if args.mode == "lpc":
    cfg = replace(cfg, prediction="lpc")
fn, _cap = _compiled_encode_compact(cfg, 16, 2, B, rate, 0, args.n)
frames = jnp.zeros((args.n, 2, B), jnp.int16)
fns = jnp.arange(args.n, dtype=jnp.int64)
txt = fn.lower(frames, fns).compile().as_text()
with open(args.out, "w") as f:
    f.write(txt)
print(f"{len(txt)} chars -> {args.out}")
