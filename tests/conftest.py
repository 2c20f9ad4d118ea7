"""Test configuration: JAX defaults to the CPU with 8 virtual devices, so
sharding and the full device pipeline run without an accelerator.
``JAX_PLATFORMS`` set by the caller wins: chip_smoke.py runs the
``gpu``-marked tests on the card from its own process."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Build the C++ host runtime in place when absent (fresh checkouts ship no
# .so): without it the native decoder/MD5/CRC tests skip. A failed build is
# not fatal here (those tests keep skipping); chip_smoke.py builds it too.
import glob as _glob
import pathlib as _pathlib
import subprocess as _subprocess
import sys as _sys

_root = _pathlib.Path(__file__).resolve().parent.parent
if not _glob.glob(str(_root / "_zf_native*.so")):
    _subprocess.run(
        [_sys.executable, str(_root / "native" / "build.py")],
        cwd=str(_root), check=False, capture_output=True,
    )

import numpy as np
import pytest

# Memoize the golden oracle's per-frame encode across the whole session:
# the scalar host encode is the suite's remaining tail, and parity tests
# re-encode identical (content, config) frames across test files.
# encode_frame is pure (samples + frame number +
# streaminfo + config -> bytes), so memoization is exact; every call site
# resolves it via module attribute access.
import zigflac_tpu.golden as _golden

_golden_encode_frame = _golden.encode_frame
_golden_memo = {}


def _memo_encode_frame(samples, frame_number, info, config):
    key = (
        tuple((s.tobytes(), s.dtype.str) for s in samples),
        frame_number,
        info.sample_rate,
        info.bit_depth,
        info.channels,
        config,
    )
    got = _golden_memo.get(key)
    if got is None:
        got = _golden_memo[key] = _golden_encode_frame(
            samples, frame_number, info, config
        )
    return got


_golden.encode_frame = _memo_encode_frame


@pytest.fixture(autouse=True, scope="module")
def _clear_compiled_programs():
    """Drop every live compiled XLA executable between test MODULES.

    Once a few GB of compiled programs + their constants accumulate (the
    suite builds hundreds of shapes), later tests run several times slower.
    Clearing jax's executable caches and the package's compiled-program
    lru_caches at module teardown restores fresh-process speed; recompiles
    in later modules reload from the persistent .jax_cache disk cache
    instead of compiling."""
    yield
    import gc

    from zigflac_tpu.models import pipeline
    from zigflac_tpu.ops import synth
    from zigflac_tpu.parallel import mesh

    pipeline._compiled_encode_batch.cache_clear()
    pipeline._compiled_encode_compact.cache_clear()
    mesh._sharded_compact_fn.cache_clear()
    synth._compiled_synth.cache_clear()
    synth._compiled_recombine.cache_clear()
    jax.clear_caches()
    gc.collect()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA GPU; skips elsewhere, runs inside chip_smoke.py",
    )


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise.
    Decided here, at test time, never at import or collection."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (JAX platform is {dev.platform!r}); "
                    "run `python chip_smoke.py` on the card")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xF1AC)


def make_signal(rng, n, channels=2, depth=16, kind="mixed"):
    """Synthetic PCM covering the encoder's decision space."""
    lo = -(1 << (depth - 1))
    hi = (1 << (depth - 1)) - 1
    t = np.arange(n)
    if kind == "silence":
        x = np.zeros((channels, n))
    elif kind == "constant":
        x = np.full((channels, n), 1234 % hi)
    elif kind == "sine":
        x = 0.4 * hi * np.sin(2 * np.pi * 440 * t / 44100)
        x = np.stack([x * (1 - 0.1 * c) for c in range(channels)])
    elif kind == "noise":
        x = rng.uniform(lo, hi, size=(channels, n))
    elif kind == "ramp":
        x = np.stack([(t * (c + 3)) % (hi // 2) for c in range(channels)])
    elif kind == "quiet_noise":
        x = rng.normal(0, max(hi >> 10, 2), size=(channels, n))
    elif kind == "mixed":
        base = 0.3 * hi * np.sin(2 * np.pi * 220 * t / 44100)
        noise = rng.normal(0, max(hi >> 8, 2), size=(channels, n))
        x = np.stack([base + noise[c] for c in range(channels)])
    elif kind == "alternating":
        x = np.stack([((-1) ** t) * (hi >> 2) for _ in range(channels)])
    elif kind == "extreme":
        x = rng.choice([lo, hi, 0, -1, 1], size=(channels, n))
    else:
        raise ValueError(kind)
    return np.clip(np.round(x), lo, hi).astype(np.int32)
