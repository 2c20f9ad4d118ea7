"""Golden-output regression corpus.

The environment has no Zig toolchain, so a direct comparison against the
compiled reference binary has never run (ORACLE_AUDIT.md); the transitive
bit-exactness chain is source audit + hand vectors + libFLAC cross-decode.
This corpus is the cheap insurance that makes perf refactors decision-safe:
~20 small FLAC streams generated at the round-5 head are committed under
``tests/vectors/corpus/`` with a hash manifest, and this test re-encodes the
deterministically synthesized inputs and asserts byte-identity.

Every case covers a distinct axis: depths 8/16/24/32, channels 1/2/8,
fixed vs LPC prediction, content classes that force Constant / Verbatim /
escape partitions / wide Rice symbols, ragged tails both above and below
the device floor (TAIL_DEVICE_MIN), and a non-4096 block size.

Regenerate (after an INTENTIONAL bitstream-affecting change only):

    ZIGFLAC_REGEN_CORPUS=1 python -m pytest tests/test_regression_corpus.py

then review the manifest diff and commit. A byte diff here without an
intentional decision-rule change means a refactor broke the encoder.
"""

import hashlib
import io
import json
import os
from dataclasses import replace

import numpy as np
import pytest

from zigflac_tpu.models.encoder import encode_wav_bytes
from zigflac_tpu.utils.config import EncoderConfig
from zigflac_tpu.wav import write_wav

VEC_DIR = os.path.join(os.path.dirname(__file__), "vectors", "corpus")
MANIFEST = os.path.join(VEC_DIR, "manifest.json")
REGEN = os.environ.get("ZIGFLAC_REGEN_CORPUS") == "1"

BLOCK = 4096


def _tonal(n, depth, ch, seed, noise=120.0, amp=9000.0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    scale = 2.0 ** (depth - 16)
    base = scale * (
        amp * np.sin(2 * np.pi * 440 * t / 44100)
        + amp / 3 * np.sin(2 * np.pi * 97 * t / 44100)
    )
    chans = [
        (1.0 - 0.1 * c) * base + rng.normal(0, noise * scale, n)
        for c in range(ch)
    ]
    return np.stack(chans)


def _noise(n, depth, ch, seed, frac=1.0):
    rng = np.random.default_rng(seed)
    lim = (1 << (depth - 1)) - 1
    return rng.uniform(-lim * frac, lim * frac, size=(ch, n))


def _speech_like(n, depth, ch, seed):
    """AR(2)-filtered noise bursts with silent gaps — LPC-friendly."""
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 2.0 ** (depth - 16) * 600, size=(ch, n))
    gate = (np.arange(n) // 3000) % 3 != 2  # bursts with gaps
    e *= gate
    x = np.zeros_like(e)
    for i in range(2, n):  # host-side synthesis; corpus inputs are tiny
        x[:, i] = 1.6 * x[:, i - 1] - 0.68 * x[:, i - 2] + e[:, i]
    return x


def _case_pcm(case) -> np.ndarray:
    n, depth, ch = case["n"], case["depth"], case["channels"]
    kind = case["kind"]
    lim = 1 << (depth - 1)
    if kind == "silence":
        x = np.zeros((ch, n))
    elif kind == "dc":
        x = np.full((ch, n), -(lim // 3), dtype=np.float64)
    elif kind == "impulse":
        x = np.zeros((ch, n))
        for c in range(ch):
            x[c, (n * (c + 1)) // (ch + 1)] = (lim - 1) * (-1 if c % 2 else 1)
    elif kind == "ramp":
        x = np.tile(np.arange(n, dtype=np.float64) % 2048 - 1024, (ch, 1))
    elif kind == "alt_max":
        x = np.tile(
            np.where(np.arange(n) % 2 == 0, lim - 1, -lim).astype(np.float64),
            (ch, 1),
        )
    elif kind == "noise":
        x = _noise(n, depth, ch, case["seed"])
    elif kind == "quiet_noise":
        x = _noise(n, depth, ch, case["seed"], frac=2.0 ** -10)
    elif kind == "tonal":
        x = _tonal(n, depth, ch, case["seed"])
    elif kind == "speech":
        x = _speech_like(n, depth, ch, case["seed"])
    else:  # pragma: no cover
        raise AssertionError(kind)
    return np.clip(np.round(x), -lim, lim - 1).astype(np.int64)


def _case_config(case) -> EncoderConfig:
    cfg = EncoderConfig.default(case["channels"])
    if case.get("block"):
        cfg = replace(cfg, block_size=case["block"])
    if case.get("lpc"):
        cfg = replace(cfg, prediction="lpc", lpc_order=case.get("order", 8))
    return cfg


def _wav_bytes(case) -> bytes:
    buf = io.BytesIO()
    write_wav(buf, _case_pcm(case), case.get("rate", 44100), case["depth"])
    return buf.getvalue()


# ~2.2 full blocks + tails chosen per case; kept small so the committed
# corpus stays well under 1 MB total.
CASES = [
    # core content classes at 16/44.1 stereo (reference's headline format)
    dict(name="tonal_16_2", kind="tonal", depth=16, channels=2,
         n=2 * BLOCK + 1500, seed=1),
    dict(name="noise_16_2", kind="noise", depth=16, channels=2,
         n=BLOCK + 777, seed=2),
    dict(name="silence_16_2", kind="silence", depth=16, channels=2,
         n=BLOCK + 100),
    dict(name="dc_16_2", kind="dc", depth=16, channels=2, n=BLOCK + 64),
    dict(name="impulse_16_2", kind="impulse", depth=16, channels=2,
         n=2 * BLOCK + 1111, seed=3),
    dict(name="ramp_16_2", kind="ramp", depth=16, channels=2, n=BLOCK),
    dict(name="alt_max_16_2", kind="alt_max", depth=16, channels=2,
         n=BLOCK + 333),
    dict(name="quiet_16_2", kind="quiet_noise", depth=16, channels=2,
         n=BLOCK + 2048, seed=4),
    dict(name="speech_16_2", kind="speech", depth=16, channels=2,
         n=2 * BLOCK, seed=5),
    # depth sweep
    dict(name="tonal_8_2", kind="tonal", depth=8, channels=2,
         n=BLOCK + 500, seed=6),
    dict(name="tonal_24_2", kind="tonal", depth=24, channels=2,
         n=BLOCK + 500, seed=7, rate=96000),
    dict(name="noise_32_2", kind="noise", depth=32, channels=2,
         n=BLOCK + 200, seed=8),
    dict(name="tonal_32_2", kind="tonal", depth=32, channels=2,
         n=BLOCK + 64, seed=9),
    dict(name="tonal_12_2", kind="tonal", depth=12, channels=2,
         n=BLOCK + 96, seed=19),  # odd depth (extension beyond 8/16/24/32)
    # channel sweep
    dict(name="tonal_16_1", kind="tonal", depth=16, channels=1,
         n=BLOCK + 900, seed=10),
    dict(name="tonal_16_8", kind="tonal", depth=16, channels=8,
         n=BLOCK + 128, seed=11),
    # LPC extension path
    dict(name="lpc_tonal_16_2", kind="tonal", depth=16, channels=2,
         n=2 * BLOCK + 1500, seed=1, lpc=True),
    dict(name="lpc_speech_16_2", kind="speech", depth=16, channels=2,
         n=2 * BLOCK, seed=5, lpc=True, order=12),
    dict(name="lpc_tonal_24_2", kind="tonal", depth=24, channels=2,
         n=BLOCK + 500, seed=7, lpc=True),
    # boundary geometry: tail below the device floor (golden path), exact
    # multiple (no tail), and a non-default block size
    dict(name="tiny_tail_16_2", kind="tonal", depth=16, channels=2,
         n=BLOCK + 63, seed=12),
    dict(name="exact_16_2", kind="tonal", depth=16, channels=2,
         n=2 * BLOCK, seed=13),
    dict(name="block1024_16_2", kind="tonal", depth=16, channels=2,
         n=3 * 1024 + 200, seed=14, block=1024),
]


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


@pytest.fixture(scope="module")
def manifest():
    if REGEN:
        return None
    assert os.path.exists(MANIFEST), (
        "corpus manifest missing — run with ZIGFLAC_REGEN_CORPUS=1"
    )
    with open(MANIFEST) as f:
        return json.load(f)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_corpus_byte_identity(case, manifest):
    wav = _wav_bytes(case)
    flac = encode_wav_bytes(wav, config=_case_config(case), backend="golden")
    path = os.path.join(VEC_DIR, case["name"] + ".flac")
    if REGEN:
        os.makedirs(VEC_DIR, exist_ok=True)
        with open(path, "wb") as f:
            f.write(flac)
        return
    ent = manifest["cases"][case["name"]]
    assert _sha(wav) == ent["wav_sha256"], (
        "input synthesis drifted — the corpus comparison is void; check "
        "numpy RNG / synthesis code before regenerating"
    )
    with open(path, "rb") as f:
        pinned = f.read()
    assert _sha(flac) == ent["flac_sha256"]
    assert flac == pinned, (
        f"{case['name']}: encoder output no longer byte-identical to the "
        "pinned corpus stream"
    )


def test_corpus_regen_manifest():
    """In regen mode, rewrite the manifest after all cases regenerated; in
    normal mode, assert the manifest covers exactly the declared cases."""
    if REGEN:
        entries = {}
        for case in CASES:
            wav = _wav_bytes(case)
            with open(os.path.join(VEC_DIR, case["name"] + ".flac"),
                      "rb") as f:
                flac = f.read()
            dec_ok = _roundtrip_ok(flac)
            assert dec_ok, f"{case['name']}: decode round-trip failed"
            entries[case["name"]] = {
                "wav_sha256": _sha(wav),
                "flac_sha256": _sha(flac),
                "flac_bytes": len(flac),
            }
        with open(MANIFEST, "w") as f:
            json.dump({"cases": entries}, f, indent=1, sort_keys=True)
        return
    with open(MANIFEST) as f:
        m = json.load(f)
    assert set(m["cases"]) == {c["name"] for c in CASES}


def _roundtrip_ok(flac: bytes) -> bool:
    from zigflac_tpu.decoder import decode_flac

    return bool(decode_flac(flac, backend="auto").md5_ok)


@pytest.mark.parametrize(
    "name", ["tonal_16_2", "lpc_tonal_16_2", "tonal_24_2", "noise_16_2"]
)
def test_corpus_device_byte_identity(name, manifest):
    """Device-pipeline leg on representative cases (device==golden is
    enforced broadly by test_device_vs_golden; this pins device output to
    the committed bytes through any future pipeline refactor). Shapes are
    shared across the four cases to bound CPU-jit compiles."""
    if REGEN:
        pytest.skip("regen uses the golden backend only")
    case = next(c for c in CASES if c["name"] == name)
    wav = _wav_bytes(case)
    flac = encode_wav_bytes(wav, config=_case_config(case), backend="device")
    with open(os.path.join(VEC_DIR, name + ".flac"), "rb") as f:
        assert flac == f.read()
