"""Card-only checks: on a CUDA GPU the device pipeline is byte-identical to
the golden oracle for both deposit paths, including a Rice symbol wide
enough that TF32 matmul rounding would corrupt the bit-offset prefix sum.

Every test here is marked ``gpu`` and takes the ``gpu`` fixture, which
skips it when JAX's first device is not a GPU. ``python chip_smoke.py``
runs them on the card in its own process."""

import io

import numpy as np
import pytest

from zigflac_tpu.models import pipeline
from zigflac_tpu.models.encoder import encode_wav_bytes
from zigflac_tpu.wav import write_wav

from conftest import make_signal

pytestmark = pytest.mark.gpu

B = 4096
# An odd tail length allows a single Rice partition, so a lone impulse of
# 2000 over silence codes as one Rice symbol of 4001 bits (k = 0): above
# TF32's 2048-integer limit and not a multiple of its rounding step.
WIDE_TAIL = 2047


def _wide_tail_wav(rng, n_full: int) -> bytes:
    samples = np.zeros((2, n_full * B + WIDE_TAIL), np.int64)
    samples[:, : n_full * B] = make_signal(
        rng, n_full * B, channels=2, depth=16, kind="mixed"
    )
    samples[:, B // 2 : B] = make_signal(
        rng, B // 2, channels=2, depth=16, kind="noise"
    )  # escape partitions in the first frame
    samples[0, n_full * B + WIDE_TAIL // 3] = 2000
    samples[1, n_full * B + (2 * WIDE_TAIL) // 3] = -1500
    buf = io.BytesIO()
    write_wav(buf, samples, 44100, 16)
    return buf.getvalue()


@pytest.fixture
def deposit_mode(request, monkeypatch):
    """Pin the pipeline's deposit path for one test; compiled programs are
    dropped before and after so no other test reuses them."""
    pipeline._compiled_encode_compact.cache_clear()
    monkeypatch.setattr(pipeline, "_default_deposit", lambda: request.param)
    yield request.param
    pipeline._compiled_encode_compact.cache_clear()


@pytest.mark.parametrize("deposit_mode", ["segsum", "windowed"],
                         indirect=True)
def test_device_matches_golden_on_card(gpu, rng, deposit_mode):
    wav = _wide_tail_wav(rng, n_full=4)
    assert encode_wav_bytes(wav, backend="device") == encode_wav_bytes(
        wav, backend="golden"
    )


def test_cumsum_bits_exact_on_card(gpu):
    """The HIGHEST-precision prefix-sum matmul is exact on the card for
    widths that TF32 (11 significant bits) would round."""
    import jax
    import jax.numpy as jnp

    from zigflac_tpu.ops.bitpack import _cumsum_bits_exact

    nb = np.random.default_rng(5).integers(0, 20, (4, 1000)).astype(np.int32)
    nb[0, 37] = 2049
    nb[1, 129] = 4001
    nb[2, 500] = 8191
    nb[3, 999] = 100003
    got = np.asarray(jax.jit(_cumsum_bits_exact)(jnp.asarray(nb)))
    want = np.cumsum(nb, axis=1, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(got, want)
