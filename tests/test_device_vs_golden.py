"""The central bit-exactness property: the device pipeline must produce
byte-identical frames to the golden host oracle for every signal class,
depth, and channel mode."""

import numpy as np
import pytest

from zigflac_tpu import golden
from zigflac_tpu.metadata import StreamInfo
from zigflac_tpu.models.pipeline import DevicePipeline
from zigflac_tpu.utils.config import EncoderConfig

from conftest import make_signal

KINDS = [
    "silence", "constant", "sine", "noise", "ramp",
    "quiet_noise", "mixed", "alternating", "extreme",
]


def run_both(samples, depth, rate=44100, config=None, block=None):
    """Encode [C, n] via golden and device; return (golden frames, device frames)."""
    cfg = config or EncoderConfig.default(samples.shape[0])
    B = block or cfg.block_size
    c, n = samples.shape
    nf = n // B
    assert nf * B == n
    frames = samples[:, : nf * B].reshape(c, nf, B).transpose(1, 0, 2)
    info = StreamInfo(rate, c, depth, n, B, B)
    g = [
        golden.encode_frame([frames[i, ch] for ch in range(c)], i, info, cfg)
        for i in range(nf)
    ]
    pipe = DevicePipeline(cfg, depth, batch_size=max(nf, 1))
    d = pipe.encode_frames(frames, 0, info)
    return g, d


def assert_identical(g, d):
    assert len(g) == len(d)
    for i, (a, b) in enumerate(zip(g, d)):
        assert a == b, (
            f"frame {i} differs: golden {len(a)}B vs device {len(b)}B; "
            f"first diff at byte "
            f"{next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), 'len')}"
        )


@pytest.mark.parametrize("kind", KINDS)
def test_stereo_16bit(rng, kind):
    samples = make_signal(rng, 4 * 4096, channels=2, depth=16, kind=kind)
    g, d = run_both(samples, 16)
    assert_identical(g, d)


@pytest.mark.parametrize("kind", ["sine", "mixed", "noise", "quiet_noise"])
def test_stereo_24bit(rng, kind):
    samples = make_signal(rng, 2 * 4096, channels=2, depth=24, kind=kind)
    g, d = run_both(samples, 24, rate=96000)
    assert_identical(g, d)


@pytest.mark.parametrize("kind", ["sine", "mixed", "extreme", "noise"])
def test_stereo_32bit(rng, kind):
    samples = make_signal(rng, 2 * 4096, channels=2, depth=32, kind=kind)
    g, d = run_both(samples, 32)
    assert_identical(g, d)


def test_stereo_8bit(rng):
    samples = make_signal(rng, 2 * 4096, channels=2, depth=8, kind="mixed")
    # emulate the reference's 8-bit read quirk domain: values in [-1, 254]
    g, d = run_both(samples, 8, rate=8000)
    assert_identical(g, d)


@pytest.mark.parametrize("channels", [1, 3, 8])
def test_multichannel(rng, channels):
    samples = make_signal(rng, 2 * 4096, channels=channels, depth=16, kind="mixed")
    g, d = run_both(samples, 16)
    assert_identical(g, d)


def test_mode_coverage(rng):
    """Construct signals that force each stereo mode and check identity."""
    n = 2 * 4096
    base = make_signal(rng, n, channels=1, depth=16, kind="mixed")[0]
    noise = make_signal(rng, n, channels=1, depth=16, kind="quiet_noise")[0]
    cases = {
        # nearly identical channels -> mid/side or left/side
        "correlated": np.stack([base, base + noise // 4]),
        # independent channels -> L/R
        "independent": np.stack(
            [base, make_signal(rng, n, channels=1, depth=16, kind="noise")[0]]
        ),
        # right silent -> side modes attractive
        "right_silent": np.stack([base, np.zeros(n, np.int32)]),
        "left_silent": np.stack([np.zeros(n, np.int32), base]),
    }
    for name, samples in cases.items():
        g, d = run_both(samples.astype(np.int32), 16)
        assert_identical(g, d)


def test_escape_partitions(rng):
    """All-zero partitions (perfect prediction) select the escape param."""
    n = 2 * 4096
    t = np.arange(n)
    # piecewise: linear ramps (order-2-perfect) with noisy bursts
    x = (t * 7 % 1000).astype(np.int32)
    burst = make_signal(rng, n, channels=1, depth=16, kind="noise")[0]
    x[1024:2048] = burst[1024:2048] // 2
    samples = np.stack([x, x // 2]).astype(np.int32)
    g, d = run_both(samples, 16)
    assert_identical(g, d)


def test_constant_frames(rng):
    samples = np.full((2, 2 * 4096), -123, np.int32)
    g, d = run_both(samples, 16)
    assert_identical(g, d)


def test_small_block_sizes(rng):
    for B in [192, 256, 1000, 576]:
        cfg = EncoderConfig(block_size=B, channels="stereo_auto")
        samples = make_signal(rng, 2 * B, channels=2, depth=16, kind="mixed")
        g, d = run_both(samples, 16, config=cfg, block=B)
        assert_identical(g, d)


def test_rice_4bit_method(rng):
    cfg = EncoderConfig(max_rice_param=14)
    samples = make_signal(rng, 2 * 4096, channels=2, depth=16, kind="mixed")
    g, d = run_both(samples, 16, config=cfg)
    assert_identical(g, d)


def test_large_frame_numbers(rng):
    """Frame numbers crossing UTF-8 length boundaries."""
    cfg = EncoderConfig.default(2)
    samples = make_signal(rng, 2 * 4096, channels=2, depth=16, kind="mixed")
    frames = samples.reshape(2, 2, 4096).transpose(1, 0, 2)
    info = StreamInfo(44100, 2, 16, 10**9, 4096, 4096)
    for first in [126, 0x7FF, 0xFFFF, 2**20 - 1, 2**31]:
        g = [
            golden.encode_frame(
                [frames[i, ch] for ch in range(2)], first + i, info, cfg
            )
            for i in range(2)
        ]
        pipe = DevicePipeline(cfg, 16, batch_size=2)
        d = pipe.encode_frames(frames, first, info)
        assert_identical(g, d)


@pytest.mark.parametrize("depth", [12, 20])
def test_stereo_12_20_bit(rng, depth):
    """Extension depths (reference crashes): device == golden byte-exact."""
    samples = make_signal(rng, 2 * 1024, channels=2, depth=depth, kind="mixed")
    cfg = EncoderConfig(block_size=1024)
    g, d = run_both(samples, depth, config=cfg, block=1024)
    assert_identical(g, d)


@pytest.mark.parametrize("rem", [64, 97, 1000, 1023])
def test_ragged_tail_on_device(rng, rem):
    """Ragged final frames encode on device at their exact block size
    (ctz(len) partition clamp + uncommon-block-size header) and stay
    byte-identical to golden (libFLAC/rice.zig:82, FrameWriter.zig:163-169).
    """
    from zigflac_tpu.models.encoder import Encoder

    B = 1024
    cfg = EncoderConfig(block_size=B)
    samples = make_signal(rng, 2 * B + rem, channels=2, depth=16, kind="mixed")
    c, n = samples.shape

    def full_encode(backend):
        info = StreamInfo(44100, c, 16, n, B, B)
        enc = Encoder(cfg, 16, backend=backend)
        return enc.encode_stream(samples, info)

    g = full_encode("golden")
    d = full_encode("device")
    assert g == d


def test_tail_only_file_on_device(rng):
    """A file shorter than one block (but >= the device-tail floor) encodes
    entirely through the device tail path."""
    from zigflac_tpu.models.encoder import Encoder

    B = 1024
    cfg = EncoderConfig(block_size=B)
    samples = make_signal(rng, 300, channels=2, depth=16, kind="sine")
    info_g = StreamInfo(44100, 2, 16, 300, B, B)
    info_d = StreamInfo(44100, 2, 16, 300, B, B)
    g = Encoder(cfg, 16, backend="golden").encode_stream(samples, info_g)
    d = Encoder(cfg, 16, backend="device").encode_stream(samples, info_d)
    assert g == d


def test_speculative_sweep_detection_and_24bit_identity():
    """The speculative-u32 rice sweep: (a) its unsafe flag fires on
    residuals big enough to push a fine-partition zigzag sum past 2^31
    (only LPC blowups can produce these — fixed-mode residuals at
    <=24-bit stay under the bound by construction, which is exactly why
    tier 0 can speculate); (b) on real full-scale 24-bit content the
    speculated sweep is bit-identical to exact, so the device pipeline
    matches golden with no fallback."""
    import jax.numpy as jnp

    from zigflac_tpu.ops.analyze import rice_estimate

    B = 4096
    # (a) synthetic 28-bit residuals (an LPC mis-prediction scale): trips
    big = ((np.arange(B) & 1) * 2 - 1).astype(np.int32) * (1 << 27)
    _b, _m, _p, _par, unsafe = rice_estimate(
        jnp.asarray(big[None, :]), jnp.zeros((1,), jnp.int32), B, 8, 30,
        speculate=True,
    )
    assert bool(np.asarray(unsafe))
    # ...and exact-mode never reports unsafe
    _b, _m, _p, _par, unsafe0 = rice_estimate(
        jnp.asarray(big[None, :]), jnp.zeros((1,), jnp.int32), B, 8, 30,
    )
    assert not bool(np.asarray(unsafe0))
    # (b) full-scale 24-bit Nyquist square end to end
    t = np.arange(2 * B)
    x = (((t & 1) * 2 - 1) * (2**23 - 1)).astype(np.int32)
    samples = np.stack([x, -x])
    g, d = run_both(samples, 24, rate=96000)
    assert_identical(g, d)


def test_wide_rice_symbol_ragged_tail():
    """A >256-bit Rice symbol survives the full decision path: a lone
    impulse over near-silence in a ragged tail (block 3388 = 4*847 ->
    ctz clamps partition order to 2, partitions >= 847 samples, so the
    escape threshold 847*15 bits exceeds the ~1.5k-bit unary quotient
    and Rice wins). Regression for the deposit prefix sum's matmul
    precision: bfloat16 operands would round any symbol width above 256
    bits, and TF32 (a GPU's default f32 matmul mode) any above 2048 —
    _cumsum_bits_exact must run its dot at Precision.HIGHEST
    (ops/bitpack.py). Exact on the CPU suite either way; the on-card legs
    are tests/test_gpu.py and chip_smoke.py phase (g)."""
    from zigflac_tpu.models.encoder import Encoder

    B = 4096
    cfg = EncoderConfig(block_size=B)
    n = B + 3388
    samples = np.zeros((2, n), dtype=np.int64)
    samples[0, B + 1200] = 2000
    samples[1, B + 2500] = -1500
    info = StreamInfo(44100, 2, 16, n, B, B)
    g = Encoder(cfg, 16, backend="golden").encode_stream(samples, info)
    info2 = StreamInfo(44100, 2, 16, n, B, B)
    d = Encoder(cfg, 16, backend="device").encode_stream(samples, info2)
    assert g == d


def test_impulse_tail_symbol_is_tf32_inexact():
    """The on-card precision checks (tests/test_gpu.py, chip_smoke.py
    phase (g)) rely on this content: a lone impulse of 2000 in an odd
    2047-sample tail (one Rice partition) codes as a 4001-bit Rice symbol.
    That width exceeds 2048 and is not a multiple of TF32's rounding step
    at that magnitude, so TF32 in the prefix-sum matmul would shift every
    later offset. And the device encode of it equals golden."""
    import jax.numpy as jnp

    from zigflac_tpu.models.encoder import Encoder
    from zigflac_tpu.ops.analyze import plan_frames
    from zigflac_tpu.ops.bitpack import frame_symbol_stream
    from zigflac_tpu.ops.header import header_static

    T = 2047
    x = np.zeros((1, 2, T), np.int32)
    x[0, 0, T // 3] = 2000
    x[0, 1, (2 * T) // 3] = -1500
    cfg = EncoderConfig(block_size=4096)
    plan = plan_frames(jnp.asarray(x), 16, cfg)
    d_cum, _, _, _ = frame_symbol_stream(
        plan, jnp.zeros(1, jnp.int64), header_static(T, 44100, 16), T,
        cfg.max_rice_order,
    )
    widths = np.diff(np.concatenate([[0], np.asarray(d_cum)[0]]))

    def tf32_exact(v):  # 11 significant bits
        step = 1 << max(int(v).bit_length() - 11, 0)
        return v % step == 0

    assert 4001 in widths
    assert any(w > 2048 and not tf32_exact(w) for w in widths)

    samples = np.zeros((2, 4096 + T), np.int64)
    samples[:, 4096:] = x[0]
    info = StreamInfo(44100, 2, 16, samples.shape[1], 4096, 4096)
    g = Encoder(cfg, 16, backend="golden").encode_stream(samples, info)
    info2 = StreamInfo(44100, 2, 16, samples.shape[1], 4096, 4096)
    d = Encoder(cfg, 16, backend="device").encode_stream(samples, info2)
    assert g == d
