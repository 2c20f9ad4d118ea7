"""Device bit-packing: the group-aligned compaction gather, and the
windowed deposit path (bitpack.deposit_stream_windowed) against the exact
segment-sum deposits (bitpack.deposit_words) it must match bit for bit."""

import numpy as np
import jax.numpy as jnp
import pytest

from zigflac_tpu.ops.bitpack import ALIGN_W, compact_stream_aligned


def _mk(rng, n, W):
    wn = rng.integers(0, 2**32, (n, W), dtype=np.uint64).astype(np.uint32)
    fb = rng.integers(5, W * 4 - 3, n).astype(np.int32)
    for i in range(n):
        wcnt = int((fb[i] + 3) >> 2)
        wn[i, wcnt:] = 0
        extra = int(wcnt * 4 - fb[i])
        if extra:
            wn[i, wcnt - 1] &= np.uint32((0xFFFFFFFF << (8 * extra)) & 0xFFFFFFFF)
    return jnp.asarray(wn), jnp.asarray(fb), fb


def test_compact_group_aligned_matches_reference(rng):
    """The gather-based compaction must lay frames at ALIGN_W-word group
    boundaries with each frame's used words copied verbatim (the host
    assembly drops the inter-frame pad bytes by exact byte length)."""
    for n, W in [(4, ALIGN_W), (16, 5 * ALIGN_W), (64, 3 * ALIGN_W)]:
        words, fbj, fb = _mk(rng, n, W)
        gcnt = (fb + 4 * ALIGN_W - 1) // (4 * ALIGN_W)
        capw = int(gcnt.sum() + 2) * ALIGN_W
        out, total = compact_stream_aligned(words, fbj, capw)
        out = np.asarray(out)
        assert int(total) == int(gcnt.sum()) * ALIGN_W
        wn = np.asarray(words)
        goff = np.cumsum(gcnt) - gcnt
        for i in range(n):
            used = int(gcnt[i]) * ALIGN_W
            np.testing.assert_array_equal(
                out[goff[i] * ALIGN_W : goff[i] * ALIGN_W + used],
                wn[i, :used],
                err_msg=f"frame {i}",
            )


# -- windowed deposit path vs the exact segment-sum path ------------------

def _rand_stream(rng, n, s, max_nbv=20, gap=4, dtype=np.uint32):
    """Random deposit stream: widths nb >= value widths nbv, some masked."""
    nbv = rng.integers(0, max_nbv, (n, s)).astype(np.int32)
    nb = nbv + rng.integers(0, gap, (n, s)).astype(np.int32)
    d_cum = np.cumsum(nb, axis=1).astype(np.int32)
    val = rng.integers(0, 2**62, (n, s), dtype=np.int64).astype(np.uint64)
    val &= (np.uint64(1) << nbv.astype(np.uint64)) - np.uint64(1)
    val = np.where(nbv > 0, val, 0)
    return d_cum, val.astype(dtype), nbv


def _mask_columns(rng, d_cum, val, nbv, p=0.4):
    """Zero a fraction of the columns (nbv = nb = 0): masked partners must
    merge as identities."""
    n, s = nbv.shape
    kill = rng.random((n, s)) < p
    nb = np.where(kill, 0, np.diff(np.concatenate(
        [np.zeros((n, 1), np.int32), d_cum], axis=1), axis=1))
    return (np.cumsum(nb, axis=1).astype(np.int32),
            np.where(kill, 0, val), np.where(kill, 0, nbv))


def _windowed_vs_segsum(d_cum, val, nbv, W):
    """(segsum words, windowed words, windowed overflow) from one jitted
    program."""
    import jax
    from functools import partial

    from zigflac_tpu.ops.bitpack import deposit_stream_windowed, deposit_words

    @partial(jax.jit, static_argnums=3)
    def both(d, v, nv, w):
        return (
            deposit_words(d, v, nv, w),
            *deposit_stream_windowed(d, v, nv, w),
        )

    a, b, ovf = both(jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv), W)
    return np.asarray(a), np.asarray(b), bool(np.asarray(ovf))


@pytest.mark.parametrize(
    "n,s,max_nbv,gap,masked",
    [
        (3, 200, 20, 4, False),
        (2, 257, 29, 8, False),  # widest pairs: up to 64 merged bits
        (1, 64, 31, 2, False),
        (2, 301, 18, 3, True),   # masked columns + odd count
        (2, 151, 18, 4, True),
    ],
)
def test_windowed_deposit_matches_segsum(rng, n, s, max_nbv, gap, masked):
    """The windowed path (pair-merged deposits) must match the exact
    segment-sum deposits bit-for-bit — merged values up to 64 bits, masked
    columns, odd column counts, tiny and chunk-crossing streams."""
    d_cum, val, nbv = _rand_stream(
        rng, n, s, max_nbv=max_nbv, gap=gap, dtype=np.uint64
    )
    if masked:
        d_cum, val, nbv = _mask_columns(rng, d_cum, val, nbv)
    W = int(d_cum.max() // 32) + 3
    a, b, ovf = _windowed_vs_segsum(d_cum, val, nbv, W)
    assert not ovf
    np.testing.assert_array_equal(a, b)


def test_windowed_deposit_u64_33bit(rng):
    """33-bit side-channel deposits (u64 values, the depth-32 stereo side
    plane) land identically through the windowed path and segment-sums.
    Each 33-bit deposit's pair partner is <= 31 bits, so every pair fits
    the 64-bit merge."""
    n, s = 2, 150
    nbv = rng.integers(0, 32, (n, s)).astype(np.int32)
    nbv[:, : s // 2 : 2] = 33   # first half: 33-bit field leads its pair
    nbv[:, s // 2 + 1 :: 2] = 33  # second half: 33-bit field trails
    d_cum = np.cumsum(nbv, axis=1).astype(np.int32)
    val = rng.integers(0, 1 << 33, (n, s), dtype=np.uint64)
    val &= (np.uint64(1) << nbv.astype(np.uint64)) - np.uint64(1)
    assert (val >= (1 << 32)).any()
    W = int(d_cum.max() // 32) + 3
    a, b, ovf = _windowed_vs_segsum(d_cum, val, nbv, W)
    assert not ovf
    np.testing.assert_array_equal(a, b)


def test_windowed_deposit_word_budget_clamp(rng):
    """Deposits beyond max_words clamp into slack rows; the in-budget
    prefix stays identical to the segment-sum path (which drops them)."""
    d_cum, val, nbv = _rand_stream(rng, 2, 300, dtype=np.uint64)
    W = int(d_cum.max() // 32) // 2  # budget smaller than the stream needs
    a, b, ovf = _windowed_vs_segsum(d_cum, val, nbv, W)
    assert not ovf
    assert a.shape == b.shape == (2, W)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["window_span", "unmergeable_pair"])
def test_windowed_deposit_overflow_flags(case):
    """Window out-span (a giant field inside a chunk) and an unmergeable
    pair (>64-bit combined span: a long unary run in the second field) must
    both raise the windowed path's overflow flag, so the caller falls back
    to the exact path."""
    import jax
    from functools import partial

    from zigflac_tpu.ops.bitpack import deposit_stream_windowed

    n, s = 1, 256
    nb = np.full((n, s), 4, np.int32)
    if case == "window_span":
        nb[0, 10] = 600 * 32
    else:
        nb[0, 3] = 70  # field 3 (odd partner of pair 1): 66 zeros + 4 bits
    nbv = np.minimum(nb, 4)
    d_cum = np.cumsum(nb, axis=1).astype(np.int32)
    val = np.full((n, s), 9, np.uint64)
    win = partial(jax.jit, static_argnums=3)(deposit_stream_windowed)
    _, ovf = win(
        jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv),
        int(d_cum.max() // 32) + 3,
    )
    assert bool(np.asarray(ovf))


def test_pack_frames_windowed_matches_segsum(rng):
    """Full pack_frames with deposit='windowed' (the GPU's default
    deposit) is byte-identical to the segment-sum path on content forcing
    escapes / verbatim / constant / zero partitions."""
    import jax.numpy as jnp

    from zigflac_tpu.ops.analyze import plan_frames
    from zigflac_tpu.ops.bitpack import max_frame_words, pack_frames
    from zigflac_tpu.ops.header import header_static
    from zigflac_tpu.utils.config import EncoderConfig

    B, n = 512, 6
    cfg = EncoderConfig(block_size=B)
    t = np.arange(n * B)
    x = np.clip(
        6000 * np.sin(2 * np.pi * 440 * t / 44100)
        + rng.normal(0, 50, t.size),
        -32768, 32767,
    ).astype(np.int32)
    x[0:B] = 0
    x[B : 2 * B] = rng.integers(-32768, 32768, B)
    x[2 * B : 2 * B + 200] = 0
    frames = np.stack([x.reshape(n, B), (x // 3).reshape(n, B)], axis=1)
    fns = jnp.arange(n, dtype=jnp.int64)
    hs = header_static(B, 44100, 16)
    W = max_frame_words(B, 2, 16)

    import jax

    @jax.jit  # one cacheable program (eager tracing here costs ~30 s/run)
    def both(fr, fnum):
        plan = plan_frames(fr, 16, cfg)
        wa, ta, _ = pack_frames(plan, fnum, hs, B, cfg.max_rice_order, W)
        wb, tb, ovf = pack_frames(
            plan, fnum, hs, B, cfg.max_rice_order, W, deposit="windowed",
        )
        return wa, ta, wb, tb, ovf

    wa, ta, wb, tb, ovf = both(jnp.asarray(frames), fns)
    assert not bool(np.asarray(ovf))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))


def test_pack_frames_windowed_pair_depth32_matches_segsum(rng):
    """pack_frames with deposit='windowed_pair' (the capacity ladder's
    tier-1 windowed pass) at depth 32, where the planes are i64:
    byte-identical to segment-sums, with no overflow flag on uncorrelated
    channels (left/right coding keeps every field <= 32 bits). A frame
    coded with the 33-bit side channel has adjacent 33-bit warmup samples
    (66 bits) that cannot pair-merge: it flags overflow and takes the exact
    path by design."""
    import jax

    from zigflac_tpu.ops.analyze import plan_frames
    from zigflac_tpu.ops.bitpack import max_frame_words, pack_frames
    from zigflac_tpu.ops.header import header_static
    from zigflac_tpu.utils.config import EncoderConfig

    B, n = 256, 4
    cfg = EncoderConfig(block_size=B)
    t = np.arange(n * B)
    left = 2.0**29 * np.sin(2 * np.pi * 440 * t / 44100)
    right = 2.0**28 * np.sin(2 * np.pi * 97 * t / 44100 + 1.0)
    x = np.stack([left, right]) + rng.normal(0, 2.0**12, (2, t.size))
    frames = x.astype(np.int64).reshape(2, n, B).transpose(1, 0, 2)
    frames = frames.astype(np.int32)
    fns = jnp.arange(n, dtype=jnp.int64)
    hs = header_static(B, 44100, 32)
    W = max_frame_words(B, 2, 32)

    @jax.jit
    def both(fr, fnum):
        plan = plan_frames(fr, 32, cfg)
        wa, ta, _ = pack_frames(plan, fnum, hs, B, cfg.max_rice_order, W,
                                depth=32)
        wb, tb, ovf = pack_frames(
            plan, fnum, hs, B, cfg.max_rice_order, W,
            deposit="windowed_pair", depth=32,
        )
        return plan.planes.dtype == jnp.int64, wa, ta, wb, tb, ovf

    wide, wa, ta, wb, tb, ovf = both(jnp.asarray(frames), fns)
    assert bool(wide)
    assert not bool(np.asarray(ovf))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_array_equal(np.asarray(wa), np.asarray(wb))


def test_windowed_deposit_property_fuzz(rng):
    """20 random deposit streams through one compiled windowed program vs
    the exact segment-sum path: mixed widths (1..33 bits), heavy masking,
    zero-width runs, and occasional huge fields that must either merge
    (<=64 bits) or trip the overflow flag — never corrupt."""
    import jax
    from functools import partial

    import jax.numpy as jnp

    from zigflac_tpu.ops.bitpack import deposit_words, deposit_stream_windowed

    n, s = 2, 320

    @partial(jax.jit, static_argnums=3)
    def both(d, v, nv, w):
        return (
            deposit_words(d, v, nv, w),
            *deposit_stream_windowed(d, v, nv, w),
        )

    W = None
    for trial in range(20):
        nbv = rng.integers(1, 34, (n, s)).astype(np.int32)
        gap = rng.integers(0, 6, (n, s)).astype(np.int32)
        if trial % 3 == 0:
            nbv[rng.random((n, s)) < 0.5] = 0
        if trial % 4 == 0:
            # a few wide unary-ish fields (value bits small, total wide)
            idx = rng.integers(0, s, 4)
            gap[0, idx] = rng.integers(20, 40, 4)
        nb = np.where(nbv > 0, nbv + gap, 0)
        val = rng.integers(0, 1 << 33, (n, s), dtype=np.uint64) & (
            (np.uint64(1) << nbv.astype(np.uint64)) - np.uint64(1)
        )
        val = np.where(nbv > 0, val, 0)
        d_cum = np.cumsum(nb, axis=1).astype(np.int32)
        if W is None:
            W = 8 * s  # fixed static shape: one compile for all trials
        assert int(d_cum.max() // 32) + 3 <= W
        a, b, ovf = both(
            jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv), W
        )
        if bool(np.asarray(ovf)):
            continue  # legal: caller falls back to the exact path
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=f"trial {trial}"
        )


def test_windowed_quad_deposit_matches_segsum(rng):
    """Quad-merge mode (<=96-bit deposits over three u32 limbs, 3 dword
    slots): bit-identical to the exact segment-sum deposits across merged
    values, masked columns, odd counts, and chunk-crossing streams."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from zigflac_tpu.ops.bitpack import deposit_words, deposit_stream_windowed

    for n, s, max_nbv, gap in [
        (3, 200, 12, 4), (2, 257, 16, 6), (1, 64, 17, 2), (2, 301, 10, 3),
    ]:
        d_cum, val, nbv = _rand_stream(
            rng, n, s, max_nbv=max_nbv, gap=gap, dtype=np.uint64
        )
        if s == 301:  # masked columns + odd count
            kill = rng.random((n, s)) < 0.4
            nbv = np.where(kill, 0, nbv)
            val = np.where(kill, 0, val)
            nb = np.where(kill, 0, np.diff(np.concatenate(
                [np.zeros((n, 1), np.int32), d_cum], axis=1), axis=1))
            d_cum = np.cumsum(nb, axis=1).astype(np.int32)
        W = int(d_cum.max() // 32) + 3

        @partial(jax.jit, static_argnums=(3, 4))
        def both(d, v, nv, w, wr):
            return (
                deposit_words(d, v, nv, w),
                *deposit_stream_windowed(
                    d, v, nv, w, chunk=16, win_rows=wr, row_words=32,
                    quad=True,
                ),
            )

        # window: 16 quads of <= 4*(max_nbv+gap) bits + remainder + slack
        span_dw = -(-16 * 4 * (max_nbv + gap) // 64)
        wr = -(-(span_dw + 15 + 2) // 16)
        a, b, ovf = both(
            jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv), W, wr
        )
        assert not bool(np.asarray(ovf))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_windowed_quad_unmergeable_flags_overflow(rng):
    """A quad whose combined span exceeds 96 bits must raise the overflow
    flag (tier-1 re-encode uses pair merging via deposit='windowed_pair')."""
    import jax
    import jax.numpy as jnp
    from functools import partial

    from zigflac_tpu.ops.bitpack import deposit_stream_windowed

    n, s = 1, 256
    nb = np.full((n, s), 8, np.int32)
    nb[0, 5] = 90  # pair(8+90)=98 > 64 merges... pair-cannot already
    nbv = np.minimum(nb, 8)
    d_cum = np.cumsum(nb, axis=1).astype(np.int32)
    val = np.full((n, s), 0xAB, np.uint64)
    win = partial(jax.jit, static_argnums=3)(
        lambda d, v, nv, w: deposit_stream_windowed(
            d, v, nv, w, chunk=16, win_rows=4, row_words=32, quad=True
        )
    )
    _, ovf = win(jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv),
                 int(d_cum.max() // 32) + 3)
    assert bool(np.asarray(ovf))
    # quad-only impossibility: pairs fit (<=64) but the quad exceeds 96
    nb = np.full((n, s), 30, np.int32)
    nbv2 = np.minimum(nb, 30)
    d_cum = np.cumsum(nb, axis=1).astype(np.int32)
    _, ovf = win(jnp.asarray(d_cum), jnp.asarray(val), jnp.asarray(nbv2),
                 int(d_cum.max() // 32) + 3)
    assert bool(np.asarray(ovf))


@pytest.mark.parametrize("platform", ["cpu", "gpu", "rocm"])
def test_default_deposit_per_platform(monkeypatch, platform):
    """The deposit path follows the default device's platform through the
    measured table; a platform without a measured choice is an error, not
    a silent default."""
    import jax

    from zigflac_tpu.models import pipeline

    class _Dev:
        pass

    dev = _Dev()
    dev.platform = platform
    monkeypatch.setattr(jax, "devices", lambda *a, **k: [dev])
    if platform in pipeline.DEPOSIT_BY_PLATFORM:
        assert pipeline._default_deposit() == (
            pipeline.DEPOSIT_BY_PLATFORM[platform]
        )
        assert pipeline._default_deposit() in ("segsum", "windowed")
    else:
        with pytest.raises(RuntimeError, match="no deposit path"):
            pipeline._default_deposit()
    assert pipeline.DEPOSIT_BY_PLATFORM["cpu"] == "segsum"


def test_pack_frames_rejects_unknown_deposit():
    """The retired 'binned' mode (and any other name) is refused before
    any tracing, not silently mapped to another path."""
    from zigflac_tpu.ops.bitpack import pack_frames

    with pytest.raises(ValueError, match="unknown deposit mode 'binned'"):
        pack_frames(None, None, None, 4096, 8, 128, deposit="binned")
