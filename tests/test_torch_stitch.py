"""The port's stitch ops against the JAX package on the CPU: I420 packing
and its host inverse, the overlap blend, color matching (the uint8 device
path and the exact form) and the whole `stitch_window`.

Tolerance: 1 LSB on uint8 (both sides compute in fp32, but may round a
value that lands on .5 differently). One exception, stated where it is
used: the uint8 color match end to end, whose histogram stages can turn one
such rounding into a move of several levels (`test_match_colors_u8_matches_jax`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.ops import blending as jbl
from controlanimate_tpu.ops import color_match as jcm
from controlanimate_tpu.ops import stitch as jst
from controlanimate_tpu.ops import yuv as jyuv
from controlanimate_tpu_torch.ops import blending as tbl
from controlanimate_tpu_torch.ops import color_match as tcm
from controlanimate_tpu_torch.ops import stitch as tst
from controlanimate_tpu_torch.ops import yuv as tyuv


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def _frames(seed, n, h=16, w=24):
    """Smooth frames with noise: a moving gradient per channel."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = np.stack([(xx * 7 + i * 5) % 256, (yy * 9 + i * 3) % 256,
                         (xx + yy) * 4 % 256], axis=-1)
        out.append(np.clip(base + rng.randn(h, w, 3) * 12, 0, 255))
    return np.stack(out).astype(np.uint8)


def test_rgb_to_yuv420_and_inverse_match_jax():
    f = _frames(0, 3)
    j = np.asarray(jyuv.rgb_to_yuv420(jnp.asarray(f)))
    t = tyuv.rgb_to_yuv420(torch.from_numpy(f)).numpy()
    assert t.dtype == np.uint8 and t.shape == (3, 16 * 24 * 3 // 2)
    assert _lsb(t, j) <= 1
    np.testing.assert_array_equal(tyuv.yuv420_to_rgb_host(t, 16, 24),
                                  jyuv.yuv420_to_rgb_host(t, 16, 24))
    # the round trip stays near the input (chroma is 2x2-averaged)
    assert np.abs(tyuv.yuv420_to_rgb_host(t, 16, 24).astype(int) - f).mean() < 12


def test_blend_overlap_matches_jax():
    new, prev = _frames(1, 4), _frames(2, 4)
    j = np.asarray(jbl.blend_overlap_u8(jnp.asarray(new), jnp.asarray(prev)))
    t = tbl.blend_overlap_u8(torch.from_numpy(new), torch.from_numpy(prev)).numpy()
    assert _lsb(t, j) <= 1
    jf = np.asarray(jbl.blend_overlap(jnp.asarray(new, jnp.float32), jnp.asarray(prev)))
    tf = tbl.blend_overlap(torch.from_numpy(new).float(), torch.from_numpy(prev)).numpy()
    np.testing.assert_allclose(tf, jf, atol=1e-4)


def _gapped(seed, shape):
    """Uniform noise scaled by 0.6: a histogram with empty levels."""
    rng = np.random.RandomState(seed)
    return np.clip(rng.randint(0, 256, shape) * 0.6 + 40, 0, 255).astype(np.uint8)


COLOR_CASES = {
    "small": lambda: (_frames(3, 2), _frames(4, 1)[0]),
    # 256x256 = 65,536 pixels: the frames' CDFs take the stride-4 path
    "stride4_cdf": lambda: (_frames(3, 2, 256, 256), _frames(4, 1, 256, 256)[0]),
    "gapped_anchor": lambda: (np.random.RandomState(0).randint(0, 256, (2, 256, 256, 3))
                              .astype(np.uint8), _gapped(1, (256, 256, 3))),
}


@pytest.mark.parametrize("case", sorted(COLOR_CASES))
def test_match_colors_u8_matches_jax(case):
    """Each stage matches JAX: the anchor's CDFs and the histogram stage
    exactly on the same input, the MKL transfer within fp32 (atol 1e-2 on
    0..255). End to end the gate is looser than 1 LSB, because of how the
    stages chain: a pixel whose MKL value lies within that fp32 difference
    of a .5 rounding boundary rounds to the other level on one side, which
    moves the frame's CDF at that level by 1/N and can move the second
    histogram stage's LUT entry for every pixel of the level, by the gap
    between the anchor's neighbouring occupied levels. Gate: at most 2% of
    values differ, on average by at most 0.02 LSB, none by more than 4
    (seen: 0.39% of values at 256x256, at most 2 LSB)."""
    f, ref = COLOR_CASES[case]()
    cdf_j = jcm._ref_cdfs(jnp.asarray(ref))
    cdf_t = tcm._ref_cdfs(torch.from_numpy(ref))
    np.testing.assert_array_equal(cdf_t.numpy(), np.asarray(cdf_j))
    hm_j = np.array(jcm._hist_match_u8(jnp.asarray(f), jnp.asarray(ref), cdf_j))
    hm_t = tcm._hist_match_u8(torch.from_numpy(f), cdf_t).numpy()
    np.testing.assert_array_equal(hm_t, hm_j)
    ref_f = ref.astype(np.float32)
    mkl_j = np.stack([np.asarray(jcm._mkl_transfer_ns(jnp.asarray(x, jnp.float32),
                                                      jnp.asarray(ref_f))) for x in hm_j])
    mkl_t = tcm._mkl_transfer_ns(torch.from_numpy(hm_j).float(), torch.from_numpy(ref_f)).numpy()
    np.testing.assert_allclose(mkl_t, mkl_j, atol=1e-2)
    j = np.asarray(jcm.match_colors_u8(jnp.asarray(f), jnp.asarray(ref)))
    t = tcm.match_colors_u8(torch.from_numpy(f), torch.from_numpy(ref)).numpy()
    diff = np.abs(t.astype(int) - j.astype(int))
    assert (diff > 0).mean() <= 2e-2 and diff.mean() <= 2e-2 and diff.max() <= 4, (
        diff.max(), (diff > 0).mean())


def test_match_colors_exact_form_matches_jax():
    """Floats in [0, 1]; 1 LSB is 1/255."""
    f = _frames(5, 2).astype(np.float32) / 255.0
    ref = _frames(6, 1)[0].astype(np.float32) / 255.0
    j = np.asarray(jcm.match_colors(jnp.asarray(f), jnp.asarray(ref)))
    t = tcm.match_colors(torch.from_numpy(f), torch.from_numpy(ref)).numpy()
    np.testing.assert_allclose(t, j, atol=1.0 / 255 + 1e-6)
    np.testing.assert_allclose(tcm.hist_match(torch.from_numpy(f), torch.from_numpy(ref)).numpy(),
                               np.asarray(jcm.hist_match(jnp.asarray(f), jnp.asarray(ref))),
                               atol=1e-6)


@pytest.mark.parametrize("anchor,prev,to_yuv", [
    (False, False, False),  # first window
    (True, True, False),  # a later window: color match and blend
    (True, True, True),  # ... packed as I420
    (True, False, True),  # color match without an overlap to blend
])
def test_stitch_window_matches_jax(anchor, prev, to_yuv):
    frames = _frames(7, 6)
    a = _frames(8, 1)[0] if anchor else None
    p = _frames(9, 2) if prev else None
    kw = dict(overlap_length=2, to_yuv=to_yuv, emit=4)
    j = jst.stitch_window(jnp.asarray(frames), None if a is None else jnp.asarray(a),
                          None if p is None else jnp.asarray(p), **kw)
    inputs = [torch.from_numpy(frames)] + [None if v is None else torch.from_numpy(v)
                                           for v in (a, p)]
    before = [None if v is None else v.clone() for v in inputs]
    t = tst.stitch_window(*inputs, **kw)
    for jv, tv in zip(j, t):
        assert tv.dtype == torch.uint8 and tuple(tv.shape) == tuple(jv.shape)
        assert _lsb(tv.numpy(), jv) <= 1
    # fresh tensors: the inputs are unchanged and share no storage with the outputs
    for v, b in zip(inputs, before):
        assert v is None or torch.equal(v, b)
    ptrs = {v.untyped_storage().data_ptr() for v in inputs if v is not None}
    assert not ptrs & {v.untyped_storage().data_ptr() for v in t}


def test_stitch_window_without_overlap():
    frames = _frames(10, 4)
    j = jst.stitch_window(jnp.asarray(frames), None, None, overlap_length=0, to_yuv=False, emit=4)
    t = tst.stitch_window(torch.from_numpy(frames), None, None, overlap_length=0, to_yuv=False,
                          emit=4)
    assert t[2] is None and t[3] is None and j[2] is None
    assert _lsb(t[0].numpy(), j[0]) == 0 and _lsb(t[1].numpy(), j[1]) == 0
