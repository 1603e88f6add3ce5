"""The port's face geometry (`models/face_align.py`) against the JAX
package's: the similarity fit and the affine inverse, the aligned crop
(`align_face`, the warp with the gray border) for faces inside and partly
outside the frame, and the soft-mask paste (`paste_face`) into backgrounds
at 1x, 2x and 4x.

Gates: the fits exactly (the same float64 numpy code); the crop within
1 LSB, with the share of values that differ at most 1% (seen: none); the
pasted frame, float32 in [0, 255], within 1e-3 absolute (seen: 6e-5, the
blur's sums in another order)."""

import numpy as np
import pytest
import torch

from controlanimate_tpu.models import face_align as jfa
from controlanimate_tpu_torch.models import face_align as tfa


def landmarks(h, w, scale, angle, shift=(0.0, 0.0)):
    """The FFHQ template scaled to `scale` of the frame, rotated by
    `angle` and placed around the frame's centre plus `shift`."""
    c, s = np.cos(angle), np.sin(angle)
    pts = (tfa.FFHQ_TEMPLATE_512 - 256.0) * (scale * min(h, w) / 512.0)
    pts = pts @ np.array([[c, s], [-s, c]], np.float32)
    return (pts + [w / 2 + shift[0], h / 2 + shift[1]]).astype(np.float32)


CASES = {
    "centred": (0.5, 0.0, (0, 0)),
    "rotated": (0.4, 0.5, (5, -3)),
    "leaves_the_frame": (0.7, -0.3, (30, 25)),
}


def test_fits_match_jax():
    lm = landmarks(90, 70, 0.5, 0.3)
    np.testing.assert_array_equal(tfa.estimate_similarity(lm, tfa.FFHQ_TEMPLATE_512),
                                  jfa.estimate_similarity(lm, jfa.FFHQ_TEMPLATE_512))
    M = tfa.estimate_similarity(lm, tfa.FFHQ_TEMPLATE_512)
    np.testing.assert_array_equal(tfa.invert_affine(M), jfa.invert_affine(M))
    np.testing.assert_array_equal(tfa.FFHQ_TEMPLATE_512, jfa.FFHQ_TEMPLATE_512)
    assert tfa.BORDER_VALUE == jfa.BORDER_VALUE


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("face_size", [64, 512])
def test_align_face_matches_jax(case, face_size):
    frame = np.random.RandomState(len(case)).randint(0, 256, (90, 70, 3)).astype(np.uint8)
    lm = landmarks(90, 70, *CASES[case])
    want, want_M = jfa.align_face(frame, lm, face_size=face_size)
    got, M = tfa.align_face(torch.from_numpy(frame), lm, face_size=face_size)
    np.testing.assert_array_equal(M, want_M)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (diff.max(), (diff > 0).mean())
    if case == "leaves_the_frame":
        assert (want == np.array(jfa.BORDER_VALUE, np.uint8)).all(-1).any()


@pytest.mark.parametrize("upscale", [1.0, 2.0, 4.0])
@pytest.mark.parametrize("case", sorted(CASES))
def test_paste_face_matches_jax(case, upscale):
    h, w, size = 48, 40, 64
    rs = np.random.RandomState(int(upscale) + len(case))
    lm = landmarks(h, w, *CASES[case])
    _, affine = jfa.align_face(rs.randint(0, 256, (h, w, 3)).astype(np.uint8), lm,
                               face_size=size)
    restored = rs.randint(0, 256, (size, size, 3)).astype(np.uint8)
    bg = (rs.rand(int(h * upscale), int(w * upscale), 3) * 255).astype(np.float32)
    want = jfa.paste_face(bg, restored, affine, upscale_factor=upscale)
    got = tfa.paste_face(torch.from_numpy(bg), torch.from_numpy(restored), affine,
                         upscale_factor=upscale).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(want - bg).max() > 10  # the paste changed the frame
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
