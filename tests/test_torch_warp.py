"""The port's OpenCV stand-ins (`ops/warp.py`) against cv2 itself, which the
JAX face path calls: `warp_affine` (INTER_LINEAR, BORDER_CONSTANT) on uint8
and float32 images over random similarity and general affines, rotations,
scales and crops that leave the frame; `erode` with square kernels of even
and odd size; `gaussian_blur` at sigma 0 for every kernel size the paste
mask uses, and `gaussian_kernel` for every odd size up to 201.

Gates: uint8 within 1 LSB with under 1% of values off by one (seen: equal),
float32 within 1e-4 absolute on values up to 255 (seen: equal); the erosion
exact; the blur within 1e-5 on a [0, 1] mask (seen: 2.4e-7, the row and
column sums in another order); the kernels exact."""

import cv2
import numpy as np
import pytest
import torch

from controlanimate_tpu_torch.ops.warp import erode, gaussian_blur, gaussian_kernel, warp_affine


def _case(seed):
    """(src, M, dsize, border) of a random warp: half the sources uint8,
    large sources every third case, a rotated and scaled similarity or a
    general affine, translated so parts of the output leave the frame."""
    rs = np.random.RandomState(seed)
    big = seed % 3 == 0
    H, W = (rs.randint(200, 400), rs.randint(200, 500)) if big else rs.randint(10, 90, 2)
    if seed % 2 == 0:
        src = rs.randint(0, 256, (H, W, 3)).astype(np.uint8)
    else:
        src = (rs.rand(H, W, 3) * 255).astype(np.float32)
    ang, s = rs.rand() * 2 * np.pi, 0.3 + rs.rand() * 3
    A = s * np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    if seed % 4 == 3:
        A = A + rs.randn(2, 2) * 0.3  # a general affine: shear and uneven scales
    M = np.concatenate([A, [[rs.randn() * W / 3], [rs.randn() * H / 3]]], 1).astype(np.float32)
    dsize = (int(rs.randint(17, 300)), int(rs.randint(17, 300)))
    if seed % 5 == 0:
        dsize = (16 * (dsize[0] // 16), dsize[1])  # no scalar tail after the vector loop
    border = (135, 133, 132) if seed % 4 < 2 else (0, 0, 0)
    return src, M, dsize, border


@pytest.mark.parametrize("seed", range(16))
def test_warp_affine_matches_cv2(seed):
    src, M, dsize, border = _case(seed)
    want = cv2.warpAffine(src, M, dsize, flags=cv2.INTER_LINEAR,
                          borderMode=cv2.BORDER_CONSTANT, borderValue=border)
    got = warp_affine(torch.from_numpy(src), M, dsize, border).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    if src.dtype == np.uint8:
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())
    else:
        assert diff.max() <= 1e-4, diff.max()


def test_warp_affine_identity_and_outside():
    """An integer shift copies pixels; an output wholly outside the source
    is the border value."""
    src = np.random.RandomState(0).randint(0, 256, (20, 30, 3)).astype(np.uint8)
    shift = np.array([[1, 0, 3], [0, 1, -2]], np.float32)
    got = warp_affine(torch.from_numpy(src), shift, (30, 20), (135, 133, 132)).numpy()
    np.testing.assert_array_equal(got[:18, 3:], src[2:, :27])  # dst(x + 3, y - 2) = src(x, y)
    away = np.array([[1, 0, 500], [0, 1, 500]], np.float32)
    got = warp_affine(torch.from_numpy(src), away, (8, 8), (135, 133, 132)).numpy()
    assert (got == np.array([135, 133, 132], np.uint8)).all()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7, 12])
def test_erode_matches_cv2(k):
    rs = np.random.RandomState(k)
    mask = ((rs.rand(50, 70) > 0.3) * rs.rand(50, 70)).astype(np.float32)
    want = cv2.erode(mask, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(erode(torch.from_numpy(mask), k).numpy(), want)


@pytest.mark.parametrize("k", [1, 3, 5, 7, 9, 15, 31])
def test_gaussian_blur_matches_cv2(k):
    mask = np.random.RandomState(k).rand(60, 80).astype(np.float32)
    want = cv2.GaussianBlur(mask, (k, k), 0)
    np.testing.assert_allclose(gaussian_blur(torch.from_numpy(mask), k).numpy(), want, atol=1e-5)


def test_gaussian_kernels_match_cv2():
    for k in range(1, 202, 2):
        want = cv2.getGaussianKernel(k, 0, cv2.CV_32F).ravel()
        np.testing.assert_array_equal(gaussian_kernel(k), want, err_msg=str(k))


def test_fp32_convs_restores_the_flags_across_threads():
    """The backend flags are process-wide: blocks entered on many threads at
    once (the loop's annotating worker beside its face step) each see TF32
    off inside and leave the flags as they found them."""
    import sys
    import threading

    from controlanimate_tpu_torch.ops.warp import fp32_convs

    saved, interval = torch.backends.cuda.matmul.allow_tf32, sys.getswitchinterval()
    torch.backends.cuda.matmul.allow_tf32 = True
    errors = []

    def work():
        for _ in range(300):
            with fp32_convs(cudnn=False):
                if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.enabled:
                    errors.append("flags changed inside a block")

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors
        assert torch.backends.cuda.matmul.allow_tf32 is True and torch.backends.cudnn.enabled
    finally:
        sys.setswitchinterval(interval)
        torch.backends.cuda.matmul.allow_tf32 = saved

