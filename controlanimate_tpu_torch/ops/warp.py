"""OpenCV's affine warp, erosion and Gaussian blur on the frames' device.

The JAX package's face path aligns and pastes faces with three OpenCV calls
on the host (`controlanimate_tpu/models/face_align.py`): `cv2.warpAffine`
(INTER_LINEAR, BORDER_CONSTANT), `cv2.erode` with a square kernel and
`cv2.GaussianBlur(ksize, 0)`. The port has no OpenCV; these are the same
functions in plain PyTorch, on uint8 or float32 images (H, W, C):

- `warp_affine` follows OpenCV 5's INTER_LINEAR warp (the float path that
  replaced the 1/32-pixel fixed-point remap in OpenCV 4.11, under the
  default ALGO_HINT_ACCURATE): the 2x3 matrix is inverted in float64 and
  rounded to float32; output column x of row y reads the source at
  fma(x, M0, float(y * M1) + M2) (and likewise for y) in the vector loop,
  which covers the columns below the last multiple of 16 up to the width,
  and at float(fma(x, M0, y * M1)) + M2 in the scalar loop after it (as
  compiled for AVX2: 16 columns a step); the four taps are blended with
  fused multiply-adds, v0 = fma(p01 - p00, ax, p00), v1 likewise, then
  fma(v1 - v0, ay, v0), each tap outside the image taking the border value;
  uint8 output rounds half to even. A fused multiply-add is computed in
  float64 (the product of two float32 values is exact there) and rounded to
  float32 once.
- `erode`: a k x k minimum whose window starts k // 2 before the pixel;
  pixels outside the image count as the type's maximum
  (`morphologyDefaultBorderValue`), so the frame edge does not erode.
- `gaussian_blur`: OpenCV's separable kernel for sigma 0 (the fixed 3-, 5-,
  7- and 9-tap tables, else exp(-x^2 / (2 sigma^2)) with sigma =
  0.15 k + 0.35, normalised in float64, rounded to float32), rows then
  columns, BORDER_REFLECT_101, as two depthwise convolutions in fp32
  (`fp32_convs`: TF32 off).
"""

from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch
import torch.nn.functional as F

VECTOR_COLUMNS = 16  # columns a step of OpenCV's vector loop (AVX2)
# getGaussianKernel's fixed kernels for sigma <= 0
_SMALL_GAUSSIAN = {1: (1.0,), 3: (0.25, 0.5, 0.25), 5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
                   7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
                   9: (0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375, 0.19921875,
                       0.1171875, 0.05078125, 0.015625)}


# the backend flags are process-wide: blocks on two threads (the loop's
# annotating prefetch worker and its face step) take turns, so that each
# restores what it found
_FLAGS_LOCK = threading.RLock()


@contextlib.contextmanager
def fp32_convs(cudnn: bool = True):
    """Convolutions and matmuls in full fp32 (no TF32) inside the block, the
    settings restored after it; with `cudnn` False, PyTorch's own im2col +
    GEMM convolutions instead of cuDNN's."""
    with _FLAGS_LOCK:
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
                yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved


def _inverse_float32(M) -> np.ndarray:
    """The dst -> src matrix warpAffine samples with: M inverted in float64
    as OpenCV does it, rounded to float32."""
    m = np.asarray(M, np.float64).reshape(6).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, -m[1] * d, -m[3] * d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return m.astype(np.float32)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32(a * b + c) with one rounding, for float32 tensors."""
    return (a.double() * b.double() + c.double()).float()


def _source_coords(m: np.ndarray, width: int, height: int, device) -> tuple:
    """(sx, sy), each (height, width) float32: where warpAffine samples."""
    x = torch.arange(width, device=device, dtype=torch.float32)[None, :]
    y = torch.arange(height, device=device, dtype=torch.float32)[:, None]
    vec_end = VECTOR_COLUMNS * (width // VECTOR_COLUMNS)
    in_vector = (torch.arange(width, device=device) < vec_end)[None, :]
    f32 = lambda v: torch.tensor(float(v), dtype=torch.float32, device=device)  # noqa: E731
    out = []
    for m0, m1, m2 in ((m[0], m[1], m[2]), (m[3], m[4], m[5])):
        ym1 = y * f32(m1)  # float32 product
        vector = _fma(x, f32(m0), ym1 + f32(m2))
        scalar = _fma(x, f32(m0), ym1) + f32(m2)
        out.append(torch.where(in_vector, vector, scalar))
    return out[0], out[1]


def warp_affine(src: torch.Tensor, M, dsize: tuple[int, int], border_value=0.0) -> torch.Tensor:
    """`cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR,
    borderMode=BORDER_CONSTANT, borderValue=border_value)`: src (H, W, C)
    uint8 or float32 on any device, M the 2x3 src -> dst matrix (host),
    dsize (width, height). Returns (height, width, C) of src's dtype."""
    if src.ndim != 3 or src.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"src must be (H, W, C) uint8 or float32, got {src.dtype} "
                         f"{tuple(src.shape)}")
    H, W, C = src.shape
    width, height = int(dsize[0]), int(dsize[1])
    dev = src.device
    sx, sy = _source_coords(_inverse_float32(M), width, height, dev)
    ix, iy = torch.floor(sx), torch.floor(sy)
    ax, ay = (sx - ix)[..., None], (sy - iy)[..., None]
    ix, iy = ix.long(), iy.long()
    bv = np.broadcast_to(np.asarray(border_value, np.float64), (C,))
    border = torch.tensor(bv, dtype=torch.float32, device=dev)
    flat = src.reshape(H * W, C).float()

    def tap(dy: int, dx: int) -> torch.Tensor:
        yy, xx = iy + dy, ix + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        idx = (yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)).reshape(-1)
        return torch.where(inside[..., None], flat[idx].reshape(height, width, C), border)

    p00, p01, p10, p11 = tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)
    v0 = _fma(p01 - p00, ax, p00)
    v1 = _fma(p11 - p10, ax, p10)
    v = _fma(v1 - v0, ay, v0)
    if src.dtype == torch.uint8:
        return torch.round(v).clamp_(0, 255).to(torch.uint8)
    return v


def erode(img: torch.Tensor, k: int) -> torch.Tensor:
    """`cv2.erode(img, np.ones((k, k), np.uint8))` for (H, W) or (H, W, C)
    float32 or uint8 images."""
    if k <= 1:
        return img.clone()
    big = torch.finfo(img.dtype).max if img.dtype.is_floating_point else torch.iinfo(img.dtype).max
    x = img if img.ndim == 3 else img[..., None]
    # the anchor sits at k // 2: the window covers [p - k // 2, p + k - 1 - k // 2]
    lo, hi = k // 2, k - 1 - k // 2
    h = x.permute(2, 0, 1)[None].float() if img.dtype == torch.uint8 else x.permute(2, 0, 1)[None]
    h = F.pad(-h, (lo, hi, lo, hi), value=-float(big))
    out = -F.max_pool2d(h, (k, k), stride=1)
    out = out[0].permute(1, 2, 0).to(img.dtype)
    return out if img.ndim == 3 else out[..., 0]


def gaussian_kernel(k: int) -> np.ndarray:
    """`cv2.getGaussianKernel(k, 0, CV_32F)` as a float32 vector."""
    if k in _SMALL_GAUSSIAN:
        return np.asarray(_SMALL_GAUSSIAN[k], np.float32)
    sigma = k * 0.15 + 0.35
    x = np.arange(k, dtype=np.float64) - (k - 1) * 0.5
    t = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (t / t.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """`cv2.GaussianBlur(img, (k, k), 0)` for (H, W) or (H, W, C) float32
    images, k odd."""
    if k % 2 != 1:
        raise ValueError(f"the kernel size must be odd, got {k}")
    x = img if img.ndim == 3 else img[..., None]
    C, r = x.shape[-1], k // 2
    w = torch.from_numpy(gaussian_kernel(k)).to(img.device).expand(C, 1, k)
    h = x.permute(2, 0, 1)[None]  # (1, C, H, W)
    with fp32_convs():
        h = F.conv2d(F.pad(h, (r, r, 0, 0), mode="reflect"), w[:, :, None, :], groups=C)
        h = F.conv2d(F.pad(h, (0, 0, r, r), mode="reflect"), w[:, :, :, None], groups=C)
    out = h[0].permute(1, 2, 0)
    return out if img.ndim == 3 else out[..., 0]
