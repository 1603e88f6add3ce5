"""Lanczos4 resize of uint8 frames, as OpenCV's `cv2.resize(...,
interpolation=cv2.INTER_LANCZOS4)` computes it for 8-bit images.

The JAX package resizes the upscaler's x4 output to the configured scale with
`cv2.resize` (`controlanimate_tpu/models/upscaler.py` `_post_resize`,
`scripts/vid2vid.py` `_upscale_frames`); the port does it in plain PyTorch
on the frames' device. OpenCV's 8-bit path (`resizeGeneric_` with
`HResizeLanczos4` / `VResizeLanczos4`):

- source coordinate of output column dx: fx = float((dx + 0.5) / inv_scale -
  0.5), sx = floor(fx), fx -= sx; taps sx - 3 .. sx + 4, clamped to the image
  (OpenCV's border rule here: the edge pixel repeats);
- 8 Lanczos (a = 4) weights of fx, normalised to sum 1, then to fixed point:
  round(w * 2048) as int16;
- a horizontal pass to int32 rows (u8 * int16, no rounding), then a vertical
  pass: (sum_k beta_k * row_k + 2^21) >> 22, saturated to 0..255.

The weight tables are computed on the host in OpenCV's precisions (fx in
float32, the sines in float64, the weights in float32); the two passes run on
the device in integer arithmetic.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048
_S45 = 0.70710678118654752440084436210485
_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1),
       (-_S45, _S45))


def _lanczos4_weights(fx: np.float32) -> np.ndarray:
    """OpenCV's `interpolateLanczos4`: 8 float32 weights of the fraction fx."""
    if fx < np.finfo(np.float32).eps:
        w = np.zeros(8, np.float32)
        w[3] = 1.0
        return w
    x3 = np.float32(fx + np.float32(3))  # OpenCV sums x + 3 (- i) in float
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    w = np.empty(8, np.float32)
    total = np.float32(0.0)
    for i in range(8):
        y = -float(np.float32(x3 - np.float32(i))) * math.pi * 0.25
        w[i] = np.float32((_CS[i][0] * s0 + _CS[i][1] * c0) / (y * y))
        total = np.float32(total + w[i])
    return (w * np.float32(np.float32(1.0) / total)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def lanczos4_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices (dst, 8) int64 clamped to [0, src), weights (dst, 8) int64 in
    fixed point) for one axis of a resize from `src` to `dst` pixels; cached,
    so both are read-only."""
    scale = 1.0 / (dst / src)  # OpenCV: scale_x = 1. / inv_scale_x
    idx = np.empty((dst, 8), np.int64)
    coef = np.empty((dst, 8), np.int64)
    for d in range(dst):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(fx)
        fx = np.float32(fx - np.float32(sx))
        idx[d] = np.clip(np.arange(sx - 3, sx + 5), 0, src - 1)
        # saturate_cast<short>(w * 2048): round half to even, as cvRound
        coef[d] = np.rint(_lanczos4_weights(fx) * np.float32(COEF_SCALE)).astype(np.int64)
    idx.setflags(write=False)
    coef.setflags(write=False)
    return idx, coef


def resize_lanczos4(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(F, H, W, C) uint8 -> (F, height, width, C) uint8 on the frames' device."""
    if frames.dtype != torch.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (F, H, W, C) uint8, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    _, H, W, _ = frames.shape
    dev = frames.device
    xi, xc = (torch.tensor(t, device=dev) for t in lanczos4_table(W, width))
    yi, yc = (torch.tensor(t, device=dev) for t in lanczos4_table(H, height))
    src = frames.to(torch.int32)
    # horizontal: int32 rows, exact (|sum| < 255 * 2048 * 2)
    rows = torch.zeros(frames.shape[0], H, width, frames.shape[3], dtype=torch.int32, device=dev)
    for k in range(8):
        rows += src[:, :, xi[:, k], :] * xc[:, k].to(torch.int32)[None, None, :, None]
    # vertical: int64 sums, then the rounding shift and saturation
    acc = torch.zeros(frames.shape[0], height, width, frames.shape[3], dtype=torch.int64,
                      device=dev)
    for k in range(8):
        acc += rows[:, yi[:, k]].to(torch.int64) * yc[:, k][None, :, None, None]
    out = (acc + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)
    return out.clamp_(0, 255).to(torch.uint8)
