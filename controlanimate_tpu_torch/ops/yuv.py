"""RGB -> YUV420p (I420) on the device, and the host inverse for tests.

Counterpart of `controlanimate_tpu/ops/yuv.py`: BT.601 limited range with
2x2-averaged chroma, the matrix ffmpeg's swscale applies to rgb24 input, so
an encoder fed I420 gets what it would have made itself from RGB. Packing on
the device halves the per-frame readback (1.5 bytes a pixel against 3).
"""

from __future__ import annotations

import numpy as np
import torch


def rgb_to_yuv420(frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) uint8 RGB -> (F, H*W*3//2) uint8 planar I420. H and W
    must be even."""
    f = frames.float()
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 16.0 + (65.738 * r + 129.057 * g + 25.064 * b) / 256.0
    u = 128.0 + (-37.945 * r - 74.494 * g + 112.439 * b) / 256.0
    v = 128.0 + (112.439 * r - 94.154 * g - 18.285 * b) / 256.0
    F, H, W = y.shape
    u = u.reshape(F, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    v = v.reshape(F, H // 2, 2, W // 2, 2).mean(dim=(2, 4))
    packed = torch.cat([y.reshape(F, -1), u.reshape(F, -1), v.reshape(F, -1)], dim=1)
    return torch.clamp(packed + 0.5, 0.0, 255.0).to(torch.uint8)


def yuv420_to_rgb_host(buf: np.ndarray, height: int, width: int) -> np.ndarray:
    """(F, H*W*3//2) uint8 I420 -> (F, H, W, 3) uint8 RGB on the host
    (nearest chroma upsampling)."""
    buf = np.asarray(buf)
    F = buf.shape[0]
    n = height * width
    y = buf[:, :n].reshape(F, height, width).astype(np.float32)
    u = buf[:, n:n + n // 4].reshape(F, height // 2, width // 2).astype(np.float32)
    v = buf[:, n + n // 4:].reshape(F, height // 2, width // 2).astype(np.float32)
    u = u.repeat(2, axis=1).repeat(2, axis=2)
    v = v.repeat(2, axis=1).repeat(2, axis=2)
    c, d, e = y - 16.0, u - 128.0, v - 128.0
    r = (298.082 * c + 408.583 * e) / 256.0
    g = (298.082 * c - 100.291 * d - 208.120 * e) / 256.0
    b = (298.082 * c + 516.412 * d) / 256.0
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(rgb + 0.5, 0, 255).astype(np.uint8)
