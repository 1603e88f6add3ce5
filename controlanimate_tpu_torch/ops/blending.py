"""Overlap blending of consecutive windows, on the device.

Counterpart of `controlanimate_tpu/ops/blending.py`: overlap slot i of the new
window is blended with the previous window's version of that slot with
alpha_i = (K - i - 0.5) / K of the previous one, computed in fp32, so earlier
slots keep more of the previous window and the weight fades towards the new
content.
"""

from __future__ import annotations

import torch


def blend_overlap(new_frames: torch.Tensor, prev_frames: torch.Tensor) -> torch.Tensor:
    """(K, H, W, 3) head of the current window and the previous window's
    (K, H, W, 3) versions of those slots -> new * (1 - a) + prev * a."""
    K = new_frames.shape[0]
    i = torch.arange(K, dtype=torch.float32, device=new_frames.device)
    alpha = ((K - i - 0.5) / K)[:, None, None, None]
    return new_frames * (1.0 - alpha) + prev_frames.to(new_frames.dtype) * alpha


def blend_overlap_u8(new_frames: torch.Tensor, prev_frames: torch.Tensor) -> torch.Tensor:
    """uint8 in, uint8 out: the blend in fp32, + 0.5, clipped."""
    out = blend_overlap(new_frames.float(), prev_frames.float())
    return torch.clamp(out + 0.5, 0.0, 255.0).to(torch.uint8)
