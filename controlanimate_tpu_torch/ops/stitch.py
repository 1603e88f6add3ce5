"""The per-window stitch of the vid2vid loop, on the device.

Counterpart of `controlanimate_tpu/ops/stitch.py` `stitch_window`: color
match against the anchor -> the new anchor and the last outputs -> blend of
the head with the previous window's overlap -> the tail kept for the next
window -> the emitted slice -> optional I420 packing for the encoder; and of
its segment-batched form `stitch_window_batch`, which applies `stitch_window`
to each segment of a lockstep window (JAX vmaps the same function).

Every tensor it returns is new: it never writes into its inputs, and nothing
it returns shares storage with them, so the loop's state may keep references
(a checkpoint snapshot holds them while the next window runs).
"""

from __future__ import annotations

from typing import Optional

import torch

from .blending import blend_overlap_u8
from .color_match import match_colors_u8
from .yuv import rgb_to_yuv420


def stitch_window(frames: torch.Tensor, anchor: Optional[torch.Tensor],
                  prev_overlap: Optional[torch.Tensor], *, overlap_length: int,
                  to_yuv: bool, emit: int):
    """frames: (F, H, W, 3) uint8; anchor: (H, W, 3) or None; prev_overlap:
    (K, H, W, 3) or None. Returns (emitted, new_anchor, last_output_frames,
    overlap_tail): emitted is (emit, H, W, 3) uint8, or (emit, H*W*3//2) I420
    with `to_yuv`; the last two are None when overlap_length is 0."""
    if anchor is not None:
        frames = match_colors_u8(frames, anchor)
    new_anchor = frames[max(overlap_length - 1, -1)].clone()
    last_out = frames[-overlap_length:].clone() if overlap_length > 0 else None
    if prev_overlap is not None and prev_overlap.shape[0] > 0:
        K = prev_overlap.shape[0]
        head = blend_overlap_u8(frames[:K], prev_overlap.to(frames.device))
        frames = torch.cat([head, frames[K:]])
    tail = frames[-overlap_length:].clone() if overlap_length > 0 else None
    emitted = frames[:emit]
    packed = rgb_to_yuv420(emitted) if to_yuv else emitted.clone()
    return packed, new_anchor, last_out, tail


def stitch_window_batch(frames: torch.Tensor, anchor: Optional[torch.Tensor],
                        prev_overlap: Optional[torch.Tensor], *, overlap_length: int,
                        to_yuv: bool, emit: int):
    """`stitch_window` on each segment of a lockstep window. frames: (S, F, H,
    W, 3) uint8; anchor: (S, H, W, 3) or None; prev_overlap: (S, K, H, W, 3)
    or None. Returns the four outputs of `stitch_window`, each stacked on a
    leading segment axis (None where `stitch_window` gives None)."""
    per_segment = [
        stitch_window(frames[s], None if anchor is None else anchor[s],
                      None if prev_overlap is None else prev_overlap[s],
                      overlap_length=overlap_length, to_yuv=to_yuv, emit=emit)
        for s in range(frames.shape[0])]
    return tuple(None if parts[0] is None else torch.stack(parts)
                 for parts in zip(*per_segment))
