"""Line drawing on the frames' device, bit for bit as OpenCV draws.

`lines` is `cv2.line(canvas, p1, p2, 255, 1)` (thickness 1, LINE_8) for all
of a batch's segments at once, as the MLSD annotator draws its segments
(`controlanimate_tpu/models/annotators/mlsd_net.py` `run`). OpenCV's path,
in int64:

- `clipLine` against the canvas [0, W - 1] x [0, H - 1]: outcodes (bit 1
  x < 0, 2 x > right, 4 y < 0, 8 y > bottom); a segment with both ends on
  one side is dropped; otherwise an end outside in y moves to the edge row
  (x += trunc(float64(a - y) * (x2 - x1) / (y2 - y1)), the second end from
  the first's new place), then an end outside in x to the edge column
  alike; the segment is drawn only if both outcodes end at 0;
- `LineIterator(..., 8, leftToRight=true)`: the ends swap when x2 < x1;
  along the major axis (y when |dy| > |dx|) each of the max(|dx|, |dy|) + 1
  pixels steps by one, and the minor coordinate steps on the error rule
  err = L - 2m, err -= 2m each step, += 2L when it was negative (L, m the
  major and minor lengths). After k steps the minor axis has moved
  ceil((2 m k - L) / (2 L)) times, which is what `lines` computes for every
  pixel of every segment at once.
"""

from __future__ import annotations

import torch


def _outcode(x, y, right: int, bottom: int):
    return (x < 0).long() | (x > right).long() << 1 | (y < 0).long() << 2 | (y > bottom).long() << 3


def _trunc_step(num, factor, den):
    """OpenCV's (int64)((double)num * factor / den), den 0 taken as 1 (the
    lanes where it is 0 are not used)."""
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num.double() * factor.double() / den.double()).to(torch.int64)


def clip_segments(p1: torch.Tensor, p2: torch.Tensor, height: int, width: int):
    """OpenCV's `clipLine` for (..., 2) int64 (x, y) ends: the clipped ends
    and whether anything of each segment is left on the canvas."""
    right, bottom = width - 1, height - 1
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    c1, c2 = _outcode(x1, y1, right, bottom), _outcode(x2, y2, right, bottom)
    clip = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    # an end outside in y moves to the edge row
    m = clip & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(m, x1 + _trunc_step(a - y1, x2 - x1, y2 - y1), x1)
    y1 = torch.where(m, a, y1)
    c1 = torch.where(m, (x1 < 0).long() | (x1 > right).long() << 1, c1)
    m = clip & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(m, x2 + _trunc_step(a - y2, x2 - x1, y2 - y1), x2)
    y2 = torch.where(m, a, y2)
    c2 = torch.where(m, (x2 < 0).long() | (x2 > right).long() << 1, c2)
    # then an end outside in x to the edge column
    clip = clip & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = clip & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    y1 = torch.where(m, y1 + _trunc_step(a - x1, y2 - y1, x2 - x1), y1)
    x1 = torch.where(m, a, x1)
    c1 = torch.where(m, 0, c1)
    m = clip & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    y2 = torch.where(m, y2 + _trunc_step(a - x2, y2 - y1, x2 - x1), y2)
    x2 = torch.where(m, a, x2)
    c2 = torch.where(m, 0, c2)
    return torch.stack([x1, y1], -1), torch.stack([x2, y2], -1), (c1 | c2) == 0


def lines(p1: torch.Tensor, p2: torch.Tensor, keep: torch.Tensor, height: int,
          width: int) -> torch.Tensor:
    """(N, S, 2) int64 (x, y) ends and an (N, S) bool mask of the segments to
    draw -> (N, height, width) uint8 canvases with 255 on every pixel that
    `cv2.line(canvas, p1, p2, 255, 1)` sets, for each segment of each canvas
    in turn, and 0 elsewhere."""
    n = p1.shape[0]
    dev = p1.device
    p1, p2, visible = clip_segments(p1, p2, height, width)
    keep = keep & visible
    # leftToRight: the ends swap when x2 < x1
    swap = (p2[..., 0] < p1[..., 0])[..., None]
    p1, p2 = torch.where(swap, p2, p1), torch.where(swap, p1, p2)
    dx = p2[..., 0] - p1[..., 0]
    dy = p2[..., 1] - p1[..., 1]
    sy = torch.where(dy < 0, -1, 1)
    ady = dy.abs()
    vert = ady > dx
    major = torch.maximum(dx, ady)
    minor = torch.minimum(dx, ady)
    k = torch.arange(max(height, width), device=dev)
    L, mm = major[..., None], minor[..., None]
    moved = torch.div(2 * mm * k + L - 1, torch.clamp(2 * L, min=1), rounding_mode="floor")
    moved = torch.where(L == 0, 0, moved)
    vx = vert[..., None]
    x = p1[..., 0, None] + torch.where(vx, moved, k)
    y = p1[..., 1, None] + sy[..., None] * torch.where(vx, k, moved)
    on = keep[..., None] & (k <= L)
    # every pixel not drawn goes to one spare slot past the canvases
    flat = torch.arange(n, device=dev)[:, None, None] * (height * width) + y * width + x
    flat = torch.where(on, flat, n * height * width)
    canvas = torch.zeros(n * height * width + 1, dtype=torch.uint8, device=dev)
    canvas.index_fill_(0, flat.reshape(-1), 255)
    return canvas[:-1].reshape(n, height, width)
