"""Canny edges on the frames' device, bit for bit as `cv2.Canny(frame, 100, 200)`.

Counterpart of the `canny` annotator of the JAX package
(`controlanimate_tpu/models/annotators/__init__.py`, which runs OpenCV on the
host). OpenCV's algorithm on an RGB uint8 frame, in int32:
  * a 3x3 Sobel of each channel with replicated borders; at each pixel the
    channel with the largest L1 magnitude |dx| + |dy| gives dx, dy and the
    magnitude (the first channel on a tie);
  * non-maximum suppression in fixed point: TG22 = round(tan(22.5) * 2^15),
    |dy| << 15 against |dx| * TG22 (horizontal sector: the left neighbour
    strictly below, the right one not above) and |dx| * TG22 + (|dx| << 16)
    (vertical: the upper neighbour strictly, the lower one not), else the
    diagonal whose sign dx * dy picks, both strictly; magnitudes outside the
    image count as 0;
  * thresholds, both strict: a candidate has m > low, a seed m > high;
  * hysteresis: the 8-connected components of the candidates that hold a
    seed. OpenCV grows them from a stack; here they are labelled on the
    device by rounds of neighbour minima, hooking and pointer jumping until
    nothing changes (`hysteresis`, checked every `CHECK_EVERY` rounds).
"""

from __future__ import annotations

import torch

TG22 = int(0.4142135623730950488016887242097 * (1 << 15) + 0.5)
CHECK_EVERY = 4  # label rounds between convergence checks (one host sync each)
JUMPS = 2  # pointer jumps a round


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """x[..., i + dy, j + dx] over (..., H, W), `fill` outside."""
    H, W = x.shape[-2:]
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, H), slice(0, H - dy)) if dy >= 0 else (slice(0, H + dy), slice(-dy, H))
    xs, xd = (slice(dx, W), slice(0, W - dx)) if dx >= 0 else (slice(0, W + dx), slice(-dx, W))
    out[..., yd, xd] = x[..., ys, xs]
    return out


def sobel_l1(frames: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(F, H, W, C) uint8 -> (dx, dy, magnitude), each (F, H, W) int32, from
    the channel of largest |dx| + |dy| at each pixel (the first on a tie)."""
    x = frames.to(torch.int32).permute(0, 3, 1, 2)  # (F, C, H, W)
    H, W = x.shape[-2:]
    rows = torch.arange(-1, H + 1, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-1, W + 1, device=x.device).clamp(0, W - 1)
    p = x.index_select(2, rows).index_select(3, cols)  # replicated border
    # separable: [-1 0 1] along one axis, [1 2 1] along the other
    d = p[..., :, 2:] - p[..., :, :W]
    dx = d[..., :H, :] + 2 * d[..., 1:H + 1, :] + d[..., 2:, :]
    d = p[..., 2:, :] - p[..., :H, :]
    dy = d[..., :W] + 2 * d[..., 1:W + 1] + d[..., 2:]
    mag = dx.abs() + dy.abs()
    # a later channel wins only when strictly larger (OpenCV's `>`)
    bdx, bdy, bmag = dx[:, 0], dy[:, 0], mag[:, 0]
    for c in range(1, x.shape[1]):
        take = mag[:, c] > bmag
        bdx = torch.where(take, dx[:, c], bdx)
        bdy = torch.where(take, dy[:, c], bdy)
        bmag = torch.where(take, mag[:, c], bmag)
    return bdx, bdy, bmag


def nms_candidates(dx: torch.Tensor, dy: torch.Tensor, mag: torch.Tensor,
                   low: int) -> torch.Tensor:
    """(F, H, W) bool: the pixels above `low` that survive OpenCV's fixed-point
    non-maximum suppression."""
    ax, ay = dx.abs(), dy.abs() << 15
    tg22x = ax * TG22
    tg67x = tg22x + (ax << 16)
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg67x)
    diagonal = ~horizontal & ~vertical
    left, right = _shift(mag, 0, -1, 0), _shift(mag, 0, 1, 0)
    up, down = _shift(mag, -1, 0, 0), _shift(mag, 1, 0, 0)
    # same signs: up-left and down-right; opposite signs: up-right and down-left
    same = (dx ^ dy) >= 0
    diag_a = torch.where(same, _shift(mag, -1, -1, 0), _shift(mag, -1, 1, 0))
    diag_b = torch.where(same, _shift(mag, 1, 1, 0), _shift(mag, 1, -1, 0))
    keep = ((horizontal & (mag > left) & (mag >= right))
            | (vertical & (mag > up) & (mag >= down))
            | (diagonal & (mag > diag_a) & (mag > diag_b)))
    return keep & (mag > low)


def hysteresis(candidates: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """(F, H, W) bool: the 8-connected components of `candidates` (within a
    frame) that hold a pixel of `seeds`.

    Each candidate holds a label, the index of a candidate of its component
    no larger than its own (its own at first). A round takes each
    candidate's smallest neighbouring label, lowers its label's label to it
    (hooking, a scatter-min), then jumps labels to their labels' labels
    `JUMPS` times. Labels only fall and stay in their component; once a
    round changes nothing, every component holds one label."""
    n = candidates.numel()
    big = n  # larger than every label: the non-candidates
    flat_cand = candidates.reshape(-1)
    idx = torch.arange(n, device=candidates.device)
    labels = torch.where(flat_cand, idx, big)
    tail = torch.full((1,), big, device=candidates.device, dtype=labels.dtype)
    while True:
        before = labels
        for _ in range(CHECK_EVERY):
            grid = labels.reshape(candidates.shape)
            m = grid
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy or dx:
                        m = torch.minimum(m, _shift(grid, dy, dx, big))
            m = m.reshape(-1)[flat_cand]
            table = torch.cat([labels, tail])
            table.scatter_reduce_(0, labels[flat_cand], m, reduce="amin")
            labels = table[labels]
            for _ in range(JUMPS):
                labels = torch.cat([labels, tail])[labels]
        if torch.equal(labels, before):
            break
    has_seed = torch.zeros(n + 1, dtype=torch.bool, device=candidates.device)
    has_seed[labels[seeds.reshape(-1)]] = True
    return candidates & has_seed[labels].reshape(candidates.shape)


def canny(frames: torch.Tensor, low: int = 100, high: int = 200) -> torch.Tensor:
    """(F, H, W, 3) uint8 frames -> (F, H, W, 3) float32 edge maps of 0 or 1
    (`cv2.Canny(frame, low, high)` / 255 on each frame, in all channels)."""
    if frames.dtype != torch.uint8 or frames.ndim != 4:
        raise TypeError(f"canny takes (F, H, W, C) uint8 frames, got {frames.dtype} "
                        f"{tuple(frames.shape)}")
    dx, dy, mag = sobel_l1(frames)
    candidates = nms_candidates(dx, dy, mag, low)
    edges = hysteresis(candidates, candidates & (mag > high))
    return edges.float()[..., None].expand(*edges.shape, 3).contiguous()

