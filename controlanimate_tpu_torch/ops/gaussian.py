"""`scipy.ndimage.gaussian_filter(m, sigma)` of float32 maps, bit for bit, on
the maps' device.

The OpenPose annotator smooths its heat maps with it before the peak test
(`controlanimate_tpu/models/annotators/openpose.py` `_find_peaks`, and the
hand and face heat in `openpose_hand_face.py` / `openpose_face.py`), sigma 3.
scipy's path (`gaussian_filter1d` on axis 0, then axis 1, `correlate1d`):

- weights exp(-x^2 / (2 sigma^2)) for x in -r..r, r = int(4 sigma + 0.5),
  over their sum, in float64 as numpy computes them (`gaussian_weights`);
- mode `reflect`: the map extended as (d c b a | a b c d | d c b a);
- each output, for the symmetric weights, in float64 as
  x[0] w[0] + (x[-j] + x[j]) w[j] for j = r down to 1, in that order, then
  rounded to the input's dtype (float32), which is what the second axis
  reads.

The float64 sums run on the device as separate products and sums, so that
no multiply-add is fused.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .host import upload


@functools.lru_cache(maxsize=8)
def gaussian_weights(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy's `_gaussian_kernel1d(sigma, 0, r)` from the centre out:
    (r + 1,) float64; cached, read-only."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    phi = phi / phi.sum()
    out = phi[radius:].copy()
    out.setflags(write=False)
    return out


def reflect_index(n: int, radius: int) -> np.ndarray:
    """Source index of positions -radius .. n + radius - 1 under scipy's
    `reflect` extension of an n-long line."""
    i = np.arange(-radius, n + radius) % (2 * n)
    return np.where(i < n, i, 2 * n - 1 - i)


@functools.lru_cache(maxsize=16)
def _reflect_on(n: int, radius: int, device: str) -> torch.Tensor:
    return upload([reflect_index(n, radius)], device)[0]


def _sums(xp: torch.Tensor, dim: int, n: int, w: np.ndarray) -> torch.Tensor:
    """scipy's float64 sums over the extended lines `xp` (radius r = len(w)
    - 1 on each side along `dim`), rounded to float32."""
    r = len(w) - 1
    acc = xp.narrow(dim, r, n) * float(w[0])
    for j in range(r, 0, -1):
        acc = acc + (xp.narrow(dim, r - j, n) + xp.narrow(dim, r + j, n)) * float(w[j])
    return acc.to(torch.float32)


def gaussian_filter(m: torch.Tensor, sigma: float = 3.0) -> torch.Tensor:
    """(..., H, W) float32 maps, each smoothed as
    `scipy.ndimage.gaussian_filter(map, sigma)` (rows, then columns)."""
    if m.dtype != torch.float32 or m.ndim < 2:
        raise ValueError(f"maps must be (..., H, W) float32, got {m.dtype} {tuple(m.shape)}")
    w = gaussian_weights(float(sigma))
    r = len(w) - 1
    for dim in (m.ndim - 2, m.ndim - 1):
        n = m.shape[dim]
        m = _sums(m.index_select(dim, _reflect_on(n, r, str(m.device))).to(torch.float64),
                  dim, n, w)
    return m


def gaussian_filter_sizes(m: torch.Tensor, sizes: np.ndarray, sigma: float = 3.0) -> torch.Tensor:
    """(B, P, S, S) float32 maps whose b-th holds P square maps of side
    sizes[b] <= S in its top-left corner: each smoothed as
    `scipy.ndimage.gaussian_filter(map, sigma)` on its own side (the rest
    of the output is not used)."""
    w = gaussian_weights(float(sigma))
    r = len(w) - 1
    S = m.shape[2]
    (idx,) = upload([np.stack([reflect_index(int(s), r + S - int(s))[S - int(s):]
                               for s in sizes])], m.device)  # (B, S + 2r)
    for dim in (2, 3):
        shape = [m.shape[0], m.shape[1], S, S]
        shape[dim] = S + 2 * r
        view = [m.shape[0], 1, 1, 1]
        view[dim] = S + 2 * r
        xp = m.gather(dim, idx.view(view).expand(shape)).to(torch.float64)
        m = _sums(xp, dim, S, w)
    return m
