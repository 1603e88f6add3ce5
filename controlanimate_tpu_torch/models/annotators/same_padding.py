"""TF's "SAME" padding, which NormalBae's EfficientNet and DPT-hybrid's BiT
backbone use: from the input's size, the odd pixel of padding at the
bottom or right (so (0, 1) for a 3x3 at stride 2 on an even side, and (2,
3) for a 7x7)."""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn


def same_pads(x, kernel_size, stride) -> list[int]:
    """F.pad's (left, right, top, bottom) for a window of `kernel_size` (kh,
    kw) at `stride` (sh, sw) over the last two dimensions of `x`."""
    pads = []
    for size, k, s in zip(x.shape[:1:-1], kernel_size[::-1], stride[::-1]):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return pads


class Conv2dSame(nn.Conv2d):
    """A conv padded as TF's "SAME" (gen-efficientnet's Conv2dSame)."""

    def forward(self, x):
        return F.conv2d(F.pad(x, same_pads(x, self.kernel_size, self.stride)), self.weight,
                        self.bias, self.stride, 0, 1, self.groups)
