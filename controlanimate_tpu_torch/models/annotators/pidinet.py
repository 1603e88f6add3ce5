"""PidiNet, the softedge annotator of the ControlNets.

Counterpart of `controlanimate_tpu/models/annotators/pidinet.py`
(controlnet_aux's PidiNetDetector, `table5_pidinet.pth`, the carv4 config
with 24 dilation channels and spatial attention). It runs in fp32 without
TF32, on the frames' batch, on cuDNN.

Pixel-difference convolutions (PDC) are plain convolutions once their
kernels are folded, which the loader does once (`pdc_kernel`): `cv` as
read; `cd` (central difference) the 3x3 kernel less its tap sum at the
centre; `ad` (angular difference) the kernel less its clockwise rotation;
`rd` (radial difference) a 5x5 kernel, the eight outer taps on the ring and
their negatives on the inner ring, at padding 2. The stem is the stride-2
`cd` conv (padding 1), so the first stage runs at half the frame's size,
rounded up, as in the JAX package.

Network: four stages of 3, 4, 4 and 4 `PDCBlock`s (60, 120, 240 and 240
channels; depthwise PDC, ReLU, 1x1 conv, plus the input); stages 2-4 start
with a 2x2 max pool (rounding down) and a 1x1 `shortcut` with bias. Each
stage's output goes through CDCM (ReLU, a 1x1 conv to 24 channels, four 3x3
convs at dilations 5, 7, 9 and 11, summed), CSAM (the input times a
sigmoid of ReLU, 1x1 to 4, 3x3 to 1) and a 1x1 reduce to one channel, is
taken bilinearly (half-pixel centres, as `edge_nets.hed_postprocess`) to
the frame's size; the four maps go through a 1x1 `classifier` and a
sigmoid. Module names follow the checkpoint's keys once its `module.`
prefix is stripped (`init_block`, `block{s}_{b}.conv1/conv2/shortcut`,
`dilations.{i}.conv1/conv2_{j}`, `attentions.{i}.conv1/conv2`,
`conv_reduces.{i}.conv`, `classifier`); the real file nests them under
`state_dict`, which `weights/ingest.py` unwraps.

The annotator takes frames / 255 in RGB, as the JAX `run` does
(controlnet_aux flips them to BGR first), and returns the map repeated to
three channels.
"""

from __future__ import annotations

from typing import Iterator

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.warp import fp32_convs
from .edge_nets import load_fp32

# the PDC kind of the stem and of each block, in order
CARV4 = ("cd", "ad", "rd", "cv") * 4
# (channels, blocks) of each stage
STAGES = ((60, 3), (120, 4), (240, 4), (240, 4))
DILATION_CHANNELS = 24
DILATIONS = (5, 7, 9, 11)

# the 3x3 taps (row-major) of the clockwise rotation `ad` subtracts, and the
# 5x5 taps that take `rd`'s eight outer taps and their negatives
_AD_ROTATION = (3, 0, 1, 6, 4, 2, 7, 8, 5)
_RD_RING = (0, 2, 4, 10, 14, 20, 22, 24)
_RD_INNER = (6, 7, 8, 11, 13, 16, 17, 18)


def pdc_kernel(kind: str, w: torch.Tensor) -> torch.Tensor:
    """A PDC's (O, I, 3, 3) kernel as the plain conv kernel that computes it
    (3x3 at padding 1; 5x5 at padding 2 for `rd`)."""
    if kind == "cv":
        return w
    if kind == "cd":
        k = w.clone()
        k[:, :, 1, 1] = w[:, :, 1, 1] - w.sum((2, 3))
        return k
    flat = w.flatten(2)
    if kind == "ad":
        return (flat - flat[:, :, list(_AD_ROTATION)]).reshape(w.shape)
    if kind == "rd":
        buf = w.new_zeros(*w.shape[:2], 25)
        buf[:, :, list(_RD_RING)] = flat[:, :, 1:]
        buf[:, :, list(_RD_INNER)] = -flat[:, :, 1:]
        return buf.reshape(*w.shape[:2], 5, 5)
    raise ValueError(f"unknown PDC kind {kind!r}")


def pdc_weights() -> Iterator[tuple[str, str]]:
    """(state-dict key, PDC kind) of every PDC kernel, the stem first."""
    yield "init_block.weight", CARV4[0]
    li = 1
    for s, (_, n) in enumerate(STAGES, start=1):
        for b in range(1, n + 1):
            yield f"block{s}_{b}.conv1.weight", CARV4[li]
            li += 1


def _depthwise(kind: str, channels: int) -> nn.Conv2d:
    size = 5 if kind == "rd" else 3
    return nn.Conv2d(channels, channels, size, padding=size // 2, groups=channels, bias=False)


class PDCBlock(nn.Module):
    def __init__(self, kind: str, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = _depthwise(kind, in_channels)
        self.conv2 = nn.Conv2d(in_channels, out_channels, 1, bias=False)
        if stride > 1:
            self.shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        if self.stride > 1:
            x = F.max_pool2d(x, 2, 2)
        y = self.conv2(F.relu(self.conv1(x)))
        if self.stride > 1:
            x = self.shortcut(x)
        return x + y


class CDCM(nn.Module):
    """Compact dilation conv module: four dilated 3x3 convs, summed."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, out_channels, 1)
        for j, d in enumerate(DILATIONS, start=1):
            setattr(self, f"conv2_{j}", nn.Conv2d(out_channels, out_channels, 3, padding=d,
                                                  dilation=d, bias=False))

    def forward(self, x):
        x = self.conv1(F.relu(x))
        out = self.conv2_1(x)
        for j in range(2, len(DILATIONS) + 1):
            out = out + getattr(self, f"conv2_{j}")(x)
        return out


class CSAM(nn.Module):
    """Compact spatial attention module."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, 4, 1)
        self.conv2 = nn.Conv2d(4, 1, 3, padding=1, bias=False)

    def forward(self, x):
        return x * torch.sigmoid(self.conv2(self.conv1(F.relu(x))))


class MapReduce(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, 1, 1)

    def forward(self, x):
        return self.conv(x)


class PiDiNet(nn.Module):
    """PiDiNet(60, carv4, dil=24, sa=True) with folded PDC kernels."""

    def __init__(self):
        super().__init__()
        ch = STAGES[0][0]
        self.init_block = nn.Conv2d(3, ch, 3, stride=2, padding=1, bias=False)
        li = 1
        for s, (out, n) in enumerate(STAGES, start=1):
            for b in range(1, n + 1):
                stride = 2 if s > 1 and b == 1 else 1
                setattr(self, f"block{s}_{b}", PDCBlock(CARV4[li], ch, out, stride))
                ch = out
                li += 1
        self.dilations = nn.ModuleList(CDCM(c, DILATION_CHANNELS) for c, _ in STAGES)
        self.attentions = nn.ModuleList(CSAM(DILATION_CHANNELS) for _ in STAGES)
        self.conv_reduces = nn.ModuleList(MapReduce(DILATION_CHANNELS) for _ in STAGES)
        self.classifier = nn.Conv2d(len(STAGES), 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) RGB in [0, 1] -> (B, 1, H, W) edge map in [0, 1]."""
        out_hw = tuple(x.shape[2:])
        h = self.init_block(x)
        maps = []
        for s, (_, n) in enumerate(STAGES, start=1):
            for b in range(1, n + 1):
                h = getattr(self, f"block{s}_{b}")(h)
            i = s - 1
            m = self.conv_reduces[i](self.attentions[i](self.dilations[i](h)))
            maps.append(F.interpolate(m, size=out_hw, mode="bilinear", align_corners=False))
        return torch.sigmoid(self.classifier(torch.cat(maps, dim=1)))


def pidinet_state_dict_from_torch(sd: dict) -> dict:
    """`table5_pidinet.pth`'s state dict (keys with or without the
    `module.` prefix) -> the port's `PiDiNet` state dict: the prefix
    stripped and every PDC kernel folded (`pdc_kernel`)."""
    out = {k.removeprefix("module."): v for k, v in sd.items()}
    for key, kind in pdc_weights():
        out[key] = pdc_kernel(kind, out[key])
    return out


class PidiNetAnnotator:
    """The `softedge` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 edge maps in [0, 1], the network on the frames' device in
    fp32."""

    def __init__(self, model: PiDiNet):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "PidiNetAnnotator":
        return cls(load_fp32(PiDiNet, path, "softedge", device, pidinet_state_dict_from_torch))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(torch.float32).permute(0, 3, 1, 2) / 255.0
        with fp32_convs():
            edge = self.model(x)[:, 0]
        return edge[..., None].expand(*edge.shape, 3).contiguous()
