"""Lineart-anime, the anime line annotator of the ControlNets.

Counterpart of `controlanimate_tpu/models/annotators/lineart_anime.py`
(controlnet_aux's LineartAnimeDetector, `netG.pth`): pix2pix's
`UnetGenerator(3, 1, num_downs=8, ngf=64)`, built recursively from the
outermost level in. Each level is a 4x4 stride-2 conv down (bias) and a 4x4
stride-2 transposed conv up (padding 1, bias); going down a LeakyReLU(0.2)
before the conv (not at the outermost level) and an InstanceNorm2d without
affine after it (population variance, eps 1e-5; not at the outermost or
innermost level); going up a ReLU before the transposed conv and, below
the outermost level, an InstanceNorm2d after it and the level's input
concatenated in front; at the outermost level a tanh. Channels (out, in)
from the outermost level: (1, ngf), (ngf, 2 ngf), (2 ngf, 4 ngf), (4 ngf,
8 ngf), then (8 ngf, 8 ngf) to the innermost. Module names follow
`netG.pth`'s Sequential keys (`model.model.{0,3}`, `model.model.1.model.
{1,5}`, `...1.model.3.model.{1,5}`, the innermost `.{1,3}`), so it loads
with plain `load_state_dict`. Each transposed conv runs as one forward 3x3
conv to its four output phases and a pixel shuffle (`edge_nets.up2x`), so
that a window's map is the same on every run.

The annotator resizes the frames to the next multiple of 256 on each side
(INTER_CUBIC on uint8, `ops/resize.py`; an identity at 512x512 and
512x768), runs the network on frames / 127.5 - 1, takes (y + 1) / 2 back to
the frame's size (INTER_CUBIC on float32) and returns 1 - that map,
repeated to three channels. As in the JAX package, the map is neither
clipped nor quantised to uint8 before it is inverted (controlnet_aux does
both).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.resize import resize_cubic
from ...ops.warp import fp32_convs
from .edge_nets import load_fp32, up2x

# the network's input sides are multiples of this (8 stride-2 levels)
SIDE_MULTIPLE = 256


def ladder(ngf: int = 64, num_downs: int = 8) -> list[tuple[int, int]]:
    """(outer, inner) channels of each level, the outermost first."""
    levels = [(1, ngf), (ngf, ngf * 2), (ngf * 2, ngf * 4), (ngf * 4, ngf * 8)]
    return levels + [(ngf * 8, ngf * 8)] * (num_downs - 4)


class UnetSkipBlock(nn.Module):
    """One level of the U-Net and, inside it, the levels below."""

    def __init__(self, levels: list[tuple[int, int]], in_channels: int, outermost: bool = False):
        super().__init__()
        outer, inner = levels[0]
        innermost = len(levels) == 1
        self.outermost = outermost
        down = nn.Conv2d(in_channels, inner, 4, stride=2, padding=1)
        up = nn.ConvTranspose2d(inner if innermost else inner * 2, outer, 4, stride=2, padding=1)
        if outermost:
            layers = [down, UnetSkipBlock(levels[1:], inner), nn.ReLU(), up, nn.Tanh()]
        elif innermost:
            layers = [nn.LeakyReLU(0.2), down, nn.ReLU(), up, nn.InstanceNorm2d(outer)]
        else:
            layers = [nn.LeakyReLU(0.2), down, nn.InstanceNorm2d(inner),
                      UnetSkipBlock(levels[1:], inner), nn.ReLU(), up, nn.InstanceNorm2d(outer)]
        self.model = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for layer in self.model:
            h = up2x(h, layer) if isinstance(layer, nn.ConvTranspose2d) else layer(h)
        return h if self.outermost else torch.cat([x, h], dim=1)


class UnetGenerator(nn.Module):
    """pix2pix's UnetGenerator(3, 1, num_downs, ngf) with InstanceNorm."""

    def __init__(self, ngf: int = 64, num_downs: int = 8):
        super().__init__()
        self.model = UnetSkipBlock(ladder(ngf, num_downs), 3, outermost=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) in [-1, 1], H and W multiples of 2^num_downs ->
        (B, 1, H, W) in [-1, 1]."""
        return self.model(x)


class LineartAnimeAnnotator:
    """The `lineart_anime` annotator: (F, H, W, 3) uint8 frames -> (F, H, W,
    3) float32 maps (1 - the line map, in [0, 1] up to the cubic resize's
    overshoot), the network on the frames' device in fp32."""

    def __init__(self, model: UnetGenerator):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "LineartAnimeAnnotator":
        return cls(load_fp32(UnetGenerator, path, "lineart_anime", device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        _, H, W, _ = frames.shape
        Hp = SIDE_MULTIPLE * -(-H // SIDE_MULTIPLE)
        Wp = SIDE_MULTIPLE * -(-W // SIDE_MULTIPLE)
        x = resize_cubic(frames, Hp, Wp).to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
        with fp32_convs():
            y = (self.model(x) + 1) / 2  # (F, 1, Hp, Wp)
        line = 1.0 - resize_cubic(y.permute(0, 2, 3, 1).contiguous(), H, W)
        return line.expand(*line.shape[:3], 3).contiguous()
