"""HED and lineart, the edge networks of the ControlNet annotators.

Counterpart of `controlanimate_tpu/models/annotators/edge_nets.py`
(controlnet_aux's ControlNetHED and lineart Generator). Both run in fp32
without TF32, on the frames' batch, on cuDNN.

HED: a learned RGB offset (`norm`), five VGG stages (2, 2, 3, 3, 3 ReLU
convs of 64, 128, 256, 512, 512 channels, a 2x2 max pool before stages
2-5), a 1x1 projection to one channel after each; `hed_postprocess` takes
each stage map bilinearly (half-pixel centres) to the input size, averages
the five and applies a sigmoid. Module names follow the checkpoint's keys
(`block1.convs.0.weight`, `block1.projection.weight`, `norm`), so
`ControlNetHED.pth` loads with plain `load_state_dict` (cuDNN is faster for
HED than PyTorch's own im2col + GEMM convolutions on the H100; see PERF.md).

Lineart (`LineartGenerator`, the pix2pix generator with 3 residual blocks):
reflect-pad 3, a 7x7 conv to 64, two stride-2 3x3 convs to 128 and 256,
three residual blocks (reflect-pad 1, 3x3 conv, norm, ReLU, reflect-pad 1,
3x3 conv, norm, plus the input), two `ConvTranspose2d(stride 2, padding 1,
output_padding 1)` to 128 and 64, reflect-pad 3, a 7x7 conv to one channel
and a sigmoid; every norm is InstanceNorm2d without affine (population
variance, eps 1e-5) followed by ReLU except the residual blocks' second.
Its input is frames / 255 and the annotator's map 1 - line. Module names
follow `sk_model.pth`'s Sequential keys (`model0.1`, `model1.{0,3}`,
`model2.{i}.conv_block.{1,5}`, `model3.{0,3}`, `model4.1`), and the
checkpoint's transposed kernels (I, O, kh, kw) go into `nn.ConvTranspose2d`
as they are. Each transposed conv runs as one forward 2x2 conv to its four
output phases and a pixel shuffle (`up2x`), so that a window's map is the
same on every run, which cuDNN's transposed convolutions do not promise
(its deterministic ones took the network to 262 ms a 16-frame 512x768
window on an H100, against 193 with its default ones; PERF.md §6). One
64-channel activation of such a window is 1.6 GB in fp32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.warp import fp32_convs
from ...weights import ingest

HED_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class HEDBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, layers: int):
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels if i == 0 else out_channels, out_channels, 3, padding=1)
            for i in range(layers))
        self.projection = nn.Conv2d(out_channels, 1, 1)

    def forward(self, x, down_sample: bool = False):
        if down_sample:
            x = F.max_pool2d(x, 2, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        return x, self.projection(x)


class ControlNetHED(nn.Module):
    def __init__(self):
        super().__init__()
        self.norm = nn.Parameter(torch.zeros(1, 3, 1, 1))
        ch = 3
        for i, (out, layers) in enumerate(HED_STAGES):
            setattr(self, f"block{i + 1}", HEDBlock(ch, out, layers))
            ch = out

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: (B, 3, H, W) RGB in 0..255 -> the five (B, 1, h, w) stage maps."""
        h = x - self.norm
        maps = []
        for i in range(len(HED_STAGES)):
            h, p = getattr(self, f"block{i + 1}")(h, down_sample=i > 0)
            maps.append(p)
        return maps


def hed_postprocess(stage_maps: list[torch.Tensor], out_hw: tuple[int, int]) -> torch.Tensor:
    """(B, 1, h, w) stage maps -> (B, H, W) edge map: each map bilinearly to
    `out_hw`, the mean, a sigmoid."""
    ups = [F.interpolate(p, size=out_hw, mode="bilinear", align_corners=False)
           for p in stage_maps]
    return torch.sigmoid(torch.stack(ups).mean(dim=0))[:, 0]


class HEDAnnotator:
    """The `hed` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3) float32
    edge maps in [0, 1], the network on the frames' device in fp32."""

    def __init__(self, model: ControlNetHED):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "HEDAnnotator":
        return cls(load_fp32(ControlNetHED, path, "hed", device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(torch.float32).permute(0, 3, 1, 2)
        with fp32_convs():
            edge = hed_postprocess(self.model(x), tuple(frames.shape[1:3]))
        return edge[..., None].expand(*edge.shape, 3).contiguous()


def _norm_relu(channels: int) -> list[nn.Module]:
    return [nn.InstanceNorm2d(channels), nn.ReLU()]


class LineartResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(channels, channels, 3), *_norm_relu(channels),
            nn.ReflectionPad2d(1), nn.Conv2d(channels, channels, 3),
            nn.InstanceNorm2d(channels))

    def forward(self, x):
        return x + self.conv_block(x)


# the forward conv that stands for a stride-2 transposed conv of kernel k,
# padding p and output padding q, by (k, p, q): its kernel size, the
# padding of x (left, right, top, bottom), and the taps (dy into the padded
# input, ky into the transposed kernel) that reach output row 2m + a, for
# each phase a (and the same for columns)
_UP_GEOMETRY = {
    (3, 1, 1): (2, (0, 1, 0, 1), {0: ((0, 1),), 1: ((0, 2), (1, 0))}),
    (4, 1, 0): (3, (1, 1, 1, 1), {0: ((1, 1), (0, 3)), 1: ((2, 0), (1, 2))}),
}


def up2x(x: torch.Tensor, up: nn.ConvTranspose2d) -> torch.Tensor:
    """`up` (stride 2: 3x3 with padding 1 and output_padding 1, or 4x4 with
    padding 1) as one forward convolution of x (2x2 over x padded by a zero
    row and column at its end, or 3x3 over x padded by one all round) to
    the four output phases (channel o * 4 + a * 2 + b for output pixel
    (2m + a, 2n + b)), interleaved by `pixel_shuffle`. cuDNN's forward
    convolutions sum in the same order on every run; its transposed ones
    need not."""
    geometry = (up.kernel_size[0], up.padding[0], up.output_padding[0])
    if (up.stride != (2, 2) or up.kernel_size[0] != up.kernel_size[1]
            or up.padding[0] != up.padding[1] or up.output_padding[0] != up.output_padding[1]
            or geometry not in _UP_GEOMETRY):
        raise ValueError(f"up2x takes no transposed conv of kernel {up.kernel_size}, stride "
                         f"{up.stride}, padding {up.padding}, output padding {up.output_padding}")
    size, pad, taps = _UP_GEOMETRY[geometry]
    w = up.weight  # (I, O, k, k)
    k = w.new_zeros(w.shape[1], 2, 2, w.shape[0], size, size)  # (o, a, b, i, dy, dx)
    for a, rows in taps.items():
        for b, cols in taps.items():
            for dy, ky in rows:
                for dx, kx in cols:
                    k[:, a, b, :, dy, dx] = w[:, :, ky, kx].T
    y = F.conv2d(F.pad(x, pad), k.flatten(0, 2), up.bias.repeat_interleave(4))
    return F.pixel_shuffle(y, 2)


# the residual blocks of `sk_model.pth`'s generator
LINEART_RES_BLOCKS = 3


class LineartGenerator(nn.Module):
    """controlnet_aux's lineart Generator(3, 1, n_residual_blocks=3)."""

    def __init__(self):
        super().__init__()
        self.model0 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(3, 64, 7), *_norm_relu(64))
        self.model1 = nn.Sequential(nn.Conv2d(64, 128, 3, stride=2, padding=1), *_norm_relu(128),
                                    nn.Conv2d(128, 256, 3, stride=2, padding=1),
                                    *_norm_relu(256))
        self.model2 = nn.Sequential(*(LineartResBlock(256) for _ in range(LINEART_RES_BLOCKS)))
        self.model3 = nn.Sequential(
            nn.ConvTranspose2d(256, 128, 3, stride=2, padding=1, output_padding=1),
            *_norm_relu(128),
            nn.ConvTranspose2d(128, 64, 3, stride=2, padding=1, output_padding=1),
            *_norm_relu(64))
        self.model4 = nn.Sequential(nn.ReflectionPad2d(3), nn.Conv2d(64, 1, 7), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 3, H, W) RGB in [0, 1] -> (B, 1, H, W) line map."""
        h = self.model2(self.model1(self.model0(x)))
        up = self.model3
        h = up[2](up[1](up2x(h, up[0])))
        h = up[5](up[4](up2x(h, up[3])))
        return self.model4(h)


def load_fp32(make: Callable[[], nn.Module], path: Path, what: str, device,
              convert: Callable[[dict], dict] = dict) -> nn.Module:
    """`make()` with the fp32 weights of the checkpoint at `path`, their keys
    and values taken through `convert` on the host, on `device`
    (FileNotFoundError naming `what` when the file is absent)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"the {what} annotator needs its weights at {path}")
    with torch.device("meta"):
        model = make()
    sd = {k: v.to(device=device, dtype=torch.float32)
          for k, v in convert(ingest.load_state_dict(path)).items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.eval()


class LineartAnnotator:
    """The `lineart` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 maps in [0, 1] (1 - the generator's line map), the network on
    the frames' device in fp32."""

    def __init__(self, model: LineartGenerator):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "LineartAnnotator":
        return cls(load_fp32(LineartGenerator, path, "lineart", device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(torch.float32).permute(0, 3, 1, 2) / 255.0
        with fp32_convs():
            line = self.model(x)[:, 0]
        return (1.0 - line)[..., None].expand(*line.shape, 3).contiguous()
