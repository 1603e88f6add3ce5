"""HED, the edge network of the ControlNet annotators.

Counterpart of the HED half of `controlanimate_tpu/models/annotators/edge_nets.py`
(controlnet_aux's ControlNetHED): a learned RGB offset (`norm`), five VGG
stages (2, 2, 3, 3, 3 ReLU convs of 64, 128, 256, 512, 512 channels, a 2x2
max pool before stages 2-5), a 1x1 projection to one channel after each;
`hed_postprocess` takes each stage map bilinearly (half-pixel centres) to the
input size, averages the five and applies a sigmoid. Module names follow the
checkpoint's keys (`block1.convs.0.weight`, `block1.projection.weight`,
`norm`), so `ControlNetHED.pth` loads with plain `load_state_dict`. The
network runs in fp32 without TF32, on the frames' batch, on cuDNN (faster
for HED than PyTorch's own im2col + GEMM convolutions on the H100; see
PERF.md).
"""

from __future__ import annotations

from pathlib import Path

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
        path = Path(path)
        if not path.is_file():
            raise FileNotFoundError(f"the hed annotator needs its weights at {path}")
        with torch.device("meta"):
            model = ControlNetHED()
        sd = {k: v.to(device=device, dtype=torch.float32)
              for k, v in ingest.load_state_dict(path).items()}
        model.load_state_dict(sd, strict=True, assign=True)
        return cls(model)

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        x = frames.to(torch.float32).permute(0, 3, 1, 2)
        with fp32_convs():
            edge = hed_postprocess(self.model(x), tuple(frames.shape[1:3]))
        return edge[..., None].expand(*edge.shape, 3).contiguous()
