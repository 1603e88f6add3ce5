"""MLSD, the line-segment annotator, on the frames' device.

Counterpart of `controlanimate_tpu/models/annotators/mlsd_net.py` (and of
`mlsd.py` when `mlsd_large_512_fp32.pth` is present; without it the JAX
package falls back to `cv2.HoughLinesP` and the port raises
FileNotFoundError).

The network (`MLSDLarge`, controlnet_aux's MobileV2_MLSD_Large): a
MobileNetV2 trunk (a stride-2 3x3 stem to 32 channels and the 13 inverted
residuals of `IR_SPEC`, ReLU6, depthwise convs as `groups=C`) with taps at
features 1, 3, 6, 10 and 13, and a decoder of BlockA (two 1x1 convs with
ReLU, the deeper one upsampled 2x bilinearly with half-pixel centres, then
concatenated), BlockB (a 3x3 conv with ReLU plus its input, then a 3x3
conv) and BlockC (a 5-dilated 3x3 and a 3x3 conv with ReLU, a 1x1 conv) to
a 16-channel tpMap at half the 512x512 input. Every BatchNorm is folded into
its conv when the checkpoint is read (`fold_bn`, in float32 on the host in
the JAX loader's order), so the module holds plain convs named as the JAX
parameters (`stem`, `ir_{i}.conv_{j}`, `block{15..22}.conv{1..3}`).

`run`: each frame to 512x512 by INTER_AREA (`ops/resize.py`), a fourth
channel of 255, x / 127.5 - 1, the network in fp32 without TF32, the decode,
the segments drawn (`ops/draw.py`), the 512x512 map back to (H, W) by
INTER_NEAREST, / 255, three channels. The decode (`decode_segments`), for
all frames at once, with no host sync:

- heat = 1 / (1 + exp(-centre)) in float32 (exp in float64, rounded, so
  that the card and the CPU agree; numpy's float32 exp, which the JAX
  package's decode runs, may differ from it in the last bit);
- the peaks: heat equal to its 5x5 maximum (zero padding, as scipy's
  `maximum_filter(mode="constant")` with heat > 0);
- the 200 largest peaks by `torch.topk`, a tie going to the lower index
  (numpy's `argpartition` may pick other members of a tie across the 200th
  rank: ROADMAP §3 (v)), those with heat >= float32(0.1) kept;
- ends (x + dx, y + dy) in float64, as numpy adds an int64 index to float32
  displacements; a segment of length <= 10 dropped; ends at the 512 scale
  trunc(2 * v), as `int()` truncates.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.draw import lines
from ...ops.resize import resize_area, resize_nearest
from ...ops.warp import fp32_convs
from .edge_nets import load_fp32

# MobileNetV2 features 1..13: (expansion, out channels, stride); the stem is
# features[0]
IR_SPEC = ((1, 16, 1), (6, 24, 2), (6, 24, 1), (6, 32, 2), (6, 32, 1), (6, 32, 1), (6, 64, 2),
           (6, 64, 1), (6, 64, 1), (6, 64, 1), (6, 96, 1), (6, 96, 1), (6, 96, 1))
FPN_TAPS = (1, 3, 6, 10, 13)
INPUT_SIZE = 512
TOPK, SCORE_THR, DIST_THR = 200, 0.1, 20.0


def relu6(x):
    return x.clamp(0.0, 6.0)


class InvertedResidual(nn.Module):
    def __init__(self, in_c: int, expand: int, out_c: int, stride: int):
        super().__init__()
        hidden = in_c * expand
        convs = []
        if expand != 1:
            convs.append(nn.Conv2d(in_c, hidden, 1))
        convs.append(nn.Conv2d(hidden, hidden, 3, stride=stride, padding=1, groups=hidden))
        convs.append(nn.Conv2d(hidden, out_c, 1))
        for j, conv in enumerate(convs):
            setattr(self, f"conv_{j}", conv)
        self.n = len(convs)
        self.residual = stride == 1 and in_c == out_c

    def forward(self, x):
        h = x
        for j in range(self.n - 1):
            h = relu6(getattr(self, f"conv_{j}")(h))
        h = getattr(self, f"conv_{self.n - 1}")(h)
        return x + h if self.residual else h


class BlockA(nn.Module):
    def __init__(self, in_a: int, in_b: int, out_a: int, out_b: int, upscale: bool = True):
        super().__init__()
        self.conv1 = nn.Conv2d(in_b, out_b, 1)
        self.conv2 = nn.Conv2d(in_a, out_a, 1)
        self.upscale = upscale

    def forward(self, a, b):
        b = F.relu(self.conv1(b))
        a = F.relu(self.conv2(a))
        if self.upscale:
            b = F.interpolate(b, size=(2 * b.shape[2], 2 * b.shape[3]), mode="bilinear",
                              align_corners=False)
        return torch.cat([a, b], 1)


class BlockB(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, in_c, 3, padding=1)
        self.conv2 = nn.Conv2d(in_c, out_c, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)) + x)


class BlockC(nn.Module):
    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv1 = nn.Conv2d(in_c, in_c, 3, padding=5, dilation=5)
        self.conv2 = nn.Conv2d(in_c, in_c, 3, padding=1)
        self.conv3 = nn.Conv2d(in_c, out_c, 1)

    def forward(self, x):
        return self.conv3(F.relu(self.conv2(F.relu(self.conv1(x)))))


class MLSDLarge(nn.Module):
    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(4, 32, 3, stride=2, padding=1)
        c, taps = 32, {}
        for i, (e, out, s) in enumerate(IR_SPEC, start=1):
            setattr(self, f"ir_{i}", InvertedResidual(c, e, out, s))
            c = out
            taps[i] = c
        c1, c2, c3, c4, c5 = (taps[i] for i in FPN_TAPS)
        self.block15 = BlockA(c4, c5, 64, 64, upscale=False)
        self.block16 = BlockB(128, 64)
        self.block17 = BlockA(c3, 64, 64, 64)
        self.block18 = BlockB(128, 64)
        self.block19 = BlockA(c2, 64, 64, 64)
        self.block20 = BlockB(128, 64)
        self.block21 = BlockA(c1, 64, 64, 64)
        self.block22 = BlockC(128, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, 4, 512, 512) in [-1, 1] -> tpMap (B, 16, 256, 256)."""
        h = relu6(self.stem(x))
        taps = []
        for i in range(1, len(IR_SPEC) + 1):
            h = getattr(self, f"ir_{i}")(h)
            if i in FPN_TAPS:
                taps.append(h)
        c1, c2, c3, c4, c5 = taps
        h = self.block16(self.block15(c4, c5))
        h = self.block18(self.block17(c3, h))
        h = self.block20(self.block19(c2, h))
        return self.block22(self.block21(c1, h))


def fold_bn(sd: dict, conv: str, bn: str, eps: float = 1e-5):
    """The conv `conv` with the BatchNorm `bn` folded in, float32 on the
    host: w * g / sqrt(v + eps), (b or 0) * scale + beta - mean * scale (the
    square root correctly rounded, as numpy's; PyTorch's float32 one on the
    CPU is not always)."""
    f32 = lambda k: sd[k].to(torch.float32)  # noqa: E731
    root = torch.sqrt((f32(f"{bn}.running_var") + eps).double()).float()
    scale = f32(f"{bn}.weight") / root
    w = f32(f"{conv}.weight") * scale[:, None, None, None]
    b = f32(f"{conv}.bias") * scale if f"{conv}.bias" in sd else 0.0 * scale
    return w, b + f32(f"{bn}.bias") - f32(f"{bn}.running_mean") * scale


def mlsd_state_dict_from_torch(sd: dict) -> dict[str, torch.Tensor]:
    """`mlsd_large_512_fp32.pth`'s keys (backbone.features.*, block15..22
    with Sequential conv / BN pairs) -> `MLSDLarge`'s, BatchNorms folded (the
    JAX `mlsd_params_from_torch`)."""
    out: dict[str, torch.Tensor] = {}

    def put(name, conv, bn):
        out[f"{name}.weight"], out[f"{name}.bias"] = fold_bn(sd, conv, bn)

    fx = "backbone.features"
    put("stem", f"{fx}.0.0", f"{fx}.0.1")
    for i, (e, _, _) in enumerate(IR_SPEC, start=1):
        p = f"{fx}.{i}.conv"
        if e == 1:  # [ConvBNReLU(dw), conv, bn]
            put(f"ir_{i}.conv_0", f"{p}.0.0", f"{p}.0.1")
            put(f"ir_{i}.conv_1", f"{p}.1", f"{p}.2")
        else:  # [ConvBNReLU(expand), ConvBNReLU(dw), conv, bn]
            put(f"ir_{i}.conv_0", f"{p}.0.0", f"{p}.0.1")
            put(f"ir_{i}.conv_1", f"{p}.1.0", f"{p}.1.1")
            put(f"ir_{i}.conv_2", f"{p}.2", f"{p}.3")
    for b in range(15, 22):
        for c in ("conv1", "conv2"):
            put(f"block{b}.{c}", f"block{b}.{c}.0", f"block{b}.{c}.1")
    put("block22.conv1", "block22.conv1.0", "block22.conv1.1")
    put("block22.conv2", "block22.conv2.0", "block22.conv2.1")
    for k in ("weight", "bias"):
        out[f"block22.conv3.{k}"] = sd[f"block22.conv3.{k}"].to(torch.float32)
    return out


def heat_map(centre: torch.Tensor) -> torch.Tensor:
    """The float32 sigmoid of the centre logits, exp taken in float64."""
    e = torch.exp(-centre.double()).to(torch.float32)
    return 1.0 / (1.0 + e)


def decode_segments(tp: torch.Tensor):
    """(N, 16, h, w) tpMaps -> the ends of each frame's TOPK candidate
    segments at twice the map's scale, (N, TOPK, 2) int64 (x, y) each, and an
    (N, TOPK) mask of those kept (heat >= 0.1, length > DIST_THR / 2)."""
    n, _, h, w = tp.shape
    heat = heat_map(tp[:, 0])
    hmax = F.max_pool2d(heat[:, None], 5, stride=1, padding=2)[:, 0]
    heat = torch.where(heat == hmax, heat, torch.zeros_like(heat)).reshape(n, -1)
    # ties go to the lower index, on every device: the key is the (positive)
    # float's bits above the reversed index
    pos = torch.arange(h * w, device=tp.device)
    key = heat.view(torch.int32).to(torch.int64) << 32 | (h * w - 1 - pos)
    idx = torch.topk(key, TOPK, dim=1).indices
    scores = torch.gather(heat, 1, idx)
    y, x = idx // w, idx % w
    disp = tp[:, 1:5].reshape(n, 4, -1).double()
    d = torch.gather(disp, 2, idx[:, None].expand(n, 4, TOPK))
    x1, y1, x2, y2 = x + d[:, 0], y + d[:, 1], x + d[:, 2], y + d[:, 3]
    keep = ((scores >= torch.tensor(SCORE_THR, dtype=torch.float32))
            & (torch.hypot(x2 - x1, y2 - y1) > DIST_THR / 2.0))
    to_px = lambda v: (2.0 * v).to(torch.int64)  # noqa: E731  (int() truncates)
    return (torch.stack([to_px(x1), to_px(y1)], -1), torch.stack([to_px(x2), to_px(y2)], -1),
            keep)


def draw_segments(tp: torch.Tensor) -> torch.Tensor:
    """(N, 16, h, w) tpMaps -> (N, 2h, 2w) uint8 line maps (255 on the
    segments)."""
    p1, p2, keep = decode_segments(tp)
    return lines(p1, p2, keep, 2 * tp.shape[2], 2 * tp.shape[3])


class MLSDAnnotator:
    """The `mlsd` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 maps in {0, 1}, on the frames' device."""

    def __init__(self, model: MLSDLarge):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "MLSDAnnotator":
        return cls(load_fp32(MLSDLarge, path, "mlsd", device, mlsd_state_dict_from_torch))

    @torch.no_grad()
    def tp_map(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) uint8 -> the network's (F, 16, 256, 256) tpMaps."""
        x = resize_area(frames, INPUT_SIZE, INPUT_SIZE)
        x = torch.cat([x, torch.full_like(x[..., :1], 255)], -1)
        x = x.to(torch.float32).permute(0, 3, 1, 2) / 127.5 - 1.0
        with fp32_convs():
            return self.model(x)

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        canvas = draw_segments(self.tp_map(frames))
        canvas = resize_nearest(canvas[..., None], *frames.shape[1:3])
        return (canvas.to(torch.float32) / 255.0).expand(*canvas.shape[:3], 3).contiguous()
