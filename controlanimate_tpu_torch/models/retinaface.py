"""RetinaFace (ResNet-50) 5-point face detector.

Counterpart of `controlanimate_tpu/models/retinaface.py` (facexlib's
`detection_Resnet50_Final.pth`, the detector GFPGAN's FaceRestoreHelper
runs): a ResNet-50 body, an FPN over its last three stages, an SSH context
module a level and 1x1 class / box / landmark heads, every BatchNorm folded
into a biased conv as the JAX tree has it. The folded convs keep the names
of the checkpoint's convs (`body.layer1.0.conv1`, `fpn.output1.0`,
`ssh1.conv3X3.0`, `ClassHead.0.conv1x1`, ...), so `retinaface_state_dict`
(strip `module.`, fold each BN) gives a plain `load_state_dict`.

The network runs in fp32 on the frame's device with TF32 off, as the JAX
package computes it in fp32 whatever the run dtype, on PyTorch's own
convolutions (cuDNN picks a slow fp32 algorithm for one of its convs). The FPN's top-down
resize is `nearest-exact` (half-pixel centres, `jax.image.resize`'s
"nearest"). Anchors, the SSD decode and NMS run in numpy on the host after
one readback of the anchors over the threshold.
"""

from __future__ import annotations

import functools
import math
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.warp import fp32_convs

# facexlib's input: BGR float minus the ImageNet-caffe mean, no scaling
BGR_MEAN = (104.0, 117.0, 123.0)
# cfg_re50
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
DEFAULT_PATH = "models/Upscalers/detection_Resnet50_Final.pth"
RESNET50_STAGES = ((64, 3), (128, 4), (256, 6), (512, 3))
SSH_BRANCHES = ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")


def _folded(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    """A conv + BatchNorm pair folded into one biased conv."""
    return nn.Conv2d(cin, cout, k, stride, k // 2)


class _Seq0(nn.Module):
    """Holds the folded conv under `.0`, as the checkpoint's
    `nn.Sequential(conv, bn[, act])` names it."""

    def __init__(self, conv: nn.Conv2d):
        super().__init__()
        self.add_module("0", conv)

    def forward(self, x):
        return getattr(self, "0")(x)


class Bottleneck(nn.Module):
    """torchvision's ResNet-50 bottleneck (stride on the 3x3), BN folded."""

    def __init__(self, cin: int, mid: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1 = _folded(cin, mid, 1)
        self.conv2 = _folded(mid, mid, 3, stride)
        self.conv3 = _folded(mid, mid * 4, 1)
        self.downsample = _Seq0(_folded(cin, mid * 4, 1, stride)) if downsample else None

    def forward(self, x):
        out = F.relu(self.conv2(F.relu(self.conv1(x))))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv3(out) + identity)


class ResNet50Body(nn.Module):
    """conv1 (7x7 / 2), max pool, layer1-4; returns layer2-4's features
    (512, 1024 and 2048 channels at /8, /16, /32)."""

    def __init__(self):
        super().__init__()
        self.conv1 = _folded(3, 64, 7, 2)
        cin = 64
        for li, (mid, blocks) in enumerate(RESNET50_STAGES, start=1):
            layer = nn.Sequential(*[
                Bottleneck(cin if b == 0 else mid * 4, mid, 2 if (b == 0 and li > 1) else 1,
                           b == 0) for b in range(blocks)])
            self.add_module(f"layer{li}", layer)
            cin = mid * 4

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2, 1)
        feats = []
        for li in range(1, 5):
            x = getattr(self, f"layer{li}")(x)
            if li >= 2:
                feats.append(x)
        return feats


class FPN(nn.Module):
    def __init__(self):
        super().__init__()
        for name, cin in (("output1", 512), ("output2", 1024), ("output3", 2048)):
            self.add_module(name, _Seq0(_folded(cin, 256, 1)))
        self.merge1 = _Seq0(_folded(256, 256, 3))
        self.merge2 = _Seq0(_folded(256, 256, 3))

    def forward(self, c3, c4, c5):
        o1, o2, o3 = F.relu(self.output1(c3)), F.relu(self.output2(c4)), F.relu(self.output3(c5))
        o2 = F.relu(self.merge2(o2 + F.interpolate(o3, size=o2.shape[-2:], mode="nearest-exact")))
        o1 = F.relu(self.merge1(o1 + F.interpolate(o2, size=o1.shape[-2:], mode="nearest-exact")))
        return o1, o2, o3


class SSH(nn.Module):
    """The SSH context module: concat of a 3x3 branch and two stacked-3x3
    branches (torch key spelling kept: conv7X7_2 but conv7x7_3)."""

    def __init__(self):
        super().__init__()
        shapes = {"conv3X3": (256, 128), "conv5X5_1": (256, 64), "conv5X5_2": (64, 64),
                  "conv7X7_2": (64, 64), "conv7x7_3": (64, 64)}
        for name in SSH_BRANCHES:
            self.add_module(name, _Seq0(_folded(*shapes[name], 3)))

    def forward(self, x):
        c5_1 = F.relu(self.conv5X5_1(x))
        c7 = self.conv7x7_3(F.relu(self.conv7X7_2(c5_1)))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), c7], 1))


class _Head(nn.Module):
    def __init__(self, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(256, cout, 1)

    def forward(self, x):
        return self.conv1x1(x)


class RetinaFaceNet(nn.Module):
    """x: (N, 3, H, W) BGR minus the mean, fp32 -> (boxes (N, A, 4), class
    logits (N, A, 2), landmarks (N, A, 10)), anchors ordered (level, row,
    column, anchor) as `priors_for` lists them."""

    def __init__(self, num_anchors: int = 2):
        super().__init__()
        self.num_anchors = num_anchors
        self.body = ResNet50Body()
        self.fpn = FPN()
        self.ssh1, self.ssh2, self.ssh3 = SSH(), SSH(), SSH()
        for head, per in (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10)):
            self.add_module(head, nn.ModuleList([_Head(num_anchors * per) for _ in range(3)]))

    def forward(self, x):
        feats = self.fpn(*self.body(x))
        feats = [ssh(f) for ssh, f in zip((self.ssh1, self.ssh2, self.ssh3), feats)]
        N = x.shape[0]

        def heads(mods, per):
            return torch.cat([m(f).permute(0, 2, 3, 1).reshape(N, -1, per)
                              for m, f in zip(mods, feats)], 1)

        return heads(self.BboxHead, 4), heads(self.ClassHead, 2), heads(self.LandmarkHead, 10)


# ------------------------------------------------------------------ anchors
@functools.lru_cache(maxsize=8)
def priors_for(height: int, width: int) -> np.ndarray:
    """(A, 4) normalised anchors (cx, cy, s_kx, s_ky) of cfg_re50's PriorBox:
    level-major, then row-major cells, then min sizes. Cached: read-only."""
    out = []
    for sizes, step in zip(MIN_SIZES, STEPS):
        for i in range(math.ceil(height / step)):
            for j in range(math.ceil(width / step)):
                for m in sizes:
                    out.append([(j + 0.5) * step / width, (i + 0.5) * step / height,
                                m / width, m / height])
    arr = np.asarray(out, np.float32)
    arr.setflags(write=False)
    return arr


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """SSD box decode (variances 0.1 / 0.2) -> (A, 4) corners, normalised;
    the log-size offset clipped to +-10 against overflow on untrained
    logits, as the JAX package clips it."""
    cxcy = priors[:, :2] + loc[:, :2] * VARIANCES[0] * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(np.clip(loc[:, 2:] * VARIANCES[1], -10.0, 10.0))
    return np.concatenate([cxcy - wh / 2.0, cxcy + wh / 2.0], axis=1)


def decode_landmarks(ldm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """(A, 10) -> (A, 10) normalised (x1, y1, ..., x5, y5)."""
    pts = ldm.reshape(-1, 5, 2)
    return (priors[:, None, :2] + pts * VARIANCES[0] * priors[:, None, 2:]).reshape(-1, 10)


def nms(boxes: np.ndarray, scores: np.ndarray, thresh: float) -> list[int]:
    """Hard NMS with py_cpu_nms's +1 widths."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


# -------------------------------------------------------------- checkpoint
def _fold_bn(sd: dict, conv: str, bn: str, eps: float = 1e-5) -> dict:
    """conv (no bias) + BatchNorm2d -> the folded conv's weight and bias."""
    w = sd[f"{conv}.weight"].float()
    s = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + eps)
    return {f"{conv}.weight": w * s[:, None, None, None],
            f"{conv}.bias": sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * s}


def retinaface_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """facexlib's detection_Resnet50_Final state dict (a `module.` prefix on
    every key in some releases) -> `RetinaFaceNet`'s, each BN folded."""
    if any(k.startswith("module.") for k in sd):
        sd = {k[len("module."):]: v for k, v in sd.items()}
    sd = {k: torch.as_tensor(v) for k, v in sd.items()}
    out = _fold_bn(sd, "body.conv1", "body.bn1")
    for li, (_, blocks) in enumerate(RESNET50_STAGES, start=1):
        for b in range(blocks):
            t = f"body.layer{li}.{b}"
            for c in (1, 2, 3):
                out.update(_fold_bn(sd, f"{t}.conv{c}", f"{t}.bn{c}"))
            if b == 0:
                out.update(_fold_bn(sd, f"{t}.downsample.0", f"{t}.downsample.1"))
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        out.update(_fold_bn(sd, f"fpn.{name}.0", f"fpn.{name}.1"))
    for i in (1, 2, 3):
        for branch in SSH_BRANCHES:
            out.update(_fold_bn(sd, f"ssh{i}.{branch}.0", f"ssh{i}.{branch}.1"))
    for head in ("ClassHead", "BboxHead", "LandmarkHead"):
        for i in range(3):
            for p in ("weight", "bias"):
                out[f"{head}.{i}.conv1x1.{p}"] = sd[f"{head}.{i}.conv1x1.{p}"].float()
    return out


class RetinaFaceDetector:
    """detect_faces(frame) -> (n, 15) float32 [x0 y0 x1 y1 score, 5 x (x y)]
    sorted by score, facexlib's contract. `model` is a `RetinaFaceNet` to use
    as it is; without one, the weights are read from `model_path` and a
    missing file raises FileNotFoundError."""

    def __init__(self, model_path: Optional[str] = None, model: Optional[RetinaFaceNet] = None,
                 device="cuda"):
        self.device = torch.device(device)
        if model is None:
            path = Path(model_path or DEFAULT_PATH)
            if not path.exists():
                raise FileNotFoundError(f"RetinaFace weights not found at {path}")
            model = RetinaFaceNet()
            model.load_state_dict(retinaface_state_dict(
                torch.load(str(path), map_location="cpu", weights_only=True)))
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def detect_faces(self, frame: torch.Tensor, conf_threshold: float = 0.97,
                     nms_threshold: float = 0.4) -> np.ndarray:
        """frame: (H, W, 3) uint8 RGB, on any device."""
        frame = torch.as_tensor(frame).to(self.device)
        H, W = frame.shape[:2]
        mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=self.device)
        x = (frame.flip(-1).float() - mean).permute(2, 0, 1)[None]
        # without cuDNN: in fp32 its heuristics give ssh1's 3x3 conv at a
        # 1536x1024 frame an FFT algorithm that takes 246 ms, the network
        # 15 ms without it (NVIDIA H100 80GB HBM3)
        with fp32_convs(cudnn=False):
            box, cls, ldm = (t[0] for t in self.model(x))
        # softmax[:, 1] in the JAX package's order, on the device
        top = cls.max(dim=1).values
        e1 = torch.exp(cls[:, 1] - top)
        conf = e1 / (e1 + torch.exp(cls[:, 0] - top))
        # one readback: the rows over the threshold, with their anchor index
        # (exact in float32 below 2^24 anchors)
        anchor = torch.arange(conf.shape[0], device=self.device, dtype=torch.float32)
        rows = torch.cat([box, ldm, conf[:, None], anchor[:, None]], 1)[conf > conf_threshold]
        rows = rows.cpu().numpy()
        if len(rows) == 0:
            return np.zeros((0, 15), np.float32)
        box, ldm, scores = rows[:, :4], rows[:, 4:14], rows[:, 14]
        priors = priors_for(H, W)[rows[:, 15].astype(np.int64)]
        boxes = decode_boxes(box, priors) * np.array([W, H, W, H], np.float32)
        landms = decode_landmarks(ldm, priors) * np.tile(np.array([W, H], np.float32), 5)
        order = scores.argsort()[::-1]
        boxes, landms, scores = boxes[order], landms[order], scores[order]
        sel = nms(boxes, scores, nms_threshold)
        return np.concatenate([boxes[sel], scores[sel, None], landms[sel]], axis=1)
