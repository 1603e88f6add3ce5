"""NormalBae, the surface-normal annotator of the ControlNets.

Counterpart of `controlanimate_tpu/models/annotators/normalbae_net.py` and
`normalbae.py` (controlnet_aux's NormalBaeDetector: the NNET of "Estimating
and Exploiting the Aleatoric Uncertainty in Surface Normal Estimation",
`scannet.pt`, on a gen-efficientnet `tf_efficientnet_b5_ap` backbone). It
runs in fp32 without TF32, on the frames' batch, on cuDNN.

Encoder (`EfficientNet`, geometry `NNETConfig`, B5 by default): a stride-2
3x3 `conv_stem` with BatchNorm and SiLU, then seven stages of MBConv
blocks. Stage 0 is `DepthwiseSeparable` (depthwise conv, BN, SiLU,
squeeze-excite, 1x1 `conv_pw`, BN, no activation), the others
`InvertedResidual` (1x1 expansion, BN, SiLU, depthwise conv, BN, SiLU,
squeeze-excite, 1x1 projection, BN); a block adds its input when its stride
is 1 and its width unchanged. Squeeze-excite reduces to a quarter of the
block's input width, not of its expanded one. Every conv of stride 2 (the
stem and the first depthwise conv of stages 1, 2, 3 and 5) pads as TF's
"SAME" does (`Conv2dSame`): from its input's size, the extra row or column
at the bottom or right, so (0, 1) for a 3x3 and (1, 2) for a 5x5 on an even
side. The decoder takes stages 0, 1, 2 and 4 and `conv_head`'s raw output
(its BatchNorm `bn2` unused).

Decoder (`Decoder`, the dense test-mode NNET): a 1x1 `conv2`, four
`UpSampleBN` (the input taken bilinearly with aligned corners to the skip's
size, concatenated with it, twice a 3x3 conv, BN and LeakyReLU(0.01)), a
3x3 `out_conv_res8` on the second, then three per-pixel MLPs
(`out_conv_res{4,2,1}`: 1x1 Conv1d to 128, 128, 128 and 4 with ReLU between
them), each on the feature and the previous prediction, both taken
bilinearly with aligned corners to twice the feature's size. Every
prediction goes through `norm_normalize`: xyz / (|xyz| + 1e-10), and
kappa as ELU + 1.01. So on an odd side the network returns one row or
column more than the frame (45x61 -> 46x62), as the JAX network does; the
annotator keeps the top-left (H, W), which lies over the frame (ROADMAP §3
(aq)).

Module names follow `scannet.pt`'s keys once its wrappers are stripped
(`scannet_state_dict`): `encoder.original_model.{conv_stem, bn1,
blocks.{s}.{i}.*, conv_head}` and `decoder.{conv2, up{1..4}._net.{0,1,3,4},
out_conv_res8, out_conv_res{4,2,1}.{0,2,4,6}}`, so the file loads with plain
`load_state_dict`. Then `fold_batchnorms_` folds each BatchNorm into the
conv before it, once, in fp32 on the host (eps 1e-3 in the encoder, 1e-5
in the decoder); the JAX package applies them at run time instead
(`BatchNormInference`), which rounds otherwise in the last bits.

The annotator takes frames / 255, less the ImageNet mean, over its std, as
the JAX `run` does, and returns (xyz + 1) / 2 clipped to [0, 1]. It reads
CONTROLANIMATE_NORMALBAE_MODEL, default `models/annotators/normalbae/
scannet.pt` from the working directory, as the JAX package does (not
CONTROLANIMATE_ANNOTATOR_DIR); a missing file raises FileNotFoundError,
where the JAX package falls back to normals from depth or from luminance
(ROADMAP §3 (ao)).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.warp import fp32_convs
from ...weights import ingest
from .same_padding import Conv2dSame

MODEL_ENV = "CONTROLANIMATE_NORMALBAE_MODEL"
DEFAULT_MODEL = "models/annotators/normalbae/scannet.pt"
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ENCODER_EPS = 1e-3  # TF's BatchNorm eps, kept by the tf_ EfficientNets
DECODER_EPS = 1e-5  # torch's default


@dataclass(frozen=True)
class NNETConfig:
    """The network's geometry: tf_efficientnet_b5_ap (B0 at width 1.6 and
    depth 2.2, rounded to multiples of 8) and the NNET decoder's widths."""

    stem: int = 48
    widths: tuple = (24, 40, 64, 128, 176, 304, 512)
    repeats: tuple = (3, 5, 5, 7, 7, 9, 3)
    expands: tuple = (1, 6, 6, 6, 6, 6, 6)
    kernels: tuple = (3, 3, 5, 3, 5, 5, 3)
    strides: tuple = (1, 2, 2, 2, 1, 2, 1)
    head: int = 2048
    decoder: tuple = (1024, 512, 256, 128)  # up1..up4
    hidden: int = 128  # the refinement MLPs'


B5 = NNETConfig()


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """A bias-free encoder conv; at stride 1 TF's "SAME" is `k // 2` a side."""
    if stride == 1:
        return nn.Conv2d(cin, cout, k, padding=k // 2, groups=groups, bias=False)
    return Conv2dSame(cin, cout, k, stride=stride, groups=groups, bias=False)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, reduced, 1)
        self.conv_expand = nn.Conv2d(reduced, channels, 1)

    def forward(self, x):
        s = self.conv_expand(F.silu(self.conv_reduce(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    FOLDS = (("conv_dw", "bn1"), ("conv_pw", "bn2"))

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv_dw = _conv(cin, cin, k, stride, groups=cin)
        self.bn1 = nn.BatchNorm2d(cin, eps=ENCODER_EPS)
        self.se = SqueezeExcite(cin, max(1, int(cin * 0.25)))
        self.conv_pw = _conv(cin, cout, 1)
        self.bn2 = nn.BatchNorm2d(cout, eps=ENCODER_EPS)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = self.bn2(self.conv_pw(self.se(F.silu(self.bn1(self.conv_dw(x))))))
        return x + y if self.skip else y


class InvertedResidual(nn.Module):
    FOLDS = (("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))

    def __init__(self, cin: int, cout: int, k: int, stride: int, expand: int):
        super().__init__()
        mid = cin * expand
        self.conv_pw = _conv(cin, mid, 1)
        self.bn1 = nn.BatchNorm2d(mid, eps=ENCODER_EPS)
        self.conv_dw = _conv(mid, mid, k, stride, groups=mid)
        self.bn2 = nn.BatchNorm2d(mid, eps=ENCODER_EPS)
        self.se = SqueezeExcite(mid, max(1, int(cin * 0.25)))
        self.conv_pwl = _conv(mid, cout, 1)
        self.bn3 = nn.BatchNorm2d(cout, eps=ENCODER_EPS)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_pw(x)))
        y = self.se(F.silu(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return x + y if self.skip else y


class EfficientNet(nn.Module):
    """The backbone: stages 0, 1, 2 and 4 and the raw `conv_head` output."""

    FOLDS = (("conv_stem", "bn1"),)

    def __init__(self, cfg: NNETConfig):
        super().__init__()
        self.conv_stem = _conv(3, cfg.stem, 3, 2)
        self.bn1 = nn.BatchNorm2d(cfg.stem, eps=ENCODER_EPS)
        cin, stages = cfg.stem, []
        for width, n, expand, k, stride in zip(cfg.widths, cfg.repeats, cfg.expands,
                                               cfg.kernels, cfg.strides):
            blocks = []
            for i in range(n):
                st = stride if i == 0 else 1
                blocks.append(DepthwiseSeparable(cin, width, k, st) if expand == 1
                              else InvertedResidual(cin, width, k, st, expand))
                cin = width
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.conv_head = _conv(cin, cfg.head, 1)

    def forward(self, x) -> list[torch.Tensor]:
        x = F.silu(self.bn1(self.conv_stem(x)))
        outs = []
        for stage in self.blocks:
            for block in stage:
                x = block(x)
            outs.append(x)
        return [outs[0], outs[1], outs[2], outs[4], self.conv_head(x)]


class Encoder(nn.Module):
    def __init__(self, cfg: NNETConfig):
        super().__init__()
        self.original_model = EfficientNet(cfg)

    def forward(self, x):
        return self.original_model(x)


def _up(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


def norm_normalize(out: torch.Tensor) -> torch.Tensor:
    """xyz / (|xyz| + 1e-10) and kappa as ELU + 1 + 0.01 (channels first)."""
    xyz, kappa = out[:, :3], out[:, 3:]
    norm = torch.sqrt((xyz * xyz).sum(1, keepdim=True)) + 1e-10
    return torch.cat([xyz / norm, F.elu(kappa) + 1.0 + 0.01], 1)


class UpSampleBN(nn.Module):
    FOLDS = (("_net.0", "_net.1"), ("_net.3", "_net.4"))

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self._net = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout, eps=DECODER_EPS),
            nn.LeakyReLU(0.01), nn.Conv2d(cout, cout, 3, padding=1),
            nn.BatchNorm2d(cout, eps=DECODER_EPS), nn.LeakyReLU(0.01))

    def forward(self, x, skip):
        return self._net(torch.cat([_up(x, *skip.shape[2:]), skip], 1))


def _pixel_mlp(cin: int, hidden: int) -> nn.Sequential:
    return nn.Sequential(nn.Conv1d(cin, hidden, 1), nn.ReLU(inplace=True),
                         nn.Conv1d(hidden, hidden, 1), nn.ReLU(inplace=True),
                         nn.Conv1d(hidden, hidden, 1), nn.ReLU(inplace=True),
                         nn.Conv1d(hidden, 4, 1))


class Decoder(nn.Module):
    def __init__(self, cfg: NNETConfig):
        super().__init__()
        w, d = cfg.widths, cfg.decoder
        self.conv2 = nn.Conv2d(cfg.head, cfg.head, 1)
        self.up1 = UpSampleBN(cfg.head + w[4], d[0])
        self.up2 = UpSampleBN(d[0] + w[2], d[1])
        self.up3 = UpSampleBN(d[1] + w[1], d[2])
        self.up4 = UpSampleBN(d[2] + w[0], d[3])
        self.out_conv_res8 = nn.Conv2d(d[1], 4, 3, padding=1)
        self.out_conv_res4 = _pixel_mlp(d[1] + 4, cfg.hidden)
        self.out_conv_res2 = _pixel_mlp(d[2] + 4, cfg.hidden)
        self.out_conv_res1 = _pixel_mlp(d[3] + 4, cfg.hidden)

    @staticmethod
    def refine(mlp: nn.Sequential, feat: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
        h, w = 2 * feat.shape[2], 2 * feat.shape[3]
        x = torch.cat([_up(feat, h, w), _up(prev, h, w)], 1)
        return norm_normalize(mlp(x.flatten(2)).unflatten(2, (h, w)))

    def forward(self, feats):
        b0, b1, b2, b4, head = feats
        x_d1 = self.up1(self.conv2(head), b4)
        x_d2 = self.up2(x_d1, b2)
        x_d3 = self.up3(x_d2, b1)
        x_d4 = self.up4(x_d3, b0)
        out = norm_normalize(self.out_conv_res8(x_d2))
        out = self.refine(self.out_conv_res4, x_d2, out)
        out = self.refine(self.out_conv_res2, x_d3, out)
        return self.refine(self.out_conv_res1, x_d4, out)


class NNET(nn.Module):
    """x: (B, 3, H, W) ImageNet-normalised RGB -> (B, 4, H', W'): unit
    normal xyz and kappa at the finest scale (H' = H on an even side)."""

    def __init__(self, cfg: NNETConfig = B5):
        super().__init__()
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def forward(self, x):
        return self.decoder(self.encoder(x))


@torch.no_grad()
def fold_batchnorms_(model: nn.Module) -> nn.Module:
    """Fold every BatchNorm into the conv before it (each module's `FOLDS`
    names the pairs) in the conv's dtype: w * s and (b - mean) * s + beta,
    s = gamma / sqrt(var + eps); the BatchNorm becomes an identity."""
    for module in list(model.modules()):
        for conv_name, bn_name in getattr(module, "FOLDS", ()):
            conv, bn = module.get_submodule(conv_name), module.get_submodule(bn_name)
            scale = bn.weight / torch.sqrt(bn.running_var + bn.eps)
            bias = conv.bias if conv.bias is not None else torch.zeros_like(bn.bias)
            conv.weight = nn.Parameter(conv.weight * scale.reshape(-1, 1, 1, 1))
            conv.bias = nn.Parameter((bias - bn.running_mean) * scale + bn.bias)
            parent, _, leaf = bn_name.rpartition(".")
            setattr(module.get_submodule(parent) if parent else module, leaf, nn.Identity())
    return model


UNUSED_PREFIX = "encoder.original_model.bn2."  # the backbone's head BatchNorm


def scannet_state_dict(raw: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A `scannet.pt` state dict as `ingest.load_state_dict` flattens it ->
    the unfolded `NNET`'s keys: every leading `model.` (the release's
    {"model": ...} nesting) and `module.` (DataParallel) stripped, whatever
    their order, and `bn2`, which NNET does not use, dropped. The JAX
    loader strips `module.` then `model.` once each, so it cannot read the
    release's {"model": {"module.…"}} (ROADMAP §3 (ap))."""
    out = {}
    for k, v in raw.items():
        while k.startswith(("model.", "module.")):
            k = k.split(".", 1)[1]
        if not k.startswith(UNUSED_PREFIX):
            out[k] = v
    return out


def nnet_from_state_dict(sd: dict[str, torch.Tensor], cfg: NNETConfig = B5) -> NNET:
    """The folded fp32 `NNET` of an unfolded state dict, on the tensors'
    device (num_batches_tracked may be absent)."""
    with torch.device("meta"):
        model = NNET(cfg)
    model.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    return fold_batchnorms_(model).eval()


def load_nnet(path, device, cfg: NNETConfig = B5) -> NNET:
    """The folded `NNET` of the file at `path` on `device`, folded on the
    host (FileNotFoundError naming the path when the file is absent)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"the normalbae annotator needs its weights at {path}")
    sd = scannet_state_dict(ingest.load_state_dict(path))
    return nnet_from_state_dict(sd, cfg).to(device)


def model_path() -> Path:
    return Path(os.environ.get(MODEL_ENV, DEFAULT_MODEL))


def normalize_frames(frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) uint8 -> the network's (F, 3, H, W) float32 input:
    / 255, less the ImageNet mean, over its std."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    return ((frames.to(torch.float32) / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()


class NormalBaeAnnotator:
    """The `normalbae` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 normal maps in [0, 1], the F frames as one batch through the
    network on their device in fp32."""

    def __init__(self, model: NNET):
        self.model = model.float().eval()

    @classmethod
    def from_file(cls, path, device="cuda") -> "NormalBaeAnnotator":
        return cls(load_nnet(path, device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        h, w = frames.shape[1:3]
        with fp32_convs():
            xyz = self.model(normalize_frames(frames))[:, :3, :h, :w]
        return ((xyz + 1.0) * 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).contiguous()
