"""DPT-hybrid, the depth annotator's network with a BiT-R50 backbone
(Intel/dpt-hybrid-midas's layout; MiDaS's DPT-hybrid is what ControlNet
v1.1's depth annotator runs).

Counterpart of `controlanimate_tpu/models/annotators/dpt_hybrid.py`
(`DPTHybridDepth`, transformers' DPTForDepthEstimation with `is_hybrid`).
It runs in fp32 without TF32, the F frames as one batch.

Backbone (`BitBackbone`, geometry `BitConfig`): a 7x7 stride-2 stem, a
GroupNorm with ReLU and a 3x3 stride-2 max-pool, then three stages of
non-preactivation bottlenecks (`BitBottleneck`: 1x1, 3x3 at the stage's
stride, 1x1, each with a GroupNorm of 32 groups, eps 1e-5, ReLU after the
first two; the first block of a stage has a 1x1 downsample; ReLU of the
sum), depths 3, 4, 9 at widths 256, 512, 1024, so /4, /8 and /16. Every
conv is weight-standardised (per output channel, biased variance over (in,
kh, kw), eps 1e-8) and pads as TF's "SAME" (`same_padding.py`). The port
standardises each weight once, in fp32, when the file is read
(`standardize_weights_`); the JAX package does it at every call, which
rounds otherwise in the last bits. The max-pool pads with zeros, as
transformers does; its input is after a ReLU, so that is JAX's -inf "SAME"
pooling (`dpt_hybrid.py:135-137`).

A 1x1 projection of the /16 map gives the tokens; the class token leads
them, and the position table is added, resized bilinearly (antialiased
where it shrinks, as `jax.image.resize`) from its stored square grid when
that grid is not the map's (`:179-184`). A ViT-B (`dpt.py` `ViTLayer`,
head dim 64: K1 on the card) follows. The neck takes BiT stages 1 and 2
as they are and the ViT taps `taps[2:]` through the 'project' readout and
`reassemble_factors[2:]` (1 and 0.5 by default); the rest is the plain
net's (`dpt.py` `DPTNeck`, `DepthHead`).

Module names follow the checkpoint's keys: `dpt.embeddings.backbone.bit.
{embedder, encoder.stages.{s}.layers.{i}}.*`, `dpt.embeddings.{projection,
cls_token, position_embeddings}`, and the plain net's for the rest.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F
from torch import nn

from .dpt import (DepthHead, DPTNeck, ViTEncoder, network_input, resize_half_pixel,
                  with_class_token)
from .same_padding import Conv2dSame, same_pads

WS_EPS = 1e-8
GN_EPS = 1e-5


def _make_div(value: float, divisor: int = 8) -> int:
    new = max(divisor, int(value + divisor / 2) // divisor * divisor)
    if new < 0.9 * value:
        new += divisor
    return new


@dataclass(frozen=True)
class BitConfig:
    """BiT-R50's geometry as DPT-hybrid uses it (3 stages)."""

    embedding_size: int = 64
    hidden_sizes: tuple = (256, 512, 1024)
    depths: tuple = (3, 4, 9)
    num_groups: int = 32


@dataclass(frozen=True)
class DPTHybridConfig:
    """The hybrid net's geometry (Intel/dpt-hybrid-midas by default)."""

    bit: BitConfig = field(default_factory=BitConfig)
    hidden_size: int = 768
    num_layers: int = 12
    heads: int = 12
    mlp_dim: int = 3072
    patch: int = 16
    taps: tuple = (2, 5, 8, 11)  # only taps[2:] are ViT layers
    neck_hidden: tuple = (256, 512, 768, 768)
    reassemble_factors: tuple = (1, 1, 1, 0.5)
    fusion_hidden: int = 256

    @classmethod
    def from_json(cls, cfg: dict) -> "DPTHybridConfig":
        """The keys JAX `model_from_config` reads, with its defaults."""
        d, b = cls(), cfg.get("backbone_config") or {}
        bit = BitConfig(embedding_size=b.get("embedding_size", d.bit.embedding_size),
                        hidden_sizes=tuple(b.get("hidden_sizes", d.bit.hidden_sizes)),
                        depths=tuple(b.get("depths", d.bit.depths)),
                        num_groups=b.get("num_groups", d.bit.num_groups))
        return cls(bit=bit, hidden_size=cfg.get("hidden_size", d.hidden_size),
                   num_layers=cfg.get("num_hidden_layers", d.num_layers),
                   heads=cfg.get("num_attention_heads", d.heads),
                   mlp_dim=cfg.get("intermediate_size", d.mlp_dim),
                   patch=cfg.get("patch_size", d.patch),
                   taps=tuple(cfg.get("backbone_out_indices", d.taps)),
                   neck_hidden=tuple(cfg.get("neck_hidden_sizes", d.neck_hidden)),
                   reassemble_factors=tuple(cfg.get("reassemble_factors",
                                                    d.reassemble_factors)),
                   fusion_hidden=cfg.get("fusion_hidden_size", d.fusion_hidden))


DPT_HYBRID_MIDAS = DPTHybridConfig()


class WSConv(Conv2dSame):
    """A bias-free conv with TF "SAME" padding whose weight
    `standardize_weights_` standardised when the file was read."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride=stride, bias=False)


@torch.no_grad()
def standardize_weights_(model: nn.Module) -> nn.Module:
    """Each `WSConv`'s weight w -> (w - mean) / sqrt(var + 1e-8), mean and
    biased variance over (in, kh, kw) per output channel, in fp32; a new
    tensor, so a state dict the module was loaded from keeps its values."""
    for m in model.modules():
        if isinstance(m, WSConv):
            w = m.weight.float()
            mean = w.mean((1, 2, 3), keepdim=True)
            var = (w - mean).square().mean((1, 2, 3), keepdim=True)
            m.weight = nn.Parameter((w - mean) * torch.rsqrt(var + WS_EPS))
    return model


class _GroupNormAct(nn.GroupNorm):
    def __init__(self, groups: int, channels: int, act: bool = True):
        super().__init__(groups, channels, eps=GN_EPS)
        self.act = act

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.act else x


class _Downsample(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, groups: int):
        super().__init__()
        self.conv = WSConv(cin, cout, 1, stride)
        self.norm = _GroupNormAct(groups, cout, act=False)

    def forward(self, x):
        return self.norm(self.conv(x))


class BitBottleneck(nn.Module):
    """relu(norm3(conv3(relu(norm2(conv2(relu(norm1(conv1(x)))))))) +
    shortcut), the shortcut downsampled in the first block of a stage."""

    def __init__(self, cin: int, cout: int, stride: int, groups: int, first: bool):
        super().__init__()
        mid = _make_div(cout * 0.25)
        if first:
            self.downsample = _Downsample(cin, cout, stride, groups)
        self.conv1 = WSConv(cin, mid, 1)
        self.norm1 = _GroupNormAct(groups, mid)
        self.conv2 = WSConv(mid, mid, 3, stride)
        self.norm2 = _GroupNormAct(groups, mid)
        self.conv3 = WSConv(mid, cout, 1)
        self.norm3 = _GroupNormAct(groups, cout, act=False)

    def forward(self, x):
        shortcut = self.downsample(x) if hasattr(self, "downsample") else x
        h = self.norm2(self.conv2(self.norm1(self.conv1(x))))
        return F.relu(self.norm3(self.conv3(h)) + shortcut)


class _Embedder(nn.Module):
    def __init__(self, c: BitConfig):
        super().__init__()
        self.convolution = WSConv(3, c.embedding_size, 7, 2)
        self.norm = _GroupNormAct(c.num_groups, c.embedding_size)

    def forward(self, x):
        x = self.norm(self.convolution(x))
        return F.max_pool2d(F.pad(x, same_pads(x, (3, 3), (2, 2))), 3, 2)


class _Stage(nn.Module):
    def __init__(self, cin: int, cout: int, depth: int, stride: int, groups: int):
        super().__init__()
        self.layers = nn.ModuleList(
            BitBottleneck(cin if i == 0 else cout, cout, stride if i == 0 else 1, groups, i == 0)
            for i in range(depth))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class _Encoder(nn.Module):
    def __init__(self, c: BitConfig):
        super().__init__()
        widths = [_make_div(w) for w in c.hidden_sizes]
        self.stages = nn.ModuleList(
            _Stage(cin, cout, depth, 1 if s == 0 else 2, c.num_groups)
            for s, (cin, cout, depth) in enumerate(zip([c.embedding_size, *widths], widths,
                                                       c.depths)))


class _Bit(nn.Module):
    def __init__(self, c: BitConfig):
        super().__init__()
        self.embedder = _Embedder(c)
        self.encoder = _Encoder(c)


class BitBackbone(nn.Module):
    """(B, 3, H, W) -> [stage 1 (/4), stage 2 (/8), stage 3 (/16)]."""

    def __init__(self, c: BitConfig):
        super().__init__()
        self.bit = _Bit(c)

    def forward(self, x) -> list:
        x = self.bit.embedder(x)
        outs = []
        for stage in self.bit.encoder.stages:
            x = stage(x)
            outs.append(x)
        return outs


class _HybridEmbeddings(nn.Module):
    def __init__(self, cfg: DPTHybridConfig, positions: int):
        super().__init__()
        self.backbone = BitBackbone(cfg.bit)
        self.projection = nn.Conv2d(_make_div(cfg.bit.hidden_sizes[-1]), cfg.hidden_size, 1)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, positions, cfg.hidden_size))


class _HybridViT(nn.Module):
    def __init__(self, cfg: DPTHybridConfig, positions: int):
        super().__init__()
        self.embeddings = _HybridEmbeddings(cfg, positions)
        self.encoder = ViTEncoder(cfg)


def resize_position_table(pos: torch.Tensor, grid: tuple[int, int]) -> torch.Tensor:
    """(1, 1 + n * n, C) -> (1, 1 + gh * gw, C): the class row as it is, the
    stored n x n grid resized bilinearly to `grid` (`resize_half_pixel`, as
    JAX `dpt_hybrid.py:179-184`); the table as it is when it fits."""
    if pos.shape[1] == grid[0] * grid[1] + 1:
        return pos
    old = int(round((pos.shape[1] - 1) ** 0.5))
    table = pos[:, 1:].reshape(1, old, old, -1).permute(0, 3, 1, 2)
    table = resize_half_pixel(table, *grid).permute(0, 2, 3, 1).flatten(1, 2)
    return torch.cat([pos[:, :1], table], 1)


class DPTHybridDepth(nn.Module):
    """x: (B, 3, H, W) normalised RGB -> (B, H, W) relative depth, its
    position table of `positions` rows (577 in Intel/dpt-hybrid-midas)."""

    network_input = staticmethod(network_input)  # frames -> x, the annotator's

    def __init__(self, cfg: DPTHybridConfig = DPT_HYBRID_MIDAS, positions: int = 577):
        super().__init__()
        self.cfg = cfg
        self.dpt = _HybridViT(cfg, positions)
        self.neck = DPTNeck(cfg.hidden_size, cfg.neck_hidden, cfg.reassemble_factors,
                            cfg.fusion_hidden, first=2)
        self.head = DepthHead(cfg.fusion_hidden)

    def forward(self, x):
        emb = self.dpt.embeddings
        s1, s2, s3 = emb.backbone(x)
        grid = tuple(s3.shape[2:])
        tokens = emb.projection(s3).flatten(2).transpose(1, 2)
        pos = resize_position_table(emb.position_embeddings, grid)
        taps = self.dpt.encoder(with_class_token(emb, tokens, pos), self.cfg.taps[2:])
        return self.head(self.neck([s1, s2, *(taps[i] for i in self.cfg.taps[2:])], grid))
