"""GLPN, the depth annotator's third network (vinvino02/glpn-nyu's layout).

Counterpart of `controlanimate_tpu/models/annotators/glpn.py` (`GLPNDepth`,
transformers' GLPNForDepthEstimation). It runs in fp32 without TF32.

Encoder: four SegFormer (MiT) stages. Each embeds its input by an
overlapping `patch` x `patch` conv at `stride` (padding patch // 2), a
LayerNorm, `depths[i]` pre-LayerNorm layers and a stage LayerNorm. A layer
is the efficient attention (`EfficientAttention`: queries at full
resolution; where `sr_ratio` > 1 the keys and values come from an `sr` x
`sr` stride-`sr` conv of the tokens and a LayerNorm, so Nk = Nq / sr^2) and
the MixFFN (dense, a 3x3 depthwise conv, exact GELU, dense), each with a
residual. The attention calls `ops/flash_attention.py` `flash_attention`
directly at every stage: on the card K1's fp32 plan at head dim
hidden_sizes[i] / heads[i] (64 at the published MiT-b4 widths, 32 at the
b0 ones), on the CPU its plain version. `ops/attention.py`'s rule, which
sends only Nq == Nk to K1, is not widened for it: that would move the
UNet's text cross-attention too.

Decoder: from the deepest stage up, a 1x1 conv to `decoder_hidden` where
the width differs, the selective feature fusion with the previous output
from the second stage on (`SelectiveFeatureFusion`: two 3x3 conv +
BatchNorm + ReLU, a 3x3 conv to 2 channels and a sigmoid that weigh the
local and global maps), and a bilinear 2x resize at half-pixel centres
(`dpt.py` `HalfPixelUp2x`: `F.interpolate`, as `jax.image.resize` takes a
growing side); then a final 2x. Head: a 3x3 conv, ReLU, a 3x3 conv to one
channel, sigmoid * max_depth.

Every LayerNorm takes the config's `layer_norm_eps` (1e-6 by default), as
JAX's does; transformers' GLPN builds every one with nn.LayerNorm's 1e-5
(ROADMAP §3 (aw)). The fusion's BatchNorms are folded into the convs before
them once, when the file is read (`normalbae.py` `fold_batchnorms_`);
JAX applies them at run time (`normalbae_net.BatchNormInference`, eps
1e-5).

Module names follow the transformers checkpoint's keys (`glpn.encoder.*`,
`decoder.stages.*`, `head.head.{0,2}`), so a file loads with plain
`load_state_dict`; BatchNorm's `num_batches_tracked`, which JAX never
reads, may be present or not.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.flash_attention import SUPPORTED_HEAD_DIMS, flash_attention
from ...ops.resize import resize_cubic
from .dpt import HalfPixelUp2x, load_depth_model
from .normalbae import fold_batchnorms_

SNAP = 32  # the input's sides: multiples of 32, at least 32 (JAX glpn.py:277)


@dataclass(frozen=True)
class GLPNConfig:
    """JAX's `GLPNCfg`, with its defaults (transformers' GLPNConfig(), the
    MiT-b0 widths)."""

    hidden_sizes: tuple = (32, 64, 160, 256)
    depths: tuple = (2, 2, 2, 2)
    sr_ratios: tuple = (8, 4, 2, 1)
    heads: tuple = (1, 2, 5, 8)
    patch_sizes: tuple = (7, 3, 3, 3)
    strides: tuple = (4, 2, 2, 2)
    mlp_ratios: tuple = (4, 4, 4, 4)
    decoder_hidden: int = 64
    max_depth: float = 10.0
    ln_eps: float = 1e-6

    @classmethod
    def from_json(cls, cfg: dict) -> "GLPNConfig":
        """The keys `GLPNCfg.from_json` reads, with its defaults."""
        d = cls()
        return cls(hidden_sizes=tuple(cfg.get("hidden_sizes", d.hidden_sizes)),
                   depths=tuple(cfg.get("depths", d.depths)),
                   sr_ratios=tuple(cfg.get("sr_ratios", d.sr_ratios)),
                   heads=tuple(cfg.get("num_attention_heads", d.heads)),
                   patch_sizes=tuple(cfg.get("patch_sizes", d.patch_sizes)),
                   strides=tuple(cfg.get("strides", d.strides)),
                   mlp_ratios=tuple(cfg.get("mlp_ratios", d.mlp_ratios)),
                   decoder_hidden=cfg.get("decoder_hidden_size", d.decoder_hidden),
                   max_depth=cfg.get("max_depth", d.max_depth),
                   ln_eps=cfg.get("layer_norm_eps", d.ln_eps))


GLPN_B0 = GLPNConfig()
# vinvino02/glpn-nyu and glpn-kitti (the GLPN paper's MiT-b4 encoder;
# max_depth 10 for nyu, 80 for kitti)
GLPN_B4 = GLPNConfig(hidden_sizes=(64, 128, 320, 512), depths=(3, 8, 27, 3))


def check_head_dims(cfg: GLPNConfig) -> None:
    """Each stage's head dim must be one K1 takes (the card's path); a
    ValueError names the stage otherwise."""
    for i, (c, h) in enumerate(zip(cfg.hidden_sizes, cfg.heads)):
        if c // h not in SUPPORTED_HEAD_DIMS:
            raise ValueError(f"GLPN stage {i}: head dim {c} / {h} = {c // h} is not one K1 "
                             f"takes {SUPPORTED_HEAD_DIMS}")


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C)."""
    return x.flatten(2).transpose(1, 2)


def _map(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W), a channels-last view (no copy)."""
    return t.reshape(t.shape[0], H, W, t.shape[2]).permute(0, 3, 1, 2)


class _EfficientSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int, eps: float):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr_ratio
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(hidden, hidden, sr_ratio, stride=sr_ratio)
            self.layer_norm = nn.LayerNorm(hidden, eps=eps)


class _Dense(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)


class EfficientAttention(nn.Module):
    """SegFormer's efficient self-attention over (B, H*W, C) tokens, its
    output projection included."""

    def __init__(self, hidden: int, heads: int, sr_ratio: int, eps: float):
        super().__init__()
        self.self = _EfficientSelfAttention(hidden, heads, sr_ratio, eps)
        self.output = _Dense(hidden)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        sa = self.self
        B, N, C = x.shape
        D = C // sa.heads
        q = sa.query(x).reshape(B, N, sa.heads, D)
        kv = x
        if sa.sr_ratio > 1:
            kv = sa.layer_norm(_tokens(sa.sr(_map(x, H, W))))
        M = kv.shape[1]
        k, v = (lin(kv).reshape(B, M, sa.heads, D) for lin in (sa.key, sa.value))
        return self.output.dense(flash_attention(q, k, v).reshape(B, N, C))


class _DWConv(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)


class MixFFN(nn.Module):
    """dense1 -> 3x3 depthwise conv -> exact GELU -> dense2, over (B, H*W, C)."""

    def __init__(self, cin: int, hidden: int):
        super().__init__()
        self.dense1 = nn.Linear(cin, hidden)
        self.dwconv = _DWConv(hidden)
        self.dense2 = nn.Linear(hidden, cin)

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        h = self.dwconv.dwconv(_map(self.dense1(x), H, W))
        return self.dense2(F.gelu(_tokens(h)))


class GLPNLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, sr_ratio: int, mlp_ratio, eps: float):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(hidden, eps=eps)
        self.attention = EfficientAttention(hidden, heads, sr_ratio, eps)
        self.layer_norm_2 = nn.LayerNorm(hidden, eps=eps)
        self.mlp = MixFFN(hidden, int(hidden * mlp_ratio))

    def forward(self, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_1(x), H, W)
        return x + self.mlp(self.layer_norm_2(x), H, W)


class _PatchEmbeddings(nn.Module):
    def __init__(self, cin: int, hidden: int, patch: int, stride: int, eps: float):
        super().__init__()
        self.proj = nn.Conv2d(cin, hidden, patch, stride=stride, padding=patch // 2)
        self.layer_norm = nn.LayerNorm(hidden, eps=eps)


class _Encoder(nn.Module):
    def __init__(self, cfg: GLPNConfig):
        super().__init__()
        cins = (3, *cfg.hidden_sizes[:-1])
        self.patch_embeddings = nn.ModuleList(
            _PatchEmbeddings(cin, c, p, s, cfg.ln_eps) for cin, c, p, s in
            zip(cins, cfg.hidden_sizes, cfg.patch_sizes, cfg.strides))
        self.block = nn.ModuleList(
            nn.ModuleList(GLPNLayer(c, h, sr, m, cfg.ln_eps) for _ in range(d))
            for c, h, sr, m, d in zip(cfg.hidden_sizes, cfg.heads, cfg.sr_ratios,
                                      cfg.mlp_ratios, cfg.depths))
        self.layer_norm = nn.ModuleList(nn.LayerNorm(c, eps=cfg.ln_eps)
                                        for c in cfg.hidden_sizes)

    def forward(self, x: torch.Tensor) -> list:
        """(B, 3, H, W) -> each stage's (B, C_i, H_i, W_i) map."""
        feats = []
        for embed, layers, norm in zip(self.patch_embeddings, self.block, self.layer_norm):
            x = embed.proj(x)
            H, W = x.shape[2:]
            t = embed.layer_norm(_tokens(x))
            for layer in layers:
                t = layer(t, H, W)
            x = _map(norm(t), H, W)
            feats.append(x)
        return feats


class _GLPNModel(nn.Module):
    def __init__(self, cfg: GLPNConfig):
        super().__init__()
        self.encoder = _Encoder(cfg)


class SelectiveFeatureFusion(nn.Module):
    """local * a0 + global * a1, the weights a sigmoid of three 3x3 convs
    of the two maps (the GLPN paper's section 3.4), over (B, C, H, W)."""

    FOLDS = (("convolutional_layer1.0", "convolutional_layer1.1"),
             ("convolutional_layer2.0", "convolutional_layer2.1"))

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.convolutional_layer1 = nn.Sequential(
            nn.Conv2d(2 * c, c, 3, padding=1), nn.BatchNorm2d(c), nn.ReLU())
        self.convolutional_layer2 = nn.Sequential(
            nn.Conv2d(c, c // 2, 3, padding=1), nn.BatchNorm2d(c // 2), nn.ReLU())
        self.convolutional_layer3 = nn.Conv2d(c // 2, 2, 3, padding=1)

    def forward(self, local: torch.Tensor, glob: torch.Tensor) -> torch.Tensor:
        f = self.convolutional_layer2(self.convolutional_layer1(torch.cat([local, glob], 1)))
        attn = torch.sigmoid(self.convolutional_layer3(f))
        return local * attn[:, 0:1] + glob * attn[:, 1:2]


class _DecoderStage(nn.Module):
    def __init__(self, cin: int, cout: int, fuse: bool):
        super().__init__()
        self.convolution = nn.Conv2d(cin, cout, 1) if cin != cout else nn.Identity()
        self.fusion = SelectiveFeatureFusion(cout) if fuse else None


class _Decoder(nn.Module):
    def __init__(self, cfg: GLPNConfig):
        super().__init__()
        self.stages = nn.ModuleList(_DecoderStage(c, cfg.decoder_hidden, si > 0)
                                    for si, c in enumerate(cfg.hidden_sizes[::-1]))
        self.up = HalfPixelUp2x()

    def forward(self, feats: list) -> torch.Tensor:
        out = None
        for stage, f in zip(self.stages, feats[::-1]):
            f = stage.convolution(f)
            if stage.fusion is not None:
                f = stage.fusion(f, out)
            out = self.up(f)
        return self.up(out)


class _Head(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.head = nn.Sequential(nn.Conv2d(channels, channels, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(channels, 1, 3, padding=1))


def glpn_input(frames: torch.Tensor) -> torch.Tensor:
    """GLPN's input: (F, H, W, 3) uint8 -> (F, 3, h, w) float32, h and w
    the sides snapped down to multiples of SNAP (at least SNAP),
    INTER_CUBIC, then x / 255."""
    H, W = frames.shape[1:3]
    h, w = (max(n // SNAP * SNAP, SNAP) for n in (H, W))
    x = resize_cubic(frames, h, w).to(torch.float32)
    return (x / 255.0).permute(0, 3, 1, 2).contiguous()


class GLPNDepth(nn.Module):
    """x: (B, 3, H, W) in [0, 1], H and W multiples of 32 -> depth (B, H, W)
    in [0, max_depth]."""

    network_input = staticmethod(glpn_input)  # frames -> x, the annotator's

    def __init__(self, cfg: GLPNConfig):
        super().__init__()
        self.cfg = cfg
        self.glpn = _GLPNModel(cfg)
        self.decoder = _Decoder(cfg)
        self.head = _Head(cfg.decoder_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.head.head(self.decoder(self.glpn.encoder(x)))
        return torch.sigmoid(h[:, 0]) * self.cfg.max_depth


def glpn_network(cfg: GLPNConfig, sd: dict) -> GLPNDepth:
    """The fp32 `GLPNDepth` of a transformers-keyed state dict on the host,
    its fusion BatchNorms folded: a missing weight raises KeyError naming
    it; an unexpected one, or a shape off the config, RuntimeError."""
    return fold_batchnorms_(load_depth_model(lambda: GLPNDepth(cfg), sd))
