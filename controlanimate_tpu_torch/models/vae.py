"""AutoencoderKL (the SD1.5 VAE) on channels-last images.

Counterpart of `controlanimate_tpu/models/vae.py`: block_out (128, 256, 512,
512), 2 encoder and 3 decoder resnets per level, single-head attention at the
512-channel mid block (K1 at head dim 512), latent_channels 4, scaling factor
0.18215. Encode takes the posterior noise as an argument. Module names follow
the diffusers checkpoint keys.

The resnet branches are GroupNorm -> SiLU -> conv3x3 in plain PyTorch unless
K2 is on (`AutoencoderKL.set_conv_kernel(True)`, which the facade calls with
`RunConfig.use_pallas_conv`). Then, as in the JAX package's dispatch, each
branch folds its norm (`groupnorm_fold`) and launches K2 with the SiLU and,
on the second conv, the residual; each `Upsample2D` resizes nearest 2x and
launches K2 with no norm and no activation. A conv whose shape K2's
`supported` rule rejects takes the plain path; the shortcut 1x1 convs,
conv_in, conv_out and the stride-2 downsample stay plain.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv_kernel as ck
from ..ops.attention import dot_product_attention
from ..ops.upsample import upsample2x_conv3x3
from .layers import GroupNorm, conv1x1_nhwc, conv_nhwc, linear

_EPS = 1e-6  # diffusers' VAE norms


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    """The conv's (Cout, Cin, 3, 3) weight as an HWIO view, K2's layout."""
    return conv.weight.permute(2, 3, 1, 0)


def _gn_silu_conv(x, norm: GroupNorm, conv: nn.Conv2d, residual=None, fused: bool = False):
    """GroupNorm -> SiLU -> conv3x3 [+ residual], channels-last; one K2
    launch when `fused` and K2 takes the shape."""
    if fused and ck.supported(x.shape[1], x.shape[2], x.shape[3], conv.out_channels):
        affine = ck.groupnorm_fold(x, norm.weight, norm.bias, norm.num_groups, norm.eps)
        return ck.conv3x3_fused(x, _hwio(conv), conv.bias, affine=affine, act="silu",
                                residual=residual)
    out = conv_nhwc(F.silu(norm(x)), conv)
    return out if residual is None else out + residual


class _Block(nn.Module):
    """Container whose attribute names give the diffusers key layout."""


class VaeResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, _EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(groups, out_channels, _EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)
        else:
            self.conv_shortcut = None
        self.use_conv_kernel = False  # K2 for both branches

    def forward(self, x):
        x = x.to(self.conv1.weight.dtype)
        shortcut = x if self.conv_shortcut is None else conv1x1_nhwc(x, self.conv_shortcut)
        fused = self.use_conv_kernel
        h = _gn_silu_conv(x, self.norm1, self.conv1, fused=fused)
        return _gn_silu_conv(h, self.norm2, self.conv2, residual=shortcut, fused=fused)


class VaeAttnBlock(nn.Module):
    """Single-head spatial self-attention at the mid block (K1, D = channels)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(groups, channels, _EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        B, H, W, C = x.shape
        h = self.group_norm(x).reshape(B, H * W, C)
        q = linear(h, self.to_q)[:, :, None, :]
        k = linear(h, self.to_k)[:, :, None, :]
        v = linear(h, self.to_v)[:, :, None, :]
        out = dot_product_attention(q, k, v)[:, :, 0, :]
        return x + self.to_out[0](out).reshape(B, H, W, C)


class Downsample2D(nn.Module):
    """Stride-2 3x3 conv with the SD VAE's asymmetric (0, 1, 0, 1) padding."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):
        h = x.to(self.conv.weight.dtype).permute(0, 3, 1, 2)
        h = F.conv2d(F.pad(h, (0, 1, 0, 1)), self.conv.weight, self.conv.bias, stride=2)
        return h.permute(0, 2, 3, 1)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.use_conv_kernel = False  # K2 on the resized map

    def forward(self, x):
        B, H, W, C = x.shape
        if self.use_conv_kernel and ck.supported(2 * H, 2 * W, C, self.conv.out_channels):
            x = x.to(self.conv.weight.dtype)
            up = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
            return ck.conv3x3_fused(up, _hwio(self.conv), self.conv.bias)
        return upsample2x_conv3x3(x, self.conv.weight, self.conv.bias)


def _mid_block(ch: int, groups: int) -> _Block:
    mid = _Block()
    mid.resnets = nn.ModuleList([VaeResnetBlock(ch, ch, groups), VaeResnetBlock(ch, ch, groups)])
    mid.attentions = nn.ModuleList([VaeAttnBlock(ch, groups)])
    return mid


def _run_mid(mid: _Block, h):
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4, groups: int = 32):
        super().__init__()
        ch = list(block_out_channels)
        self.conv_in = nn.Conv2d(3, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            in_ch = ch[max(i - 1, 0)]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                VaeResnetBlock(in_ch if j == 0 else c, c, groups) for j in range(layers_per_block)
            )
            if i < len(ch) - 1:
                blk.downsamplers = nn.ModuleList([Downsample2D(c)])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch[-1], groups)
        self.conv_norm_out = GroupNorm(groups, ch[-1], _EPS)
        self.conv_out = nn.Conv2d(ch[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = conv_nhwc(x, self.conv_in)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return conv_nhwc(F.silu(self.conv_norm_out(h)), self.conv_out)


class Decoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_channels: int = 4, out_channels: int = 3,
                 groups: int = 32):
        super().__init__()
        ch = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block = _mid_block(ch[0], groups)
        self.up_blocks = nn.ModuleList()
        for i, c in enumerate(ch):
            in_ch = ch[max(i - 1, 0)]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                VaeResnetBlock(in_ch if j == 0 else c, c, groups) for j in range(layers_per_block)
            )
            if i < len(ch) - 1:
                blk.upsamplers = nn.ModuleList([Upsample2D(c)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(groups, ch[-1], _EPS)
        self.conv_out = nn.Conv2d(ch[-1], out_channels, 3, padding=1)

    def forward(self, z):
        h = conv_nhwc(z, self.conv_in)
        h = _run_mid(self.mid_block, h)
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return conv_nhwc(F.silu(self.conv_norm_out(h)), self.conv_out)


class AutoencoderKL(nn.Module):
    """KL-VAE with diffusers-compatible quant convs and scaling factor."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, scaling_factor: float = 0.18215, groups: int = 32):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels, latent_channels=latent_channels, groups=groups)
        self.decoder = Decoder(block_out_channels, latent_channels=latent_channels, groups=groups)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)
        self.use_conv_kernel = False

    def set_conv_kernel(self, enabled: bool) -> None:
        """Route every resnet branch and upsample conv through K2 (or back to
        the plain path)."""
        self.use_conv_kernel = bool(enabled)
        for m in self.modules():
            if isinstance(m, (VaeResnetBlock, Upsample2D)):
                m.use_conv_kernel = self.use_conv_kernel

    def encode_moments(self, x):
        """x: (B, H, W, 3) in [-1, 1] -> (mean, logvar), each (B, H/8, W/8, 4)."""
        moments = conv1x1_nhwc(self.encoder(x), self.quant_conv)
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, noise: Optional[torch.Tensor] = None):
        """Scaled latents: the posterior sample `mean + std * noise` when noise
        is given (same shape as the latents), the mode otherwise."""
        mean, logvar = self.encode_moments(x)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return mean * self.scaling_factor

    def decode(self, z):
        """Scaled latents -> (B, H, W, 3) in [-1, 1]."""
        z = z / self.scaling_factor
        return self.decoder(conv1x1_nhwc(z, self.post_quant_conv))
