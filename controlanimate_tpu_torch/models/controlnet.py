"""ControlNet (SD1.5 layout) over video frames, and the multi-net residual sum.

Counterpart of `controlanimate_tpu/models/controlnet.py`: the UNet's down and
mid path (resnets with per-frame GroupNorm whatever the UNet's architecture,
spatial transformers whose self-attention runs on K1 through
`dot_product_attention`, no motion modules) on (B, F, h, w, 4) latents, the
condition image lifted to the latent grid by a small conv encoder and added
after `conv_in`, and a 1x1 "zero conv" head on each of the 12 down skips and
the mid output (13 residuals at SD1.5 width). Guess mode scales the
residuals by `np.logspace(-1, 0, n + 1)`, then every residual takes the
net's `conditioning_scale`. Module names follow the diffusers checkpoint keys
(`controlnet_cond_embedding.blocks.{b}`, `controlnet_down_blocks.{i}`,
`controlnet_mid_block`), so a checkpoint loads with plain `load_state_dict`.

`controlnet_config_from_json` reads the architecture from a diffusers
ControlNet `config.json`, where the JAX package builds SD1.5 defaults
whatever the file says; for every SD1.5 ControlNet the two agree.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import TimestepEmbedding, timestep_embedding
from .resnet3d import Downsample3D, InflatedConv, ResnetBlock3D
from .transformer import SpatialTransformer
from .unet3d import UNet3DConfig, _Block

COND_EMBEDDING_CHANNELS = (16, 32, 96, 256)
SD15_CONTROLNET = UNet3DConfig(use_motion_module=False)


def controlnet_config_from_json(j: dict) -> tuple[UNet3DConfig, tuple[int, ...]]:
    """(UNet3DConfig, conditioning_embedding_out_channels) from a diffusers
    ControlNet config.json; absent fields take the SD1.5 values."""
    down = tuple(t.replace("2D", "3D") for t in j.get("down_block_types", ())) \
        or SD15_CONTROLNET.down_block_types
    cfg = replace(
        SD15_CONTROLNET,
        block_out_channels=tuple(j.get("block_out_channels",
                                       SD15_CONTROLNET.block_out_channels)),
        layers_per_block=j.get("layers_per_block", SD15_CONTROLNET.layers_per_block),
        down_block_types=down,
        attention_heads=j.get("attention_head_dim", SD15_CONTROLNET.attention_heads),
        cross_attention_dim=j.get("cross_attention_dim", SD15_CONTROLNET.cross_attention_dim),
        norm_num_groups=j.get("norm_num_groups", SD15_CONTROLNET.norm_num_groups),
    )
    return cfg, tuple(j.get("conditioning_embedding_out_channels", COND_EMBEDDING_CHANNELS))


class ControlNetConditioningEmbedding(nn.Module):
    """(B, F, H, W, 3) condition image -> (B, F, H/8, W/8, out_channels):
    conv_in, then per level a conv and a stride-2 conv, SiLU after each, and
    conv_out (zero-initialised in diffusers)."""

    def __init__(self, out_channels: int, block_out_channels=COND_EMBEDDING_CHANNELS):
        super().__init__()
        ch = block_out_channels
        self.conv_in = InflatedConv(3, ch[0], 3, padding=1)
        blocks = []
        for i in range(len(ch) - 1):
            blocks.append(InflatedConv(ch[i], ch[i], 3, padding=1))
            blocks.append(InflatedConv(ch[i], ch[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = InflatedConv(ch[-1], out_channels, 3, padding=1)

    def forward(self, cond):
        h = F.silu(self.conv_in(cond))
        for conv in self.blocks:
            h = F.silu(conv(h))
        return self.conv_out(h)


class ControlNetModel(nn.Module):
    def __init__(self, config: UNet3DConfig = SD15_CONTROLNET,
                 conditioning_embedding_out_channels=COND_EMBEDDING_CHANNELS):
        super().__init__()
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb_ch)
        self.conv_in = InflatedConv(cfg.in_channels, ch0, 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            ch0, tuple(conditioning_embedding_out_channels))

        heads = [ch0]  # the channels of each down residual, conv_in's first
        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            in_ch = cfg.block_out_channels[max(i - 1, 0)]
            out_ch = cfg.block_out_channels[i]
            blk = _Block()
            blk.resnets = nn.ModuleList(
                self._resnet(in_ch if j == 0 else out_ch, out_ch)
                for j in range(cfg.layers_per_block))
            if block_type == "CrossAttnDownBlock3D":
                blk.attentions = nn.ModuleList(
                    self._spatial(out_ch) for _ in range(cfg.layers_per_block))
            heads += [out_ch] * cfg.layers_per_block
            if i < len(cfg.down_block_types) - 1:
                blk.downsamplers = nn.ModuleList([Downsample3D(out_ch, out_ch)])
                heads.append(out_ch)
            self.down_blocks.append(blk)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [self._resnet(mid_ch, mid_ch), self._resnet(mid_ch, mid_ch)])
        self.mid_block.attentions = nn.ModuleList([self._spatial(mid_ch)])

        self.controlnet_down_blocks = nn.ModuleList(InflatedConv(c, c, 1) for c in heads)
        self.controlnet_mid_block = InflatedConv(mid_ch, mid_ch, 1)

    def _resnet(self, in_ch: int, out_ch: int) -> ResnetBlock3D:
        # per-frame GroupNorm always, as the JAX ControlNet builds it
        cfg = self.config
        return ResnetBlock3D(in_ch, out_ch, cfg.block_out_channels[0] * 4,
                             groups=cfg.norm_num_groups, eps=1e-5, inflated=True)

    def _spatial(self, ch: int) -> SpatialTransformer:
        cfg = self.config
        return SpatialTransformer(ch, cfg.attention_heads, ch // cfg.attention_heads,
                                  cross_attention_dim=cfg.cross_attention_dim,
                                  groups=cfg.norm_num_groups)

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, h, w, 4) latents
        timesteps: torch.Tensor,  # (B,) or scalar
        encoder_hidden_states: torch.Tensor,  # (B, L, D) text embeddings only
        controlnet_cond: torch.Tensor,  # (B, F, H, W, 3) condition image in [0, 1]
        conditioning_scale: float = 1.0,
        guess_mode: bool = False,
    ) -> tuple[list[torch.Tensor], torch.Tensor]:
        cfg = self.config
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        temb = self.time_embedding(timestep_embedding(timesteps, cfg.block_out_channels[0]))
        ctx = encoder_hidden_states

        sample = self.conv_in(sample)
        sample = sample + self.controlnet_cond_embedding(controlnet_cond)
        skips = [sample]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                sample = resnet(sample, temb)
                if hasattr(blk, "attentions"):
                    sample = blk.attentions[j](sample, ctx)
                skips.append(sample)
            if hasattr(blk, "downsamplers"):
                sample = blk.downsamplers[0](sample)
                skips.append(sample)

        mid = self.mid_block
        sample = mid.resnets[0](sample, temb)
        sample = mid.attentions[0](sample, ctx)
        sample = mid.resnets[1](sample, temb)

        downs = [head(r) for head, r in zip(self.controlnet_down_blocks, skips)]
        mid_out = self.controlnet_mid_block(sample)
        dtype = mid_out.dtype
        if guess_mode:
            scales = torch.tensor(np.logspace(-1, 0, len(downs) + 1), dtype=dtype,
                                  device=mid_out.device)
            downs = [d * s for d, s in zip(downs, scales[:-1])]
            mid_out = mid_out * scales[-1]
        scale = torch.tensor(conditioning_scale, dtype=dtype, device=mid_out.device)
        return [d * scale for d in downs], mid_out * scale


def sum_controlnet_residuals(
    per_net: Sequence[tuple[list[torch.Tensor], torch.Tensor]],
) -> tuple[Optional[list[torch.Tensor]], Optional[torch.Tensor]]:
    """The residuals of several nets summed residual by residual (diffusers'
    MultiControlNetModel); (None, None) for no nets."""
    if not per_net:
        return None, None
    downs, mids = zip(*per_net)
    summed = [sum(ds[i] for ds in downs) for i in range(len(downs[0]))]
    return summed, sum(mids)
