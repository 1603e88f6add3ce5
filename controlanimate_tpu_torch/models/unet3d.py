"""UNet3DConditionModel: the SD1.5 UNet inflated to video with AnimateDiff
motion modules, on (B, F, H, W, C) latents.

Counterpart of `controlanimate_tpu/models/unet3d.py`. Per layer the order is
ResnetBlock3D -> SpatialTransformer -> MotionModule; the LCM guidance
embedding enters through the time embedding's `cond_proj`. Module names follow
the diffusers checkpoint keys (`down_blocks.0.resnets.0.conv1.weight`, ...).
`set_motion_kernel(True)` puts the motion modules on K3 (the facade does so
under CONTROLANIMATE_PALLAS_MOTION=1). ControlNet residuals (`models/controlnet.py`)
enter as in the JAX model: each down residual is added to its skip in the
skip's dtype, the mid residual after the mid block. With `ip_tokens` every
cross-attention takes the IP-Adapter's image tokens from the context's tail
(`models/layers.py` `Attention`), scaled by `ip_scale`. The inference yaml's
`unet_use_cross_frame_attention` and `unet_use_temporal_attention` (sparse-
causal self-attention, the frame-axis sub-layer: `models/transformer.py`) and
the motion modules' `attention_band` (`models/motion_module.py`) build the
UNet they describe. Encoder reuse is not in this slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import ArchConfig, MotionModuleConfig
from .layers import TimestepEmbedding, timestep_embedding
from .motion_module import MotionModule
from .resnet3d import Downsample3D, InflatedConv, ResnetBlock3D, Upsample3D, VideoGroupNorm
from .transformer import SpatialTransformer


@dataclass(frozen=True)
class UNet3DConfig:
    """Static architecture config (SD1.5 defaults)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_types: tuple[str, ...] = (
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "CrossAttnDownBlock3D",
        "DownBlock3D",
    )
    up_block_types: tuple[str, ...] = (
        "UpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
        "CrossAttnUpBlock3D",
    )
    attention_heads: int = 8
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_cond_proj_dim: Optional[int] = None  # 256 for native-LCM UNets
    upcast_attention: bool = False
    use_motion_module: bool = True
    use_inflated_groupnorm: bool = True
    motion_module_resolutions: tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = True
    motion_module_decoder_only: bool = False
    motion: MotionModuleConfig = field(default_factory=MotionModuleConfig)
    ip_tokens: int = 0
    cross_frame_attention: bool = False
    temporal_attention: bool = False
    token_merge_ratio: float = 0.0
    token_merge_motion: bool = False

    @staticmethod
    def from_arch(arch: ArchConfig, unet_json: Optional[dict] = None,
                  ip_tokens: int = 0) -> "UNet3DConfig":
        """A diffusers unet config.json combined with the AnimateDiff
        inference yaml's architecture (the JAX `UNet3DConfig.from_arch`)."""
        j = unet_json or {}
        return UNet3DConfig(
            in_channels=j.get("in_channels", 4),
            out_channels=j.get("out_channels", 4),
            block_out_channels=tuple(j.get("block_out_channels", (320, 640, 1280, 1280))),
            layers_per_block=j.get("layers_per_block", 2),
            attention_heads=j.get("attention_head_dim", 8),
            cross_attention_dim=j.get("cross_attention_dim", 768),
            norm_num_groups=j.get("norm_num_groups", 32),
            time_cond_proj_dim=j.get("time_cond_proj_dim"),
            upcast_attention=bool(j.get("upcast_attention") or False),
            use_motion_module=arch.use_motion_module,
            use_inflated_groupnorm=arch.use_inflated_groupnorm,
            motion_module_resolutions=arch.motion_module_resolutions,
            motion_module_mid_block=arch.motion_module_mid_block,
            motion_module_decoder_only=arch.motion_module_decoder_only,
            motion=arch.motion_module,
            ip_tokens=ip_tokens,
            cross_frame_attention=arch.unet_use_cross_frame_attention,
            temporal_attention=arch.unet_use_temporal_attention,
        )


class _Block(nn.Module):
    """Container whose attribute names give the diffusers key layout."""


class UNet3DConditionModel(nn.Module):
    def __init__(self, config: UNet3DConfig = UNet3DConfig()):
        super().__init__()
        self.config = cfg = config
        self.use_motion_kernel = False
        ch0 = cfg.block_out_channels[0]
        temb_ch = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb_ch, cfg.time_cond_proj_dim)
        self.conv_in = InflatedConv(cfg.in_channels, ch0, 3, padding=1)

        self.down_blocks = nn.ModuleList()
        for i, block_type in enumerate(cfg.down_block_types):
            in_ch = cfg.block_out_channels[max(i - 1, 0)]
            out_ch = cfg.block_out_channels[i]
            use_motion = (
                cfg.use_motion_module
                and (2**i) in cfg.motion_module_resolutions
                and not cfg.motion_module_decoder_only
            )
            blk = _Block()
            blk.resnets = nn.ModuleList(
                self._resnet(in_ch if j == 0 else out_ch, out_ch)
                for j in range(cfg.layers_per_block)
            )
            if block_type == "CrossAttnDownBlock3D":
                blk.attentions = nn.ModuleList(
                    self._spatial(out_ch) for _ in range(cfg.layers_per_block)
                )
            if use_motion:
                blk.motion_modules = nn.ModuleList(
                    self._motion(out_ch) for _ in range(cfg.layers_per_block)
                )
            if i < len(cfg.down_block_types) - 1:
                blk.downsamplers = nn.ModuleList([Downsample3D(out_ch, out_ch)])
            self.down_blocks.append(blk)

        mid_ch = cfg.block_out_channels[-1]
        self.mid_block = _Block()
        self.mid_block.resnets = nn.ModuleList(
            [self._resnet(mid_ch, mid_ch), self._resnet(mid_ch, mid_ch)]
        )
        self.mid_block.attentions = nn.ModuleList([self._spatial(mid_ch)])
        if cfg.use_motion_module and cfg.motion_module_mid_block:
            self.mid_block.motion_modules = nn.ModuleList([self._motion(mid_ch)])

        reversed_ch = list(reversed(cfg.block_out_channels))
        self.up_blocks = nn.ModuleList()
        prev_ch = mid_ch
        n_up = len(cfg.up_block_types)
        for i, block_type in enumerate(cfg.up_block_types):
            out_ch = reversed_ch[i]
            skip_in = reversed_ch[min(i + 1, n_up - 1)]
            resolution = 2 ** (n_up - 1 - i)
            use_motion = cfg.use_motion_module and resolution in cfg.motion_module_resolutions
            blk = _Block()
            resnets = []
            for j in range(cfg.layers_per_block + 1):
                skip_ch = skip_in if j == cfg.layers_per_block else out_ch
                res_in = prev_ch if j == 0 else out_ch
                resnets.append(self._resnet(res_in + skip_ch, out_ch))
            blk.resnets = nn.ModuleList(resnets)
            if block_type == "CrossAttnUpBlock3D":
                blk.attentions = nn.ModuleList(
                    self._spatial(out_ch) for _ in range(cfg.layers_per_block + 1)
                )
            if use_motion:
                blk.motion_modules = nn.ModuleList(
                    self._motion(out_ch) for _ in range(cfg.layers_per_block + 1)
                )
            if i < n_up - 1:
                blk.upsamplers = nn.ModuleList([Upsample3D(out_ch, out_ch)])
            self.up_blocks.append(blk)
            prev_ch = out_ch

        self.conv_norm_out = VideoGroupNorm(
            cfg.norm_num_groups, ch0, cfg.use_inflated_groupnorm, eps=1e-5
        )
        self.conv_out = InflatedConv(ch0, cfg.out_channels, 3, padding=1)

    def _resnet(self, in_ch: int, out_ch: int) -> ResnetBlock3D:
        cfg = self.config
        return ResnetBlock3D(
            in_ch, out_ch, cfg.block_out_channels[0] * 4, groups=cfg.norm_num_groups,
            eps=1e-5, inflated=cfg.use_inflated_groupnorm,
        )

    def _spatial(self, ch: int) -> SpatialTransformer:
        cfg = self.config
        return SpatialTransformer(
            ch, cfg.attention_heads, ch // cfg.attention_heads,
            cross_attention_dim=cfg.cross_attention_dim,
            upcast_attention=cfg.upcast_attention, groups=cfg.norm_num_groups,
            cross_frame=cfg.cross_frame_attention,
            temporal_attention=cfg.temporal_attention,
            tome_ratio=cfg.token_merge_ratio, ip_tokens=cfg.ip_tokens,
        )

    def set_motion_kernel(self, enabled: bool) -> None:
        """Route every motion module of K3's shape through K3 (or back to the
        dense path, dropping K3's packed weights: 14 C^2 values a module)."""
        self.use_motion_kernel = bool(enabled)
        for m in self.modules():
            if isinstance(m, MotionModule):
                m.use_motion_kernel = self.use_motion_kernel
                if not enabled:
                    m.temporal_transformer._packing = None

    def _motion(self, ch: int) -> MotionModule:
        cfg = self.config
        m = cfg.motion
        return MotionModule(
            ch, heads=m.num_attention_heads, num_transformer_block=m.num_transformer_block,
            attention_block_types=m.attention_block_types,
            max_len=m.temporal_position_encoding_max_len,
            use_pos_encoding=m.temporal_position_encoding, groups=cfg.norm_num_groups,
            band=m.attention_band,
            tome_ratio=cfg.token_merge_ratio if cfg.token_merge_motion else 0.0,
        )

    def forward(
        self,
        sample: torch.Tensor,  # (B, F, H, W, C_in) latents
        timesteps: torch.Tensor,  # (B,) or scalar
        encoder_hidden_states: torch.Tensor,  # (B, L, D) text embeddings
        timestep_cond: Optional[torch.Tensor] = None,  # (B, cond_dim) LCM w-embedding
        down_block_additional_residuals=None,
        mid_block_additional_residual=None,
        ip_scale: float = 1.0,
    ) -> torch.Tensor:
        cfg = self.config
        B = sample.shape[0]
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(B)
        t_emb = timestep_embedding(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_emb, timestep_cond)
        ctx = encoder_hidden_states

        sample = self.conv_in(sample)
        skips = [sample]
        for blk in self.down_blocks:
            for j, resnet in enumerate(blk.resnets):
                sample = resnet(sample, temb)
                if hasattr(blk, "attentions"):
                    sample = blk.attentions[j](sample, ctx, ip_scale)
                if hasattr(blk, "motion_modules"):
                    sample = blk.motion_modules[j](sample)
                skips.append(sample)
            if hasattr(blk, "downsamplers"):
                sample = blk.downsamplers[0](sample)
                skips.append(sample)

        mid = self.mid_block
        sample = mid.resnets[0](sample, temb)
        sample = mid.attentions[0](sample, ctx, ip_scale)
        if hasattr(mid, "motion_modules"):
            sample = mid.motion_modules[0](sample)
        sample = mid.resnets[1](sample, temb)

        # ControlNet residuals
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(skips):
                raise ValueError(f"{len(down_block_additional_residuals)} ControlNet down "
                                 f"residuals for {len(skips)} skips")
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_additional_residuals)]
        if mid_block_additional_residual is not None:
            sample = sample + mid_block_additional_residual.to(sample.dtype)

        for blk in self.up_blocks:
            for j, resnet in enumerate(blk.resnets):
                skip = skips.pop()
                sample = resnet(torch.cat([sample, skip.to(sample.dtype)], dim=-1), temb)
                if hasattr(blk, "attentions"):
                    sample = blk.attentions[j](sample, ctx, ip_scale)
                if hasattr(blk, "motion_modules"):
                    sample = blk.motion_modules[j](sample)
            if hasattr(blk, "upsamplers"):
                sample = blk.upsamplers[0](sample)

        sample = F.silu(self.conv_norm_out(sample))
        return self.conv_out(sample)
