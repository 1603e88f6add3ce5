"""LDM (CompVis) single-file checkpoint -> diffusers-layout state dicts.

A copy of `controlanimate_tpu/weights/ldm_conversion.py` on torch tensors:
key-rename passes over the flat state dict (SD1.x geometry: 4 levels, 2
resnets per encoder level, transformer depth 1). `convert_ldm_vae` serves a
single-file `vae_path`; `split_ldm_checkpoint` a DreamBooth file (without
`use_lcm`). The open-clip text tower of SD2.x checkpoints and single-file
ControlNets (`convert_open_clip`, `convert_ldm_controlnet`) are not ported
yet: an open-clip checkpoint raises NotImplementedError.
"""

from __future__ import annotations

import re

import torch


def _strip(sd: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


_RES_RENAMES = [
    ("in_layers.0.", "norm1."),
    ("in_layers.2.", "conv1."),
    ("emb_layers.1.", "time_emb_proj."),
    ("out_layers.0.", "norm2."),
    ("out_layers.3.", "conv2."),
    ("skip_connection.", "conv_shortcut."),
]


def _rename_resnet(rest: str) -> str:
    for old, new in _RES_RENAMES:
        if rest.startswith(old):
            return new + rest[len(old):]
    return rest


def convert_ldm_unet(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """model.diffusion_model.* -> diffusers UNet2DConditionModel keys
    (SD1.x: layers_per_block=2, one attention per resnet where present)."""
    src = _strip(sd, "model.diffusion_model.") or sd
    out: dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if k.startswith("time_embed.0."):
            out["time_embedding.linear_1." + k.split(".")[-1]] = v
        elif k.startswith("time_embed.2."):
            out["time_embedding.linear_2." + k.split(".")[-1]] = v
        elif k.startswith("input_blocks.0.0."):
            out["conv_in." + k.split(".")[-1]] = v
        elif k.startswith("input_blocks."):
            m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", k)
            n, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            level, pos = (n - 1) // 3, (n - 1) % 3
            if pos == 2:  # downsampler slot
                assert rest.startswith("op.")
                out[f"down_blocks.{level}.downsamplers.0.conv.{rest[3:]}"] = v
            elif sub == 0:
                out[f"down_blocks.{level}.resnets.{pos}.{_rename_resnet(rest)}"] = v
            else:
                out[f"down_blocks.{level}.attentions.{pos}.{rest}"] = v
        elif k.startswith("middle_block.0."):
            out[f"mid_block.resnets.0.{_rename_resnet(k[len('middle_block.0.'):])}"] = v
        elif k.startswith("middle_block.1."):
            out[f"mid_block.attentions.0.{k[len('middle_block.1.'):]}"] = v
        elif k.startswith("middle_block.2."):
            out[f"mid_block.resnets.1.{_rename_resnet(k[len('middle_block.2.'):])}"] = v
        elif k.startswith("output_blocks."):
            m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", k)
            n, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            level, pos = n // 3, n % 3
            if sub == 0:
                out[f"up_blocks.{level}.resnets.{pos}.{_rename_resnet(rest)}"] = v
            elif rest.startswith("conv.") and sub >= 1 and pos == 2:
                # upsampler is the trailing module of the last block at a level
                out[f"up_blocks.{level}.upsamplers.0.{rest}"] = v
            else:
                out[f"up_blocks.{level}.attentions.{pos}.{rest}"] = v
        elif k.startswith("out.0."):
            out["conv_norm_out." + k.split(".")[-1]] = v
        elif k.startswith("out.2."):
            out["conv_out." + k.split(".")[-1]] = v
    return out


_VAE_ATTN_RENAMES = [
    ("norm.", "group_norm."),
    ("q.", "to_q."),
    ("k.", "to_k."),
    ("v.", "to_v."),
    ("proj_out.", "to_out.0."),
]


def _rename_vae_resnet(rest: str) -> str:
    return rest.replace("nin_shortcut.", "conv_shortcut.")


def _rename_vae_attn(rest: str) -> str:
    for old, new in _VAE_ATTN_RENAMES:
        if rest.startswith(old):
            return new + rest[len(old):]
    return rest


def convert_ldm_vae(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """first_stage_model.* -> diffusers AutoencoderKL keys, at the SD VAE's
    four levels."""
    src = _strip(sd, "first_stage_model.") or sd
    out: dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if k.startswith("encoder.down."):
            m = re.match(r"encoder\.down\.(\d+)\.(block|downsample|attn)\.(.*)", k)
            lvl, kind, rest = int(m.group(1)), m.group(2), m.group(3)
            if kind == "block":
                j, rest2 = rest.split(".", 1)
                out[f"encoder.down_blocks.{lvl}.resnets.{j}.{_rename_vae_resnet(rest2)}"] = v
            elif kind == "downsample":
                out[f"encoder.down_blocks.{lvl}.downsamplers.0.{rest}"] = v
        elif k.startswith("decoder.up."):
            m = re.match(r"decoder\.up\.(\d+)\.(block|upsample|attn)\.(.*)", k)
            lvl, kind, rest = int(m.group(1)), m.group(2), m.group(3)
            dlvl = 3 - lvl  # LDM indexes decoder levels reversed
            if kind == "block":
                j, rest2 = rest.split(".", 1)
                out[f"decoder.up_blocks.{dlvl}.resnets.{j}.{_rename_vae_resnet(rest2)}"] = v
            elif kind == "upsample":
                out[f"decoder.up_blocks.{dlvl}.upsamplers.0.{rest}"] = v
        elif re.match(r"(encoder|decoder)\.mid\.", k):
            m = re.match(r"(encoder|decoder)\.mid\.(block_1|attn_1|block_2)\.(.*)", k)
            tower, blk, rest = m.group(1), m.group(2), m.group(3)
            if blk == "block_1":
                out[f"{tower}.mid_block.resnets.0.{_rename_vae_resnet(rest)}"] = v
            elif blk == "block_2":
                out[f"{tower}.mid_block.resnets.1.{_rename_vae_resnet(rest)}"] = v
            else:
                # legacy attn weights may be (C, C, 1, 1) convs; squeeze
                nk = f"{tower}.mid_block.attentions.0.{_rename_vae_attn(rest)}"
                if nk.endswith("weight") and v.ndim == 4 and "group_norm" not in nk:
                    v = v[:, :, 0, 0]
                out[nk] = v
        elif k.startswith(("encoder.norm_out.", "decoder.norm_out.")):
            tower = k.split(".")[0]
            out[f"{tower}.conv_norm_out.{k.split('.')[-1]}"] = v
        elif k.startswith(("encoder.conv_in.", "encoder.conv_out.", "decoder.conv_in.",
                           "decoder.conv_out.", "quant_conv.", "post_quant_conv.")):
            out[k] = v
    return out


def convert_ldm_clip(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """cond_stage_model.transformer.* -> HF CLIPTextModel keys (SD1.x)."""
    src = _strip(sd, "cond_stage_model.transformer.")
    if not src and any(k.startswith("cond_stage_model.model.") for k in sd):
        raise NotImplementedError(
            "open-clip text towers (SD2.x, cond_stage_model.model.*) are not ported yet")
    return {k: v for k, v in src.items() if k.startswith("text_model.")}


def split_ldm_checkpoint(sd: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """One DreamBooth single-file checkpoint -> {unet, vae, clip} diffusers
    state dicts (reference: util.py:123-141)."""
    return {
        "unet": convert_ldm_unet(sd),
        "vae": convert_ldm_vae(sd),
        "clip": convert_ldm_clip(sd),
    }
