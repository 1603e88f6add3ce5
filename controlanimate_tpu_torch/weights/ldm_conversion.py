"""LDM (CompVis) single-file checkpoint -> diffusers-layout state dicts.

A copy of `controlanimate_tpu/weights/ldm_conversion.py` on torch tensors:
key-rename passes over the flat state dict (SD1.x geometry: 4 levels, 2
resnets per encoder level, transformer depth 1). `convert_ldm_vae` serves a
single-file `vae_path`; `split_ldm_checkpoint` a DreamBooth file (without
`use_lcm`), its text tower either SD1.x's CLIP or SD2.x's open-clip
(`convert_open_clip`). `convert_ldm_controlnet` converts a single-file
ControlNet (`control_model.*`); the facade does not call it, as the JAX
facade does not: ControlNets are read from diffusers folders.
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


def _encoder_key(k: str) -> str | None:
    """The diffusers key of an LDM UNet key of the time embedding, the input
    blocks or the middle block (the half a ControlNet shares); None for
    any other key."""
    if k.startswith("time_embed.0."):
        return "time_embedding.linear_1." + k.split(".")[-1]
    if k.startswith("time_embed.2."):
        return "time_embedding.linear_2." + k.split(".")[-1]
    if k.startswith("input_blocks.0.0."):
        return "conv_in." + k.split(".")[-1]
    if k.startswith("input_blocks."):
        m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", k)
        n, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
        level, pos = (n - 1) // 3, (n - 1) % 3
        if pos == 2:  # downsampler slot
            assert rest.startswith("op.")
            return f"down_blocks.{level}.downsamplers.0.conv.{rest[3:]}"
        if sub == 0:
            return f"down_blocks.{level}.resnets.{pos}.{_rename_resnet(rest)}"
        return f"down_blocks.{level}.attentions.{pos}.{rest}"
    if k.startswith("middle_block.0."):
        return f"mid_block.resnets.0.{_rename_resnet(k[len('middle_block.0.'):])}"
    if k.startswith("middle_block.1."):
        return f"mid_block.attentions.0.{k[len('middle_block.1.'):]}"
    if k.startswith("middle_block.2."):
        return f"mid_block.resnets.1.{_rename_resnet(k[len('middle_block.2.'):])}"
    return None


def convert_ldm_unet(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """model.diffusion_model.* -> diffusers UNet2DConditionModel keys
    (SD1.x: layers_per_block=2, one attention per resnet where present)."""
    src = _strip(sd, "model.diffusion_model.") or sd
    out: dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if (nk := _encoder_key(k)) is not None:
            out[nk] = v
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
    """cond_stage_model.transformer.* -> HF CLIPTextModel keys (SD1.x);
    SD2.x open-clip towers (cond_stage_model.model.*) go to
    `convert_open_clip`."""
    src = _strip(sd, "cond_stage_model.transformer.")
    if not src and any(k.startswith("cond_stage_model.model.") for k in sd):
        return convert_open_clip(sd)
    return {k: v for k, v in src.items() if k.startswith("text_model.")}


# open-clip resblock -> HF CLIPTextModel renames
_OPENCLIP_RENAMES = [
    ("resblocks.", "text_model.encoder.layers."),
    ("ln_1", "layer_norm1"),
    ("ln_2", "layer_norm2"),
    (".c_fc.", ".fc1."),
    (".c_proj.", ".fc2."),
    (".attn", ".self_attn"),
]

_OPENCLIP_TOPLEVEL = {
    "positional_embedding": "text_model.embeddings.position_embedding.weight",
    "token_embedding.weight": "text_model.embeddings.token_embedding.weight",
    "ln_final.weight": "text_model.final_layer_norm.weight",
    "ln_final.bias": "text_model.final_layer_norm.bias",
}


def _rename_open_clip(k: str) -> str:
    for old, new in _OPENCLIP_RENAMES:
        k = k.replace(old, new)
    return k


def convert_open_clip(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """cond_stage_model.model.* (SD2.x's open-clip text tower) -> HF
    CLIPTextModel keys: the last layer (resblocks.23) dropped, as diffusers'
    SD2 text encoder reads the penultimate hidden state; each fused
    in_proj split into q/k/v at d_model (text_projection's rows, else
    1024); text_projection and logit_scale dropped."""
    src = _strip(sd, "cond_stage_model.model.")
    if not src:
        raise ValueError("no cond_stage_model.model.* keys (not an open-clip checkpoint)")
    tp = src.get("text_projection")
    d = int(tp.shape[0]) if tp is not None else 1024
    out: dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if k in _OPENCLIP_TOPLEVEL:
            out[_OPENCLIP_TOPLEVEL[k]] = v
            continue
        if not k.startswith("transformer."):
            continue  # text_projection, logit_scale
        rest = k[len("transformer."):]
        if rest.startswith("resblocks.23."):
            continue
        if rest.endswith((".attn.in_proj_weight", ".attn.in_proj_bias")):
            base, proj = rest.rsplit(".", 1)  # "resblocks.N.attn"
            suffix = "weight" if proj.endswith("weight") else "bias"
            base = _rename_open_clip(base)
            out[f"{base}.q_proj.{suffix}"] = v[:d]
            out[f"{base}.k_proj.{suffix}"] = v[d:2 * d]
            out[f"{base}.v_proj.{suffix}"] = v[2 * d:]
            continue
        out[_rename_open_clip(rest)] = v
    return out


def convert_ldm_controlnet(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """control_model.* (or unprefixed) single-file ControlNet -> diffusers
    ControlNetModel keys: the UNet's encoder half as `convert_ldm_unet`
    renames it, input_hint_block.{0, 2, ..., 14} -> controlnet_cond_embedding
    .conv_in / .blocks.{0..5} / .conv_out (the odd indices are
    activations), zero_convs.{i}.0 -> controlnet_down_blocks.{i},
    middle_block_out.0 -> controlnet_mid_block. An unprefixed file keeps
    every key of no other tower (model., cond_stage_model.,
    first_stage_model., model_ema.)."""
    src = _strip(sd, "control_model.")
    if not src:
        src = {k: v for k, v in sd.items()
               if not k.startswith(("model.", "cond_stage_model.", "first_stage_model.",
                                    "model_ema."))}
    out: dict[str, torch.Tensor] = {}
    for k, v in src.items():
        if k.startswith("input_hint_block."):
            m = re.match(r"input_hint_block\.(\d+)\.(.*)", k)
            idx, rest = int(m.group(1)), m.group(2)
            part = ("conv_in" if idx == 0 else "conv_out" if idx == 14
                    else f"blocks.{idx // 2 - 1}")
            out[f"controlnet_cond_embedding.{part}.{rest}"] = v
        elif k.startswith("zero_convs."):
            m = re.match(r"zero_convs\.(\d+)\.0\.(.*)", k)
            out[f"controlnet_down_blocks.{m.group(1)}.{m.group(2)}"] = v
        elif k.startswith("middle_block_out.0."):
            out["controlnet_mid_block." + k.split(".")[-1]] = v
        elif (nk := _encoder_key(k)) is not None:
            out[nk] = v
    return out


def split_ldm_checkpoint(sd: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """One DreamBooth single-file checkpoint -> {unet, vae, clip} diffusers
    state dicts (reference: util.py:123-141)."""
    return {
        "unet": convert_ldm_unet(sd),
        "vae": convert_ldm_vae(sd),
        "clip": convert_ldm_clip(sd),
    }
