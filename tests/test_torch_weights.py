"""The port's weight modules (`controlanimate_tpu_torch/weights/`) against the
JAX package's on the same inputs: the LDM single-file conversions and the
DreamBooth split, LoRA fusing in the Kohya, peft and motion-processor
formats, textual-inversion registration, and the key rules of the UNet, VAE
and text-encoder loaders. Keys and values equal; token ids equal."""

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.weights import ldm_conversion as jldm
from controlanimate_tpu.weights import lora as jlora
from controlanimate_tpu.weights import textual_inversion as jti
from controlanimate_tpu.weights import vae_weights as jvae
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.weights import ldm_conversion as ldm
from controlanimate_tpu_torch.weights import lora
from controlanimate_tpu_torch.weights import textual_inversion as ti
from controlanimate_tpu_torch.weights import vae_weights
from controlanimate_tpu_torch.weights.clip_weights import text_state_dict_from_torch
from controlanimate_tpu_torch.weights.unet_weights import unet_state_dict_from_torch


def _random(keys_shapes, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.randn(*s).astype(np.float32) for k, s in keys_shapes.items()}


def _torch(sd):
    return {k: torch.from_numpy(v.copy()) for k, v in sd.items()}


def _assert_same(mine: dict, theirs: dict):
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), np.asarray(v), err_msg=k)


# LDM keys of every kind the converters rename (a few of each, SD1.x numbering)
LDM_UNET = {
    "time_embed.0.weight": (8, 4), "time_embed.2.bias": (8,), "input_blocks.0.0.weight": (4, 4, 3, 3),
    "input_blocks.1.0.in_layers.0.weight": (4,), "input_blocks.1.0.in_layers.2.weight": (4, 4, 3, 3),
    "input_blocks.1.0.emb_layers.1.weight": (4, 8), "input_blocks.1.1.proj_in.weight": (4, 4, 1, 1),
    "input_blocks.2.1.transformer_blocks.0.attn1.to_q.weight": (4, 4),
    "input_blocks.3.0.op.weight": (4, 4, 3, 3), "input_blocks.4.0.skip_connection.weight": (8, 4, 1, 1),
    "middle_block.0.out_layers.3.bias": (8,), "middle_block.1.norm.weight": (8,),
    "middle_block.2.out_layers.0.weight": (8,), "output_blocks.0.0.in_layers.0.bias": (16,),
    "output_blocks.2.1.conv.weight": (8, 8, 3, 3), "output_blocks.4.1.proj_out.bias": (8,),
    "output_blocks.5.2.conv.bias": (8,), "output_blocks.5.1.norm.bias": (8,),
    "out.0.weight": (4,), "out.2.bias": (4,),
}
LDM_VAE = {
    "encoder.conv_in.weight": (8, 3, 3, 3), "encoder.down.0.block.0.norm1.weight": (8,),
    "encoder.down.0.block.1.nin_shortcut.weight": (8, 8, 1, 1),
    "encoder.down.0.downsample.conv.weight": (8, 8, 3, 3), "encoder.mid.block_1.conv1.bias": (8,),
    "encoder.mid.attn_1.norm.weight": (8,), "encoder.mid.attn_1.q.weight": (8, 8, 1, 1),
    "encoder.mid.attn_1.proj_out.bias": (8,), "encoder.mid.block_2.conv2.weight": (8, 8, 3, 3),
    "encoder.norm_out.bias": (8,), "encoder.conv_out.weight": (8, 8, 3, 3),
    "decoder.up.3.block.0.conv1.weight": (8, 8, 3, 3), "decoder.up.0.block.2.norm2.bias": (8,),
    "decoder.up.2.upsample.conv.weight": (8, 8, 3, 3), "decoder.mid.attn_1.v.weight": (8, 8),
    "decoder.mid.attn_1.k.bias": (8,), "decoder.norm_out.weight": (8,),
    "quant_conv.weight": (8, 8, 1, 1), "post_quant_conv.bias": (4,),
}
LDM_CLIP = {
    "text_model.embeddings.token_embedding.weight": (10, 4),
    "text_model.encoder.layers.0.self_attn.q_proj.weight": (4, 4),
    "text_model.final_layer_norm.bias": (4,),
}


def test_convert_ldm_unet_vae_clip_match_jax():
    unet = _random({f"model.diffusion_model.{k}": s for k, s in LDM_UNET.items()}, 0)
    vae = _random({f"first_stage_model.{k}": s for k, s in LDM_VAE.items()}, 1)
    clip = _random({f"cond_stage_model.transformer.{k}": s for k, s in LDM_CLIP.items()}, 2)
    _assert_same(ldm.convert_ldm_unet(_torch(unet)), jldm.convert_ldm_unet(unet))
    _assert_same(ldm.convert_ldm_vae(_torch(vae)), jldm.convert_ldm_vae(vae))
    _assert_same(ldm.convert_ldm_clip(_torch(clip)), jldm.convert_ldm_clip(clip))
    # unprefixed files convert as well
    bare = _random(LDM_VAE, 3)
    _assert_same(ldm.convert_ldm_vae(_torch(bare)), jldm.convert_ldm_vae(bare))


def test_split_ldm_checkpoint_matches_jax():
    sd = {**_random({f"model.diffusion_model.{k}": s for k, s in LDM_UNET.items()}, 4),
          **_random({f"first_stage_model.{k}": s for k, s in LDM_VAE.items()}, 5),
          **_random({f"cond_stage_model.transformer.{k}": s for k, s in LDM_CLIP.items()}, 6)}
    mine, theirs = ldm.split_ldm_checkpoint(_torch(sd)), jldm.split_ldm_checkpoint(sd)
    assert set(mine) == set(theirs) == {"unet", "vae", "clip"}
    for part in mine:
        _assert_same(mine[part], theirs[part])


def test_open_clip_towers_are_not_ported():
    with pytest.raises(NotImplementedError, match="open-clip"):
        ldm.convert_ldm_clip({"cond_stage_model.model.ln_final.weight": torch.ones(4)})


def test_normalize_vae_keys_matches_jax():
    sd = _random({"decoder.mid_block.attentions.0.query.weight": (8, 8, 1, 1),
                  "decoder.mid_block.attentions.0.proj_attn.bias": (8,),
                  "encoder.mid_block.attentions.0.key.weight": (8, 8),
                  "encoder.conv_in.weight": (8, 3, 3, 3)}, 7)
    _assert_same(vae_weights.normalize_vae_keys(_torch(sd)), jvae.normalize_vae_keys(sd))
    with pytest.raises(KeyError, match="missing VAE weight"):
        vae_weights.vae_state_dict_from_torch(_torch(sd), ["decoder.conv_out.weight"])


BASE_SD = {
    "down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight": (8, 6),
    "down_blocks.0.attentions.0.proj_in.weight": (8, 8, 1, 1),
    "mid_block.attentions.0.transformer_blocks.0.ff.net.2.weight": (8, 16),
    "text_model.encoder.layers.0.self_attn.q_proj.weight": (6, 6),
    "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0"
    ".attention_blocks.0.to_q.weight": (8, 8),
    "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0"
    ".attention_blocks.1.to_out.0.weight": (8, 8),
}


def _lora_files(rng):
    up = lambda o, r: rng.randn(o, r).astype(np.float32)  # noqa: E731
    down = lambda r, i: rng.randn(r, i).astype(np.float32)  # noqa: E731
    mm = "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0"
    return {
        "kohya": {
            "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k.lora_up.weight":
                up(8, 2),
            "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k.lora_down.weight":
                down(2, 6),
            "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k.alpha":
                np.asarray(1.5, np.float32),
            "lora_unet_down_blocks_0_attentions_0_proj_in.lora_up.weight":
                up(8, 2).reshape(8, 2, 1, 1),
            "lora_unet_down_blocks_0_attentions_0_proj_in.lora_down.weight":
                down(2, 8).reshape(2, 8, 1, 1),
            "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_up.weight": up(6, 2),
            "lora_te_text_model_encoder_layers_0_self_attn_q_proj.lora_down.weight": down(2, 6),
        },
        "peft": {
            "unet.mid_block.attentions.0.transformer_blocks.0.ff.net.2.lora_A.weight": down(4, 16),
            "unet.mid_block.attentions.0.transformer_blocks.0.ff.net.2.lora_B.weight": up(8, 4),
            "text_encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_A.weight": down(3, 6),
            "text_encoder.text_model.encoder.layers.0.self_attn.q_proj.lora_B.weight": up(6, 3),
        },
        "processor": {
            f"{mm}.attention_blocks.0.processor.to_q_lora.down.weight": down(2, 8),
            f"{mm}.attention_blocks.0.processor.to_q_lora.up.weight": up(8, 2),
            f"{mm}.attention_blocks.1.processor.to_out_lora.down.weight": down(2, 8),
            f"{mm}.attention_blocks.1.processor.to_out_lora.up.weight": up(8, 2),
        },
    }


@pytest.mark.parametrize("fmt", ["kohya", "peft", "processor"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fuse_lora_matches_jax(fmt, dtype):
    """Both split the file by component and fuse in numpy float32: the fused
    weights are the same bits. A bf16 state dict is what the JAX loader
    reads as float32."""
    rng = np.random.RandomState(8)
    sd = _random(BASE_SD, 9)
    lora_sd = _lora_files(rng)[fmt]
    mine_sd = {k: torch.from_numpy(v).to(dtype) for k, v in sd.items()}
    theirs_sd = {k: v.float().numpy() for k, v in mine_sd.items()}
    mine_parts = lora.split_lora_by_component(_torch(lora_sd))
    theirs_parts = jlora.split_lora_by_component(lora_sd)
    assert {p: set(v) for p, v in mine_parts.items()} == {p: set(v)
                                                          for p, v in theirs_parts.items()}
    total = 0
    for part in ("unet", "text_encoder"):
        mine, n_mine = lora.fuse_lora(mine_sd, mine_parts[part], scale=0.7)
        theirs, n_theirs = jlora.fuse_lora(theirs_sd, theirs_parts[part], scale=0.7)
        assert n_mine == n_theirs
        total += n_mine
        for k, v in theirs.items():
            np.testing.assert_array_equal(mine[k].float().numpy(), np.asarray(v, np.float32),
                                          err_msg=k)
    assert total == {"kohya": 3, "peft": 2, "processor": 2}[fmt]


def test_textual_inversion_matches_jax(tmp_path):
    rng = np.random.RandomState(10)
    a = tmp_path / "EasyNeg.safetensors"
    save_file({"emb_params": rng.randn(3, 16).astype(np.float32)}, str(a))
    b = tmp_path / "style.pt"
    torch.save({"string_to_param": {"*": torch.from_numpy(rng.randn(2, 16).astype(np.float32))},
                "name": "style"}, b)
    mine_tok, theirs_tok = CLIPTokenizer.tiny(), JaxTokenizer.tiny()
    mine = ti.register_textual_inversions(mine_tok, [str(a), str(b)])
    theirs = jti.register_textual_inversions(theirs_tok, [str(a), str(b)])
    np.testing.assert_array_equal(mine.numpy(), theirs)
    prompt = "a photo, easyneg and style"
    np.testing.assert_array_equal(mine_tok(prompt), theirs_tok(prompt))
    assert ti.register_textual_inversions(CLIPTokenizer.tiny(), []) is None
    with pytest.raises(FileNotFoundError):
        ti.register_textual_inversions(CLIPTokenizer.tiny(), [str(tmp_path / "absent.pt")])


def test_unet_key_rules():
    """Motion keys only from the motion file (its `module.` prefix
    stripped), 2D keys from the 2D file or else the motion file, the
    motion file's positional-encoding tables ignored, and a missing key of
    either kind raises."""
    mm = "down_blocks.0.motion_modules.0.temporal_transformer"
    keys = ["conv_in.weight", "conv_out.bias", f"{mm}.proj_in.weight"]
    t = {k: torch.full((1,), float(i)) for i, k in enumerate(keys)}
    sd_2d = {"conv_in.weight": t["conv_in.weight"], f"{mm}.proj_in.weight": torch.zeros(1)}
    motion = {f"module.{mm}.proj_in.weight": t[f"{mm}.proj_in.weight"],
              "conv_out.bias": t["conv_out.bias"],
              f"{mm}.transformer_blocks.0.attention_blocks.0.pos_encoder.pe": torch.zeros(1, 24, 8)}
    out = unet_state_dict_from_torch(sd_2d, keys, motion)
    assert set(out) == set(keys) and all(out[k] is t[k] for k in keys)
    with pytest.raises(KeyError, match="missing UNet weight"):
        unet_state_dict_from_torch({}, keys, motion)
    with pytest.raises(KeyError, match="motion-module checkpoint lacks"):
        unet_state_dict_from_torch(sd_2d, keys, {"conv_out.bias": t["conv_out.bias"]})


def test_text_encoder_prefix_rule_and_extra_rows():
    keys = ["text_model.embeddings.token_embedding.weight", "text_model.final_layer_norm.bias"]
    tok, bias, extra = torch.randn(5, 4), torch.randn(4), torch.randn(2, 4)
    for pre in ("text_model.", ""):
        sd = {f"{pre}embeddings.token_embedding.weight": tok,
              f"{pre}final_layer_norm.bias": bias}
        out = text_state_dict_from_torch(sd, keys, extra)
        assert torch.equal(out[keys[0]], torch.cat([tok, extra])) and out[keys[1]] is bias
    with pytest.raises(KeyError):
        text_state_dict_from_torch({"text_model.final_layer_norm.bias": bias}, keys)
