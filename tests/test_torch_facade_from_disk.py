"""The port's disk build and CLI on synthetic model zoos written from seeded
weights (nothing is downloaded):

  * the slice as a whole: an LCM snapshot (`time_cond_proj_dim` in the unet
    config.json), a single-file LDM `vae_path` with legacy attention
    weights, an AnimateDiff v1 motion checkpoint with its `pos_encoder.pe`
    tables, a motion LoRA and a textual-inversion file, built by the JAX
    `ControlAnimatePipeline` and by the port's on the CPU in fp32: the port's
    module state dicts equal `weights/from_jax.py` applied to the JAX
    parameter trees exactly, and the tokenizers give the same ids;
  * without LCM, the Kohya UNet + text-encoder LoRA fused as in JAX, and a
    window of the default profile's sampler (Euler under classifier-free
    guidance) from the built pipeline within 1 LSB of the JAX facade's;
  * one run of the port's CLI (`python -m controlanimate_tpu_torch`, called
    in-process) over a PNG directory: its frames equal `vid2vid` with the
    injected pipeline of the same weights;
  * every path the build reads raises FileNotFoundError when missing, where
    the JAX build skips it or falls back; paths it does not read are not
    checked; a LoRA file that matches no layer raises, and a motion LoRA
    fuses into the blocks whose checkpoint keys carry `module.`;
  * the ControlNets from disk are in
    `tests/test_torch_facade_from_disk_controlnets.py`, on this file's zoo.
"""

import json
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from safetensors.torch import save_file

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from controlanimate_tpu_torch.models.vae import AutoencoderKL
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from controlanimate_tpu_torch.models.annotators import seeded
from test_torch_common import JaxDraws

V1 = "configs/inference/inference-v1.yaml"
V2 = "configs/inference/inference-v2.yaml"
D_CTX = 16
UNET_JSON = {"in_channels": 4, "out_channels": 4, "block_out_channels": [8, 8, 16, 16],
             "layers_per_block": 1, "attention_head_dim": 2, "cross_attention_dim": D_CTX,
             "norm_num_groups": 4, "time_cond_proj_dim": 8}
TINY_VAE = {"block_out_channels": [8, 16, 16, 16], "norm_num_groups": 4,
            "scaling_factor": 0.18215}
SIZE = 64
REPO = Path(__file__).resolve().parent.parent  # the ControlNet tests change directory


def _seed_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Seeded lecun-normal matrices and kernels, norm scales 1 + N(0, 0.1^2),
    biases N(0, 0.05^2)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return module.eval()


def _ldm_vae_key(k: str) -> str:
    """diffusers AutoencoderKL key -> LDM `first_stage_model.` key (the
    inverse of `convert_ldm_vae` at 4 levels)."""
    k = k.replace("conv_shortcut.", "nin_shortcut.")
    k = re.sub(r"encoder\.down_blocks\.(\d+)\.resnets\.", r"encoder.down.\1.block.", k)
    k = re.sub(r"encoder\.down_blocks\.(\d+)\.downsamplers\.0\.", r"encoder.down.\1.downsample.", k)
    k = re.sub(r"decoder\.up_blocks\.(\d+)\.resnets\.",
               lambda m: f"decoder.up.{3 - int(m.group(1))}.block.", k)
    k = re.sub(r"decoder\.up_blocks\.(\d+)\.upsamplers\.0\.",
               lambda m: f"decoder.up.{3 - int(m.group(1))}.upsample.", k)
    k = k.replace("mid_block.resnets.0.", "mid.block_1.").replace("mid_block.resnets.1.",
                                                                   "mid.block_2.")
    for old, new in (("group_norm.", "norm."), ("to_q.", "q."), ("to_k.", "k."),
                     ("to_v.", "v."), ("to_out.0.", "proj_out.")):
        k = k.replace(f"mid_block.attentions.0.{old}", f"mid.attn_1.{new}")
    k = k.replace("conv_norm_out.", "norm_out.")
    return "first_stage_model." + k


def _to_ldm_vae(sd: dict) -> dict:
    """LDM keys, the mid attention's projections as (C, C, 1, 1) convs as in
    the original checkpoints."""
    out = {}
    for k, v in sd.items():
        lk = _ldm_vae_key(k)
        if ".attn_1." in lk and lk.endswith("weight") and v.ndim == 2:
            v = v[:, :, None, None]
        out[lk] = v.contiguous()
    return out


def _save_component(root: Path, name: str, config: dict, sd: dict, fname: str) -> None:
    d = root / name
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config))
    save_file({k: v.contiguous() for k, v in sd.items()}, str(d / fname))


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A synthetic model zoo: the snapshot (tokenizer, text_encoder, a tiny
    vae, unet), a v2 motion checkpoint (mid block included; a v1 build reads
    the keys it has), a full-size LDM VAE file, a motion LoRA, a TI file, a
    Kohya LoRA and frames; and the port modules the files were written from."""
    root = tmp_path_factory.mktemp("zoo")
    snap = root / "LCM_snapshot"

    tok = CLIPTokenizer.tiny()
    (snap / "tokenizer").mkdir(parents=True)
    (snap / "tokenizer" / "vocab.json").write_text(json.dumps(tok.vocab))
    (snap / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")

    ccfg = CLIPTextConfig(vocab_size=len(tok.vocab), hidden_size=D_CTX, num_layers=2,
                          num_heads=2, intermediate_size=32, eos_token_id=tok.eos_token_id)
    clip = _seed_(CLIPTextModel(ccfg), 1)
    te_sd = {**clip.state_dict(),
             "text_model.embeddings.position_ids": torch.arange(77)[None]}
    _save_component(snap, "text_encoder", {
        "vocab_size": ccfg.vocab_size, "hidden_size": D_CTX, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 32, "max_position_embeddings": 77,
        "eos_token_id": ccfg.eos_token_id}, te_sd, "model.safetensors")

    vae = _seed_(AutoencoderKL(block_out_channels=TINY_VAE["block_out_channels"], groups=4), 2)
    _save_component(snap, "vae", TINY_VAE, vae.state_dict(), "diffusion_pytorch_model.safetensors")

    ucfg = UNet3DConfig.from_arch(ArchConfig.from_yaml(V2), UNET_JSON)
    unet = _seed_(UNet3DConditionModel(ucfg), 3)
    usd = unet.state_dict()
    _save_component(snap, "unet", UNET_JSON,
                    {k: v for k, v in usd.items() if "motion_modules" not in k},
                    "diffusion_pytorch_model.safetensors")
    # AnimateDiff's layout: the positional-encoding tables ship in the file;
    # the up blocks' keys carry a `module.` prefix
    motion = {("module." + k if k.startswith("up_blocks") else k): v
              for k, v in usd.items() if "motion_modules" in k}
    for k in [k for k in motion if k.endswith("attention_blocks.0.to_q.weight")]:
        pe_key = k.replace("to_q.weight", "pos_encoder.pe")
        motion[pe_key] = torch.randn(1, 24, motion[k].shape[0])
    torch.save(motion, root / "mm_sd_v15.ckpt")

    # a full-size single-file VAE: JAX builds a `vae_path` VAE at the SD geometry
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in AutoencoderKL().state_dict().items()}
    g = torch.Generator().manual_seed(4)
    full_vae = {k: 0.05 * torch.randn(s, generator=g) for k, s in shapes.items()}
    torch.save({"state_dict": _to_ldm_vae(full_vae)}, root / "vae-ft-mse.ckpt")

    mm = "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0"
    save_file({f"{mm}.attention_blocks.0.processor.to_q_lora.down.weight":
               torch.randn(2, 8, generator=g),
               f"{mm}.attention_blocks.0.processor.to_q_lora.up.weight":
               torch.randn(8, 2, generator=g),
               f"{mm}.attention_blocks.1.processor.to_out_lora.down.weight":
               torch.randn(2, 8, generator=g),
               f"{mm}.attention_blocks.1.processor.to_out_lora.up.weight":
               torch.randn(8, 2, generator=g)}, str(root / "motion_lora.safetensors"))
    save_file({"emb_params": torch.randn(2, D_CTX, generator=g)},
              str(root / "easynegative.safetensors"))
    k = "down_blocks_0_attentions_0_transformer_blocks_0_attn2_to_k"
    q = "text_model_encoder_layers_1_self_attn_q_proj"
    save_file({f"lora_unet_{k}.lora_up.weight": torch.randn(8, 2, generator=g),
               f"lora_unet_{k}.lora_down.weight": torch.randn(2, D_CTX, generator=g),
               f"lora_unet_{k}.alpha": torch.tensor(1.0),
               f"lora_te_{q}.lora_up.weight": torch.randn(D_CTX, 2, generator=g),
               f"lora_te_{q}.lora_down.weight": torch.randn(2, D_CTX, generator=g)},
              str(root / "style_lora.safetensors"))

    frames = root / "frames"
    frames.mkdir()
    rng = np.random.RandomState(5)
    for i in range(6):
        Image.fromarray(rng.randint(0, 255, (SIZE, SIZE, 3), dtype=np.uint8)).save(
            frames / f"{i:04d}.png")
    return {"root": root, "snapshot": snap, "unet": unet, "vae": vae, "clip": clip}


def _cfg(zoo, **kw) -> dict:
    root = zoo["root"]
    base = dict(
        use_lcm=True, pretrained_lcm_model_path=str(zoo["snapshot"]),
        inference_config_path=V1, motion_module=str(root / "mm_sd_v15.ckpt"),
        textual_inversion_paths=(), width=SIZE, height=SIZE, frame_count=4,
        overlap_length=2, steps=2, strength=0.9, overlap_strength=0.85, lcm_origin_steps=8,
        guidance_scale=7.5, dtype="float32", seed=5, prompt="a (red fox)+, easynegative",
        n_prompt="blurry", ffmpeg_path="ffmpeg-absent-here",
        output_video_dir=str(root / "out"))
    base.update(kw)
    return base


def _assert_state_equal(mine: dict, theirs: dict):
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k


def test_lcm_disk_build_equals_the_jax_build(zoo):
    root = zoo["root"]
    kw = _cfg(zoo, vae_path=str(root / "vae-ft-mse.ckpt"),
              motion_lora_paths=(str(root / "motion_lora.safetensors"),),
              motion_lora_alphas=(0.8,),
              textual_inversion_paths=(str(root / "easynegative.safetensors"),),
              dreambooth_path=str(root / "absent-dreambooth.safetensors"))
    jpipe = jfacade.ControlAnimatePipeline(JaxRunConfig(**kw))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    unet, vae, clip = tpipe.models.unet, tpipe.models.vae, tpipe.text.model

    ucfg = unet.config
    assert ucfg == UNet3DConfig.from_arch(ArchConfig.from_yaml(V1), UNET_JSON)
    assert not ucfg.motion_module_mid_block and ucfg.motion.temporal_position_encoding_max_len == 24
    assert ucfg.time_cond_proj_dim == 8 and not ucfg.use_inflated_groupnorm
    jparams = jax.device_get(jpipe.models.unet_params)
    _assert_state_equal(unet.state_dict(), from_jax.unet_state_dict(jparams, ucfg))
    # a single-file VAE is built at the SD geometry, as in JAX
    _assert_state_equal(vae.state_dict(), from_jax.vae_state_dict(
        jax.device_get(jpipe.models.vae_params), (128, 256, 512, 512)))
    assert clip.config.num_extra_embeddings == 2
    _assert_state_equal(clip.state_dict(), from_jax.clip_text_state_dict(
        jax.device_get(jpipe.text.params), clip.config))
    # the motion LoRA moved the weights it targets; the TI rows follow the vocabulary
    mm = "down_blocks.0.motion_modules.0.temporal_transformer.transformer_blocks.0"
    key = f"{mm}.attention_blocks.0.to_q.weight"
    assert not torch.equal(unet.state_dict()[key], zoo["unet"].state_dict()[key])
    prompt = "a photo of a fox, easynegative"
    ids = tpipe.text.tokenizer(prompt)
    np.testing.assert_array_equal(ids, jpipe.text.tokenizer(prompt))
    assert {514, 515} <= set(ids[0].tolist())


def test_non_lcm_build_fuses_loras_as_jax(zoo):
    """Without LCM the snapshot at `pretrained_model_path` is read and the
    UNet and text-encoder LoRAs fuse; the pipeline built from it runs an
    Euler CFG window as the JAX pipeline does."""
    root = zoo["root"]
    kw = _cfg(zoo, use_lcm=False, pretrained_model_path=str(zoo["snapshot"]),
              pretrained_lcm_model_path=str(root / "absent"),
              lora_model_paths=(str(root / "style_lora.safetensors"),), lora_weights=(0.6,))
    jpipe = jfacade.ControlAnimatePipeline(JaxRunConfig(**kw))
    cfg = RunConfig(**kw)
    models, text = tfacade.build_from_disk(cfg, ArchConfig.from_yaml(V1), "cpu", torch.float32)
    _assert_state_equal(models.unet.state_dict(), from_jax.unet_state_dict(
        jax.device_get(jpipe.models.unet_params), models.unet.config))
    _assert_state_equal(models.vae.state_dict(), from_jax.vae_state_dict(
        jax.device_get(jpipe.models.vae_params), TINY_VAE["block_out_channels"]))
    _assert_state_equal(text.model.state_dict(), from_jax.clip_text_state_dict(
        jax.device_get(jpipe.text.params), text.model.config))
    key = "text_model.encoder.layers.1.self_attn.q_proj.weight"
    assert not torch.equal(text.model.state_dict()[key], zoo["clip"].state_dict()[key])
    tpipe = tfacade.ControlAnimatePipeline(cfg, device="cpu")
    assert tpipe.window_static().do_cfg
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((root / "frames").glob("*.png"))[:4]])
    out_j = jpipe.animate(frames, None, seed=5)
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1


def test_cli_run_equals_the_injected_pipeline(zoo, tmp_path):
    """`main([...])` on a profile over a PNG directory, the loop writing PNGs
    (no ffmpeg): every frame equals `vid2vid` with the injected pipeline of
    the same weights."""
    profile = _cfg(zoo, inference_config_path=V2, input_video_path=str(zoo["root"] / "frames"),
                   output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[])
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                    for k, v in profile.items()}))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 6 and summary["windows"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]

    cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
    injected = tfacade.ControlAnimatePipeline(
        cfg, models=tengine.EngineModels(unet=zoo["unet"], vae=zoo["vae"]),
        text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]), zoo["clip"]),
        arch=ArchConfig.from_yaml(V2), device="cpu")
    sink = tmedia.ArrayFrameSink()
    want = tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    assert want["frames_written"] == len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)


MISSING = ["pretrained_lcm_model_path", "inference_config_path", "vae_path", "motion_module",
           "motion_lora_paths", "textual_inversion_paths"]


@pytest.mark.parametrize("key", MISSING)
def test_missing_paths_raise(zoo, key):
    """JAX skips a missing VAE file, motion module, motion LoRA or TI file,
    and takes the default architecture for a missing inference yaml."""
    absent = str(zoo["root"] / f"absent-{key}")
    value = (absent,) if key.endswith("paths") else absent
    cfg = RunConfig(**_cfg(zoo, **{key: value}))
    with pytest.raises(FileNotFoundError, match=re.escape(absent)):
        tfacade.ControlAnimatePipeline(cfg, device="cpu")


@pytest.mark.parametrize("key", ["dreambooth_path", "lora_model_paths"])
def test_missing_non_lcm_paths_raise(zoo, key):
    absent = str(zoo["root"] / f"absent-{key}")
    cfg = RunConfig(**_cfg(zoo, use_lcm=False, pretrained_model_path=str(zoo["snapshot"]),
                           **{key: (absent,) if key.endswith("paths") else absent}))
    with pytest.raises(FileNotFoundError, match=re.escape(absent)):
        tfacade.build_from_disk(cfg, ArchConfig.from_yaml(V1), "cpu", torch.float32)


def test_motion_lora_fuses_into_prefixed_blocks(zoo, tmp_path):
    """A motion LoRA on an up block, whose keys the checkpoint prefixes with
    `module.`: the port fuses it; the JAX build strips the prefix only after
    fusing, so it drops these deltas and keeps the checkpoint's weight."""
    mm = "up_blocks.3.motion_modules.0.temporal_transformer.transformer_blocks.0"
    g = torch.Generator().manual_seed(6)
    lora_path = tmp_path / "up_motion_lora.safetensors"
    save_file({f"{mm}.attention_blocks.0.processor.to_q_lora.down.weight":
               torch.randn(2, 8, generator=g),
               f"{mm}.attention_blocks.0.processor.to_q_lora.up.weight":
               torch.randn(8, 2, generator=g)}, str(lora_path))
    kw = _cfg(zoo, inference_config_path=V2, motion_lora_paths=(str(lora_path),))
    key = f"{mm}.attention_blocks.0.to_q.weight"
    seeded = zoo["unet"].state_dict()[key]
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    assert not torch.equal(tpipe.models.unet.state_dict()[key], seeded)
    jpipe = jfacade.ControlAnimatePipeline(JaxRunConfig(**kw))
    theirs = from_jax.unet_state_dict(jax.device_get(jpipe.models.unet_params),
                                      tpipe.models.unet.config)
    assert torch.equal(theirs[key], seeded)


@pytest.mark.parametrize("key", ["motion_lora_paths", "lora_model_paths"])
def test_lora_matching_nothing_raises(zoo, tmp_path, key):
    """A LoRA file none of whose layers matches a weight of the model (JAX
    fuses nothing and goes on)."""
    stray = tmp_path / "stray_lora.safetensors"
    save_file({"lora_unet_no_such_layer.lora_up.weight": torch.ones(8, 2),
               "lora_unet_no_such_layer.lora_down.weight": torch.ones(2, 8)}, str(stray))
    cfg = RunConfig(**_cfg(zoo, use_lcm=key == "motion_lora_paths",
                           pretrained_model_path=str(zoo["snapshot"]), **{key: (str(stray),)}))
    with pytest.raises(ValueError, match=re.escape(str(stray))):
        tfacade.build_from_disk(cfg, ArchConfig.from_yaml(V1), "cpu", torch.float32)


def test_motion_modules_need_a_checkpoint(zoo):
    """JAX initialises the motion modules at random when no file is named."""
    with pytest.raises(ValueError, match="motion_module"):
        tfacade.ControlAnimatePipeline(RunConfig(**_cfg(zoo, motion_module=None)), device="cpu")
    # an architecture without motion modules needs none
    arch = ArchConfig(use_motion_module=False)
    pipe = tfacade.ControlAnimatePipeline(RunConfig(**_cfg(zoo, motion_module=None)),
                                          arch=arch, device="cpu")
    assert not any("motion_modules" in k for k in pipe.models.unet.state_dict())


# a ControlNet of the zoo UNet's down path (diffusers config.json fields),
# with a narrow condition embedding of four levels as SD1.5's
CN_JSON = {"block_out_channels": [8, 8, 16, 16], "layers_per_block": 1, "attention_head_dim": 2,
           "cross_attention_dim": D_CTX, "norm_num_groups": 4,
           "conditioning_embedding_out_channels": [4, 8, 8, 16],
           "down_block_types": ["CrossAttnDownBlock2D", "CrossAttnDownBlock2D",
                                "CrossAttnDownBlock2D", "DownBlock2D"]}
