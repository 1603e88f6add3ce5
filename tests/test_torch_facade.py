"""The port's ControlAnimatePipeline.animate against the JAX facade's, with
injected tiny models (same weights), a tiny tokenizer and the JAX draws:
uint8 frames agree to 1 LSB, and a second window with overlaps=K reuses the
cached tail latents on both sides. The same for two windows of the default
profile's sampler (Euler, classifier-free guidance over the stacked
negative and positive prompts, the overlap window at strength 0.92)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from controlanimate_tpu.config import ArchConfig as JaxArchConfig
from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch.config import ArchConfig, RunConfig, torch_dtype
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from test_torch_common import JaxDraws, clip_pair, unet_pair, vae_pair

CFG = dict(
    width=32, height=32, frame_count=4, overlap_length=2, use_lcm=True, steps=2,
    strength=0.9, lcm_origin_steps=8, guidance_scale=7.5, dtype="float32",
    prompt="a (red fox)++ in the snow", n_prompt="blurry",
)
SEED = 5


@pytest.fixture(scope="module")
def pipelines():
    junet, uparams, tunet = unet_pair(seed=31)
    jvae, vparams, tvae = vae_pair(seed=32)
    jclip, cparams, tclip = clip_pair(seed=33)
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**CFG),
        models=jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams),
    )
    tpipe = tfacade.ControlAnimatePipeline(
        RunConfig(**CFG),
        models=tengine.EngineModels(unet=tunet, vae=tvae),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip),
        device="cpu",
    )
    return jpipe, tpipe


def _frames(seed, n):
    return np.random.RandomState(seed).randint(0, 255, (n, 32, 32, 3), dtype=np.uint8)


def _lsb(a, b):
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def test_animate_two_windows_match_jax(pipelines):
    jpipe, tpipe = pipelines
    w1 = _frames(1, 4)
    out_j = jpipe.animate(w1, None, overlaps=0, seed=SEED, epoch=0)
    out_t = tpipe.animate(w1, None, overlaps=0, seed=SEED, epoch=0,
                          noise=JaxDraws(jax.random.PRNGKey(SEED)))
    assert out_t.dtype == torch.uint8 and tuple(out_t.shape) == (4, 32, 32, 3)
    assert _lsb(out_t.numpy(), out_j) <= 1

    # the next window starts with the last 2 input frames of this one
    jcache, tcache = jpipe._overlap_latent_cache, tpipe._overlap_latent_cache
    assert jcache[0] == tcache[0] == 1
    np.testing.assert_allclose(tcache[1].numpy(), np.asarray(jcache[1]), atol=1e-4, rtol=1e-4)
    w2 = np.concatenate([w1[-2:], _frames(2, 2)])
    out2_j = jpipe.animate(w2, out_j[-2:], overlaps=2, seed=SEED, epoch=1)
    out2_t = tpipe.animate(w2, out_t[-2:], overlaps=2, seed=SEED, epoch=1,
                           noise=JaxDraws(jax.random.PRNGKey(SEED)))
    assert _lsb(out2_t.numpy(), out2_j) <= 1


def test_prompt_encoding_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    pos_j, neg_j = jpipe._encode_prompts(CFG["prompt"], CFG["n_prompt"])
    pos_t, neg_t = tpipe._encode_prompts(CFG["prompt"], CFG["n_prompt"])
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(neg_t.numpy(), np.asarray(neg_j), atol=1e-4, rtol=1e-4)


def test_default_noise_is_seeded(pipelines):
    _, tpipe = pipelines
    w = _frames(3, 4)
    a = tpipe.animate(w, None, seed=11)
    b = tpipe.animate(w, None, seed=11)
    c = tpipe.animate(w, None, seed=12)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unported_facade_paths_raise(tmp_path, monkeypatch):
    """A GLPN depth folder is read when the pipeline is built: one without
    weights raises FileNotFoundError there (the depth nets and IP-Adapter
    are ported: tests/test_torch_depth.py, tests/test_torch_glpn.py,
    tests/test_torch_ip_adapter.py). A run
    without `use_lcm` is ported; a `scheduler` that names no sampler raises
    KeyError when the pipeline is built, before the disk build reads a file
    (JAX raises it at the first window)."""
    with pytest.raises(KeyError, match="EulerDiscreteScheduler"):
        tfacade.ControlAnimatePipeline(RunConfig(**{**CFG, "use_lcm": False,
                                                    "scheduler": "KarrasVeScheduler"}))
    _, _, tunet = unet_pair()
    _, _, tvae = vae_pair()
    _, _, tclip = clip_pair()
    models = tengine.EngineModels(unet=tunet, vae=tvae)
    text = tfacade.TextStack(CLIPTokenizer.tiny(), tclip)
    (tmp_path / "config.json").write_text('{"model_type": "glpn"}')
    monkeypatch.setenv("CONTROLANIMATE_DEPTH_MODEL", str(tmp_path))
    # a stand-in for the depth ControlNet: the build raises before using it
    depth_models = dataclasses.replace(models, controlnets=[torch.nn.Identity()])
    for bad, what in (({"controlnets": ("lllyasviel/control_v11f1p_sd15_depth",)},
                       "no weight files"),):
        with pytest.raises(FileNotFoundError, match=what):
            tfacade.ControlAnimatePipeline(RunConfig(**{**CFG, **bad}), models=depth_models,
                                           text_stack=text, device="cpu")
    pipe = tfacade.ControlAnimatePipeline(RunConfig(**{**CFG, "use_lcm": False}), models=models,
                                          text_stack=text, device="cpu")
    assert pipe.window_static().do_cfg


def test_cfg_windows_match_jax():
    """`use_lcm` off, EulerDiscreteScheduler at guidance 7.5: a whole window
    at strength 1 (pure noise), then an overlap window at 0.92 that starts
    from the first window's last outputs; within 1 LSB of the JAX facade."""
    cfg = {**CFG, "use_lcm": False, "scheduler": "EulerDiscreteScheduler", "steps": 3,
           "strength": 1.0}
    junet, uparams, tunet = unet_pair(seed=34)
    jvae, vparams, tvae = vae_pair(seed=35)
    jclip, cparams, tclip = clip_pair(seed=36)
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**cfg),
        models=jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams))
    tpipe = tfacade.ControlAnimatePipeline(
        RunConfig(**cfg), models=tengine.EngineModels(unet=tunet, vae=tvae),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")
    w1 = _frames(5, 4)
    out_j = jpipe.animate(w1, None, overlaps=0, seed=SEED, epoch=0)
    out_t = tpipe.animate(w1, None, overlaps=0, seed=SEED, epoch=0,
                          noise=JaxDraws(jax.random.PRNGKey(SEED)))
    assert _lsb(out_t.numpy(), out_j) <= 1
    assert tpipe._overlap_latent_cache is None  # the latent reuse is native LCM's
    w2 = np.concatenate([w1[-2:], _frames(6, 2)])
    out2_j = jpipe.animate(w2, out_j[-2:], overlaps=2, strength=0.92, seed=SEED, epoch=1)
    out2_t = tpipe.animate(w2, out_t[-2:], overlaps=2, strength=0.92, seed=SEED, epoch=1,
                           noise=JaxDraws(jax.random.PRNGKey(SEED)))
    assert _lsb(out2_t.numpy(), out2_j) <= 1
    assert _lsb(out2_t.numpy(), out_t.numpy()) > 1


@pytest.mark.parametrize("name", ["SampleConfigLCM", "SampleConfig", "SampleConfigTxt2Vid",
                                  "SampleConfigIPAdapter"])
def test_config_loaders_match_jax(name):
    """The port's copy of the config reads the shipped YAML profiles as the
    JAX package does, for every field it keeps; the rest lands in extras."""
    path = f"configs/prompts/{name}.yaml"
    mine, theirs = RunConfig.from_yaml(path), JaxRunConfig.from_yaml(path)
    for f in dataclasses.fields(RunConfig):
        if f.name != "extras":
            assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    arch = "configs/inference/inference-v2.yaml"
    assert dataclasses.asdict(ArchConfig.from_yaml(arch)) == dataclasses.asdict(
        JaxArchConfig.from_yaml(arch))


def test_run_dtype_names():
    assert torch_dtype("fp16") is torch.bfloat16 and torch_dtype("float16") is torch.bfloat16
    assert torch_dtype("FP32") is torch.float32 and torch_dtype("bf16") is torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("int8")


def test_use_pallas_attention_has_no_effect(monkeypatch):
    """The port runs K1 for every unmasked self-attention whatever
    `use_pallas_attention` says: the build warns so, and one window with each
    value makes the same attention calls and the same frames."""
    from controlanimate_tpu_torch.ops import attention as attention_module

    _, _, tunet = unet_pair(seed=31)
    _, _, tvae = vae_pair(seed=32)
    _, _, tclip = clip_pair(seed=33)
    kernel = attention_module.flash_attention
    runs = []
    for value in (False, True):
        calls = []

        def spy(q, k, v, calls=calls):
            calls.append(tuple(q.shape))
            return kernel(q, k, v)

        monkeypatch.setattr(attention_module, "flash_attention", spy)
        with pytest.warns(UserWarning, match=f"use_pallas_attention={value}"):
            tpipe = tfacade.ControlAnimatePipeline(
                RunConfig(**CFG, use_pallas_attention=value),
                models=tengine.EngineModels(unet=tunet, vae=tvae),
                text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")
        runs.append((tpipe.animate(_frames(4, 4), None, seed=SEED), calls))
    (frames_off, calls_off), (frames_on, calls_on) = runs
    assert calls_off and calls_off == calls_on
    assert torch.equal(frames_off, frames_on)
