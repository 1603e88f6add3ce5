"""The port's multi-step windows under classifier-free guidance against
`AnimationEngine.generate_window` of the JAX package: same weights, the JAX
engine's own noise draws injected. Euler txt2vid, Euler overlap windows with
and without `use_img2img`, the LCM-LoRA tail, the stateful samplers, two
ControlNets with guess mode on and off. Gates: <= 2e-3 on decoded frames
(the gate of tests/test_engine.py), and on the denoised latents 1e-4 of
their largest magnitude: sigma-space latents start at init_noise_sigma
(about 14.6) and guidance 7.5 scales the fp32 rounding of cond - uncond."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.schedulers import make_schedule as jax_make_schedule
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.schedulers import make_schedule
from controlanimate_tpu_torch.ops.canny import canny
from test_torch_common import JaxDraws
from test_torch_controlnet import LCM_CN, controlnet_pair
from torch_engine_helpers import GATE, _window, engines  # noqa: F401 (a fixture)


# -- multi-step samplers under classifier-free guidance -----------------------
def _cfg_inputs(seed, F=4, K=2):
    """Input frames, the last K outputs and [negative, positive] text."""
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 255, (1, F, 32, 32, 3), dtype=np.uint8)
    last = rng.randint(0, 255, (1, K, 32, 32, 3), dtype=np.uint8)
    ctx = rng.randn(2, 7, 16).astype(np.float32) * 0.5
    return frames, last, ctx


def _multistep(**kw):
    base = dict(use_lcm=False, scheduler_name="EulerDiscreteScheduler", steps=3, strength=1.0,
                guidance_scale=7.5)
    base.update(kw)
    return _window(**base)


def _both_latents(jeng, teng, jst, tst, ctx, key, frames=None, last=None, cond=()):
    """The denoised latents of both engines, from the same inputs (JAX
    through its prepare and denoise programs)."""
    B = 1
    F_, H, W = (frames.shape[1:4] if frames is not None
                else (jst.frame_count, jst.height, jst.width))
    shape = (B, F_, H // 8, W // 8, 4)
    k_prep, k_loop = jax.random.split(key)
    sched = jeng.build_scheduler(jst)
    lat_j = jeng._make_prepare_fn(jst, sched)(
        jeng.m.vae_params, None if frames is None else jnp.asarray(frames),
        None if last is None else jnp.asarray(last), shape, k_prep)
    lat_j = jeng._make_denoise_fn(jst, sched)(
        jeng.m.unet_params, tuple(jeng.m.controlnet_params), jnp.asarray(ctx),
        tuple(jnp.asarray(c) for c in cond), lat_j, k_loop)
    draws = JaxDraws(key)
    tsched = teng.build_scheduler(tst)
    with torch.no_grad():
        lat_t = teng.prepare_latents(tst, tsched, draws, shape,
                                     None if frames is None else torch.from_numpy(frames),
                                     None if last is None else torch.from_numpy(last))
        lat_t = teng.denoise(tst, tsched, torch.from_numpy(ctx), lat_t, draws,
                             [torch.from_numpy(c) for c in cond])
    return np.asarray(lat_j), lat_t.numpy()


def _assert_window_matches(jeng, teng, jst, tst, ctx, key, frames=None, last=None, cond=()):
    lat_j, lat_t = _both_latents(jeng, teng, jst, tst, ctx, key, frames, last, cond)
    assert np.isfinite(lat_j).all()
    assert np.abs(lat_t - lat_j).max() <= 1e-4 * np.abs(lat_j).max()
    inputs = dict(input_frames=frames, last_output_frames=last)
    out_j = np.asarray(jeng.generate_window(
        jst, jnp.asarray(ctx), key, cond_images=[jnp.asarray(c) for c in cond],
        **{k: None if v is None else jnp.asarray(v) for k, v in inputs.items()}))
    out_t = teng.generate_window(
        tst, torch.from_numpy(ctx), JaxDraws(key), cond_images=[torch.from_numpy(c) for c in cond],
        **{k: None if v is None else torch.from_numpy(v) for k, v in inputs.items()})
    assert out_t.shape == out_j.shape
    assert np.abs(out_t.numpy() - out_j).max() <= GATE
    return out_t


def test_euler_cfg_txt2vid_matches_jax(engines):
    """No input frames, strength 1: pure noise times init_noise_sigma
    (about 14.6), three Euler steps at guidance 7.5."""
    jeng, teng = engines
    _, _, ctx = _cfg_inputs(20)
    jst, tst = _multistep(has_input_frames=False, frame_count=4, height=32, width=32)
    assert tst.do_cfg and jst.do_cfg
    out = _assert_window_matches(jeng, teng, jst, tst, ctx, jax.random.PRNGKey(21))
    # guidance moved the frames: the positive prompt alone gives others
    _, plain = _multistep(has_input_frames=False, frame_count=4, height=32, width=32,
                          guidance_scale=1.0)
    other = teng.generate_window(plain, torch.from_numpy(ctx[1:]), JaxDraws(jax.random.PRNGKey(21)))
    assert np.abs(out.numpy() - other.numpy()).max() > 1e-2


@pytest.mark.parametrize("use_img2img", [False, True])
def test_euler_overlap_window_matches_jax(engines, use_img2img):
    """An overlap window at strength 0.92 (3 of 4 Euler steps) with the
    last outputs: the overlap slots from their latents, the rest from the
    anchor or, under use_img2img, from the input frames' latents."""
    jeng, teng = engines
    frames, last, ctx = _cfg_inputs(22)
    jst, tst = _multistep(steps=4, strength=0.92, overlaps=2, use_img2img=use_img2img,
                          has_last_output_frames=True)
    _assert_window_matches(jeng, teng, jst, tst, ctx, jax.random.PRNGKey(23), frames, last)


def test_lcm_lora_tail_window_matches_jax(engines):
    """`LCMScheduler` without `use_lcm` (the LCM-LoRA profile): the full LCM
    table with tail truncation (3 of 4 steps at 0.92), CFG at 1.1, no
    w-embedding."""
    jeng, teng = engines
    frames, last, ctx = _cfg_inputs(24)
    jst, tst = _multistep(scheduler_name="LCMScheduler", steps=4, strength=0.92,
                          guidance_scale=1.1, overlaps=2, has_last_output_frames=True)
    _assert_window_matches(jeng, teng, jst, tst, ctx, jax.random.PRNGKey(25), frames, last)


@pytest.mark.parametrize("name", ["DPMSolverMultistepScheduler", "PNDMScheduler"])
def test_multistep_sampler_window_matches_jax(engines, name):
    """Two stateful samplers in a window under CFG: DPM-Solver (its previous
    x0) in an overlap window at strength 0.9, PNDM (its epsilons and first
    sample; 4 model calls for 3 steps) at strength 1. Every sampler's state
    and draws are held against JAX in tests/test_torch_schedulers.py."""
    jeng, teng = engines
    frames, last, ctx = _cfg_inputs(26)
    jst, tst = _multistep(scheduler_name=name, steps=3, strength=0.9 if name != "PNDMScheduler"
                          else 1.0, overlaps=2, has_last_output_frames=True)
    _assert_window_matches(jeng, teng, jst, tst, ctx, jax.random.PRNGKey(27), frames, last)


@pytest.mark.parametrize("guess_mode", [False, True])
def test_cfg_window_with_two_controlnets_matches_jax(engines, guess_mode):
    """Two ControlNets under CFG: without guess mode each takes the doubled
    latents, both texts and its maps twice; in guess mode the single latents
    and the positive text, its summed residuals serving both halves."""
    jeng, teng = engines
    jcn, p1, tcn1 = controlnet_pair(LCM_CN, seed=28)
    _, p2, tcn2 = controlnet_pair(LCM_CN, seed=29)
    scales = [1.0, 0.6]
    jeng_cn = jengine.AnimationEngine(
        dataclasses.replace(jeng.m, controlnets=[jcn, jcn], controlnet_params=[p1, p2],
                            cond_scales=scales), jax_make_schedule())
    teng_cn = tengine.AnimationEngine(
        dataclasses.replace(teng.m, controlnets=[tcn1, tcn2], cond_scales=scales),
        make_schedule())
    frames, last, ctx = _cfg_inputs(30)
    cond = [(canny(torch.from_numpy(frames[0])).numpy() * 255).astype(np.uint8)[None],
            np.random.RandomState(31).randint(0, 256, frames.shape, dtype=np.uint8)]
    jst, tst = _multistep(steps=2, guess_mode=guess_mode)
    key = jax.random.PRNGKey(32)
    out = _assert_window_matches(jeng_cn, teng_cn, jst, tst, ctx, key, frames, cond=cond)
    plain = teng.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                 input_frames=torch.from_numpy(frames))
    assert np.abs(out.numpy() - plain.numpy()).max() > 1e-2  # the nets moved the frames
