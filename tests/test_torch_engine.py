"""The port's native-LCM windows against `AnimationEngine.generate_window`
of the JAX package: same weights, the JAX engine's own noise draws
injected. The window with and without overlap-latent reuse and with two
ControlNets; gate <= 2e-3 on decoded frames (the gate of
tests/test_engine.py). Also the LCM tables and the w-embedding. The
multi-step windows under classifier-free guidance are in
`test_torch_engine_cfg.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.schedulers import make_schedule as jax_make_schedule
from controlanimate_tpu.schedulers import make_scheduler as jax_make_scheduler
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.schedulers import make_schedule, make_scheduler
from controlanimate_tpu_torch.ops.canny import canny
from test_torch_common import JaxDraws
from test_torch_controlnet import LCM_CN, controlnet_pair
from torch_engine_helpers import GATE, _window, engines  # noqa: F401 (a fixture)


def _inputs(seed, F=4, H=32, W=32):
    rng = np.random.RandomState(seed)
    frames = rng.randint(0, 255, (1, F, H, W, 3), dtype=np.uint8)
    ctx = rng.randn(1, 7, 16).astype(np.float32) * 0.5
    return frames, ctx


def test_lcm_window_matches_jax(engines):
    jeng, teng = engines
    frames, ctx = _inputs(1)
    jst, tst = _window()
    key = jax.random.PRNGKey(7)
    out_j = np.asarray(jeng.generate_window(jst, jnp.asarray(ctx), key,
                                            input_frames=jnp.asarray(frames)))
    out_t = teng.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                 input_frames=torch.from_numpy(frames))
    assert out_t.shape == out_j.shape == (1, 4, 32, 32, 3)
    assert np.abs(out_t.numpy() - out_j).max() <= GATE


def test_uint8_decode_matches_jax(engines):
    jeng, teng = engines
    lat = np.random.RandomState(6).randn(1, 4, 4, 4, 4).astype(np.float32) * 0.2
    out_j = np.asarray(jeng._decode_latents(jeng.m.vae_params, jnp.asarray(lat), to_uint8=True))
    out_t = teng.decode_latents(torch.from_numpy(lat), to_uint8=True)
    assert out_t.dtype == torch.uint8 and out_t.shape == out_j.shape == (1, 4, 32, 32, 3)
    assert np.abs(out_t.numpy().astype(int) - out_j.astype(int)).max() <= 1


def test_lcm_overlap_latent_reuse_matches_jax(engines):
    """First window caches its clean tail latents; the second encodes only
    its new frames and takes the head latents from the cache."""
    jeng, teng = engines
    frames, ctx = _inputs(2)
    K = 2
    jst, tst = _window(tail_latents=K, output_uint8=True)
    key = jax.random.PRNGKey(9)
    out_j, tail_j = jeng.generate_window(jst, jnp.asarray(ctx), key,
                                         input_frames=jnp.asarray(frames))
    out_t, tail_t = teng.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                         input_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tail_t.numpy(), np.asarray(tail_j), atol=1e-4, rtol=1e-4)
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1

    frames2 = np.concatenate([frames[:, -K:], _inputs(3, F=2)[0]], axis=1)
    jst2, tst2 = _window(tail_latents=K, overlaps=K)
    key2 = jax.random.PRNGKey(10)
    out2_j, _ = jeng.generate_window(jst2, jnp.asarray(ctx), key2,
                                     input_frames=jnp.asarray(frames2), head_latents=tail_j)
    out2_t, _ = teng.generate_window(tst2, torch.from_numpy(ctx), JaxDraws(key2),
                                     input_frames=torch.from_numpy(frames2), head_latents=tail_t)
    assert np.abs(out2_t.numpy() - np.asarray(out2_j)).max() <= GATE


def test_lcm_txt2vid_overlap_window_matches_jax(engines):
    """No input frames: the last outputs' latents fill the overlap slots."""
    jeng, teng = engines
    last, ctx = _inputs(4, F=2)
    jst, tst = _window(has_input_frames=False, has_last_output_frames=True, overlaps=2,
                       frame_count=4, height=32, width=32)
    key = jax.random.PRNGKey(11)
    out_j = np.asarray(jeng.generate_window(jst, jnp.asarray(ctx), key,
                                            last_output_frames=jnp.asarray(last)))
    out_t = teng.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                 last_output_frames=torch.from_numpy(last))
    assert out_t.shape == (1, 4, 32, 32, 3)
    assert np.abs(out_t.numpy() - out_j).max() <= GATE


@pytest.mark.parametrize("guess_mode", [False, True])
def test_lcm_window_with_two_controlnets_matches_jax(engines, guess_mode):
    """Two ControlNets (scales 1.0 and 0.6) on uint8 condition maps, canny
    edges of the frames and random maps: the residuals summed over the nets
    enter the UNet at every step, as in the JAX engine's LCM path."""
    jeng, teng = engines
    jcn, p1, tcn1 = controlnet_pair(LCM_CN, seed=24)
    _, p2, tcn2 = controlnet_pair(LCM_CN, seed=25)
    scales = [1.0, 0.6]
    jeng_cn = jengine.AnimationEngine(
        dataclasses.replace(jeng.m, controlnets=[jcn, jcn], controlnet_params=[p1, p2],
                            cond_scales=scales), jax_make_schedule())
    teng_cn = tengine.AnimationEngine(
        dataclasses.replace(teng.m, controlnets=[tcn1, tcn2], cond_scales=scales),
        make_schedule())
    frames, ctx = _inputs(12)
    cond = [(canny(torch.from_numpy(frames[0])).numpy() * 255).astype(np.uint8)[None],
            np.random.RandomState(13).randint(0, 256, frames.shape, dtype=np.uint8)]
    jst, tst = _window(guess_mode=guess_mode)
    key = jax.random.PRNGKey(14)
    out_j = np.asarray(jeng_cn.generate_window(
        jst, jnp.asarray(ctx), key, cond_images=[jnp.asarray(c) for c in cond],
        input_frames=jnp.asarray(frames)))
    out_t = teng_cn.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                    input_frames=torch.from_numpy(frames),
                                    cond_images=[torch.from_numpy(c) for c in cond])
    assert out_t.shape == out_j.shape == (1, 4, 32, 32, 3)
    assert np.abs(out_t.numpy() - out_j).max() <= GATE
    plain = teng.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                 input_frames=torch.from_numpy(frames))
    assert np.abs(out_t.numpy() - plain.numpy()).max() > 1e-2  # the nets moved the frames
    with pytest.raises(ValueError, match="condition maps"):
        teng_cn.generate_window(tst, torch.from_numpy(ctx), JaxDraws(key),
                                input_frames=torch.from_numpy(frames), cond_images=cond[:1])


def test_unported_window_settings_raise(engines):
    """A window whose IP-Adapter token count differs from the UNet's raises
    ValueError (JAX splits the wrong tokens off without a word). A window
    without `use_lcm` runs (M10); with a name the registry lacks it raises
    KeyError listing the names, and with overlap-latent reuse (native LCM
    only) ValueError."""
    _, teng = engines
    frames, ctx = _inputs(15)
    draws = JaxDraws(jax.random.PRNGKey(0))
    _, tst = _window(ip_tokens=4)
    with pytest.raises(ValueError, match="IP-Adapter tokens"):
        teng.generate_window(tst, torch.from_numpy(ctx), draws,
                             input_frames=torch.from_numpy(frames))
    ctx2 = torch.from_numpy(np.concatenate([ctx, ctx * 0.5]))
    _, tst = _window(use_lcm=False, scheduler_name="EulerDiscreteScheduler", strength=1.0,
                     steps=1)
    assert tst.do_cfg
    out = teng.generate_window(tst, ctx2, draws, input_frames=torch.from_numpy(frames))
    assert out.shape == (1, 4, 32, 32, 3)
    _, tst = _window(use_lcm=False, scheduler_name="KarrasVeScheduler")
    with pytest.raises(KeyError, match="PNDMScheduler"):
        teng.generate_window(tst, ctx2, draws, input_frames=torch.from_numpy(frames))
    _, tst = _window(use_lcm=False, scheduler_name="EulerDiscreteScheduler", tail_latents=2)
    with pytest.raises(ValueError, match="native-LCM"):
        teng.generate_window(tst, ctx2, draws, input_frames=torch.from_numpy(frames))


@pytest.mark.parametrize("steps,strength,origin", [(4, 0.9, 50), (2, 0.9, 8), (4, 1.0, 50),
                                                   (8, 0.5, 50), (3, 0.7, 20)])
def test_lcm_tables_match_jax(steps, strength, origin):
    js = jax_make_scheduler("LCMScheduler", jax_make_schedule(), steps, strength=strength,
                            lcm_origin_steps=origin)
    ts = make_scheduler("LCMScheduler", make_schedule(), steps, strength=strength,
                        lcm_origin_steps=origin)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.num_steps == js.num_steps
    for mine, theirs in ((ts.abar_t, js._abar_t), (ts.abar_next, js._abar_next),
                         (ts.c_skip, js._c_skip), (ts.c_out, js._c_out)):
        np.testing.assert_array_equal(mine, np.asarray(theirs))


def test_lcm_step_matches_jax():
    js = jax_make_scheduler("LCMScheduler", jax_make_schedule(), 3, strength=0.9)
    ts = make_scheduler("LCMScheduler", make_schedule(), 3, strength=0.9)
    rng = np.random.RandomState(0)
    out, sample = rng.randn(2, 1, 3, 4, 4).astype(np.float32)
    key = jax.random.PRNGKey(1)
    noise = np.array(jax.random.normal(key, (1, 3, 4, 4), jnp.float32))
    for i in range(3):
        prev_j, _ = js.step(i, jnp.asarray(out), jnp.asarray(sample), (), key)
        prev_t, state = ts.step(i, torch.from_numpy(out), torch.from_numpy(sample), (),
                                torch.from_numpy(noise) if ts.needs_noise(i) else None)
        assert state == ()
        np.testing.assert_allclose(prev_t.numpy(), np.asarray(prev_j), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim", [8, 256, 9])
def test_w_embedding_matches_jax(dim):
    """sin/cos arguments reach w*1000 = 8000, where one fp32 ulp is 4.9e-4:
    exp's last bit differs between the frameworks, hence atol 1e-3."""
    w = np.asarray([1.0, 7.5, 8.0], np.float32)
    np.testing.assert_allclose(
        tengine.get_w_embedding(torch.from_numpy(w), dim).numpy(),
        np.asarray(jengine.get_w_embedding(jnp.asarray(w), dim)), atol=1e-3, rtol=0,
    )


def test_torch_noise_is_seeded_per_stream():
    a, b = tengine.TorchNoise(3, "cpu"), tengine.TorchNoise(3, "cpu")
    torch.testing.assert_close(a.initial((1, 2, 3)), b.initial((1, 2, 3)))
    torch.testing.assert_close(a.step(1, (4,)), a.step(1, (4,)))
    assert not torch.equal(a.step(0, (4,)), a.step(1, (4,)))
    assert not torch.equal(a.encode((4,)), tengine.TorchNoise(4, "cpu").encode((4,)))
