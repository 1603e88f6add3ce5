"""The port's samplers against the JAX package's, for every registry name:
the tables (timesteps, sigmas, init_noise_sigma, num_steps), add_noise and
scale_model_input at every step, and a multi-step run of `step` on a fixed
oracle epsilon with the JAX draws (the JAX loop threads its state and
fold_in(k_loop, i) keys; the port takes the same draws from `JaxDraws`).
Gates: 1e-5 relative for the runs, 1e-6 relative for LMS's Lagrange
coefficients (JAX integrates them with scipy's quad, the port exactly)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.schedulers import available_schedulers as jax_available
from controlanimate_tpu.schedulers import common as jcommon
from controlanimate_tpu.schedulers import make_schedule as jax_make_schedule
from controlanimate_tpu.schedulers import make_scheduler as jax_make_scheduler
from controlanimate_tpu_torch.schedulers import available_schedulers, common, make_schedule
from controlanimate_tpu_torch.schedulers import make_scheduler
from controlanimate_tpu_torch.schedulers.lms import lms_coefficients
from test_torch_common import JaxDraws

NAMES = ["DDIMScheduler", "DPMSolverMultistepScheduler", "EulerAncestralDiscreteScheduler",
         "EulerDiscreteScheduler", "LCMScheduler", "LMSDiscreteScheduler", "PNDMScheduler"]
# (steps, strength): the default profile's 30 at overlap_strength 0.92, the
# LCM-LoRA profile's 7, a short img2img run, a single step
RUNS = [(30, 0.92), (7, 1.0), (4, 0.6), (1, 1.0)]
SHAPE = (2, 3, 4, 4, 4)  # (B, F, h, w, c): two batch elements share the draws


def _kw(name):
    # the engine builds the LCM sampler this way when `use_lcm` is off
    return {"lcm_origin_steps": 50, "strength_mode": "tail"} if name == "LCMScheduler" else {}


def _pair(name, steps, strength):
    return (jax_make_scheduler(name, jax_make_schedule(), steps, strength=strength, **_kw(name)),
            make_scheduler(name, make_schedule(), steps, strength=strength, **_kw(name)))


def test_registry_matches_jax():
    assert available_schedulers() == jax_available() == NAMES
    with pytest.raises(KeyError, match="EulerDiscreteScheduler"):
        make_scheduler("KarrasVeScheduler", make_schedule(), 4)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps,strength", RUNS)
def test_tables_match_jax(name, steps, strength):
    js, ts = _pair(name, steps, strength)
    np.testing.assert_array_equal(ts.timesteps, js.timesteps)
    assert ts.num_steps == js.num_steps == len(js.timesteps)
    assert ts.init_noise_sigma == js.init_noise_sigma
    if hasattr(js, "sigmas"):
        np.testing.assert_array_equal(ts.sigmas, np.asarray(js.sigmas))
    x0, noise = np.random.RandomState(steps).randn(2, *SHAPE).astype(np.float32)
    for i in range(ts.num_steps):
        np.testing.assert_allclose(
            ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), i).numpy(),
            np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise), i)), rtol=1e-6,
            atol=1e-6)
        np.testing.assert_allclose(ts.scale_model_input(i, torch.from_numpy(x0)).numpy(),
                                   np.asarray(js.scale_model_input(i, jnp.asarray(x0))),
                                   rtol=1e-6, atol=1e-7)


def _oracle(x, c):
    """A fixed model: epsilon as a function of the sample."""
    return 0.3 * x + c


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("steps,strength", RUNS)
def test_multistep_run_matches_jax(name, steps, strength):
    js, ts = _pair(name, steps, strength)
    rng = np.random.RandomState(100 + steps)
    x0, noise, c = rng.randn(3, *SHAPE).astype(np.float32)
    key = jax.random.PRNGKey(steps)
    draws = JaxDraws(key)

    xj = js.add_noise(jnp.asarray(x0), jnp.asarray(noise), 0)
    state = js.init_state(SHAPE)
    for i in range(js.num_steps):
        xj, state = js.step(i, _oracle(xj, jnp.asarray(c)), xj, state,
                            jax.random.fold_in(draws.k_loop, i))

    xt = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), 0)
    state = ts.init_state(SHAPE)
    for i in range(ts.num_steps):
        step_noise = draws.step(i, (1, *SHAPE[1:])).expand(SHAPE) if ts.needs_noise(i) else None
        xt, state = ts.step(i, _oracle(xt, torch.from_numpy(c)), xt, state, step_noise)

    ref = np.asarray(xj)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(xt.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("steps,strength", RUNS)
def test_lms_coefficients_match_jax(steps, strength):
    js, ts = _pair("LMSDiscreteScheduler", steps, strength)
    assert ts.order == js.order
    exact = lms_coefficients(ts._sigmas_np, ts.num_steps, ts.order)
    np.testing.assert_allclose(exact.astype(np.float32), np.asarray(js._coeffs), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(ts.coeffs, exact.astype(np.float32))


def test_schedule_math_matches_jax():
    for kw in ({}, {"beta_schedule": "scaled_linear"}, {"rescale_betas_zero_snr": True},
               {"beta_schedule": "squaredcos_cap_v2", "rescale_betas_zero_snr": True}):
        mine, theirs = make_schedule(**kw), jax_make_schedule(**kw)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    abar = jax_make_schedule().alphas_cumprod
    ts = np.array([999.0, 500.5, 0.0, 12.25])
    np.testing.assert_array_equal(common.interp_sigmas(ts, abar), jcommon.interp_sigmas(ts, abar))
    np.testing.assert_array_equal(common.linspace_timesteps(1000, 7),
                                  jcommon.linspace_timesteps(1000, 7))
    np.testing.assert_array_equal(common.leading_timesteps(1000, 7, 1),
                                  jcommon.leading_timesteps(1000, 7, 1))
    with pytest.raises(ValueError, match="exceeds"):
        common.leading_timesteps(1000, 1001)
