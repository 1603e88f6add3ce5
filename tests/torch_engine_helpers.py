"""Helpers shared by the port's window tests against the JAX
`AnimationEngine` (`tests/test_torch_engine.py`, `test_torch_engine_cfg.py`):
both engines on the same tiny weights, and one window configuration for
both."""

import dataclasses

import pytest

from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.schedulers import make_schedule as jax_make_schedule
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.schedulers import make_schedule
from test_torch_common import unet_pair, vae_pair

GATE = 2e-3


@pytest.fixture(scope="module")
def engines():
    junet, uparams, tunet = unet_pair(seed=23)
    jvae, vparams, tvae = vae_pair(seed=21)
    jeng = jengine.AnimationEngine(
        jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams),
        jax_make_schedule(),
    )
    teng = tengine.AnimationEngine(tengine.EngineModels(unet=tunet, vae=tvae), make_schedule())
    return jeng, teng


def _window(**kw):
    """The same window for both engines (the port's WindowStatic keeps only
    the fields its LCM window reads)."""
    base = dict(scheduler_name="LCMScheduler", steps=2, strength=0.9, guidance_scale=7.5,
                use_lcm=True, lcm_origin_steps=8, has_input_frames=True)
    base.update(kw)
    mine = {f.name for f in dataclasses.fields(tengine.WindowStatic)}
    return (jengine.WindowStatic(**base),
            tengine.WindowStatic(**{k: v for k, v in base.items() if k in mine}))
