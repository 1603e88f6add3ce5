"""The port's UNet3DConditionModel against the JAX model on the same random
weights: the tiny LCM UNet of tests/test_engine.py (with the w-embedding
input) and the tiny UNet of tests/test_unet3d.py, the latter also with the
temporal sub-layer, with sparse-causal attention and with a motion band of
1 at 3 frames (active), at that file's 1e-4 gate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from test_torch_common import LCM_MOTION, LCM_UNET, TINY_MOTION, TINY_UNET, unet_pair


@pytest.mark.parametrize("kw,motion,frames", [
    (LCM_UNET, LCM_MOTION, 4),
    (TINY_UNET, TINY_MOTION, 3),
    ({**TINY_UNET, "temporal_attention": True}, TINY_MOTION, 3),
    ({**TINY_UNET, "cross_frame_attention": True}, TINY_MOTION, 3),
    (TINY_UNET, {**TINY_MOTION, "attention_band": 1}, 3),
])
def test_unet_matches_jax(kw, motion, frames):
    jmodel, params, tmodel = unet_pair(kw, motion)
    rng = np.random.RandomState(4)
    B = 2
    x = rng.randn(B, frames, 8, 8, 4).astype(np.float32)
    t = np.asarray([10, 900])
    ctx = rng.randn(B, 7, kw["cross_attention_dim"]).astype(np.float32)
    cond = kw.get("time_cond_proj_dim")
    w = rng.randn(B, cond).astype(np.float32) if cond else None
    fn = jax.jit(lambda p, x, t, c, w: jmodel.apply({"params": p}, x, t, c, timestep_cond=w))
    out_j = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                          None if w is None else jnp.asarray(w)))
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                       timestep_cond=None if w is None else torch.from_numpy(w)).numpy()
    assert out_t.shape == x.shape
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, rtol=1e-4)


def test_unported_unet_options_raise():
    """IP-Adapter tokens are ported (tests/test_torch_ip_adapter.py): a
    context with no text before its image tokens raises. ControlNet
    residuals are ported, and a list that does not match the skips raises
    (JAX's zip drops the extra ones)."""
    ip_model = UNet3DConditionModel(UNet3DConfig(**TINY_UNET, ip_tokens=4))
    with pytest.raises(ValueError, match="image tokens"):
        ip_model(torch.zeros(1, 2, 8, 8, 4), torch.tensor([1]), torch.zeros(1, 4, 24))
    tmodel = UNet3DConditionModel(UNet3DConfig(**TINY_UNET))
    x = torch.zeros(1, 2, 8, 8, 4)
    with pytest.raises(ValueError, match="residuals"):
        tmodel(x, torch.tensor([1]), torch.zeros(1, 7, 24),
               down_block_additional_residuals=[torch.zeros(1, 2, 8, 8, 32)])
