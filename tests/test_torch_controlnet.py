"""The port's ControlNet (`models/controlnet.py`) and the UNet's residual
injection against the JAX package's on the same random weights, fp32 on the
CPU, at the 1e-4 gate of tests/test_unet3d.py; the residual sum and scales;
and the diffusers key table at SD1.5 width on the meta device."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.controlnet import sum_controlnet_residuals as jax_sum
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.weights.controlnet_weights import controlnet_mapping as jax_mapping
from controlanimate_tpu_torch.models.controlnet import (
    SD15_CONTROLNET, ControlNetModel, controlnet_config_from_json, sum_controlnet_residuals)
from controlanimate_tpu_torch.models.unet3d import UNet3DConfig
from controlanimate_tpu_torch.weights import from_jax
from controlanimate_tpu_torch.weights.controlnet_weights import (
    controlnet_keys, controlnet_state_dict_from_torch)
from test_torch_common import LCM_MOTION, LCM_UNET, unet_pair

# the tiny ControlNet of tests/test_controlnet.py, and one whose down path is
# the tiny LCM UNet's (tests/test_engine.py)
TINY_CN = dict(block_out_channels=(32, 64), layers_per_block=1,
               down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
               attention_heads=4, cross_attention_dim=24, norm_num_groups=8)
LCM_CN = dict(block_out_channels=(8, 16), layers_per_block=1,
              down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
              attention_heads=2, cross_attention_dim=16, norm_num_groups=4)


def lecun_params(shapes, seed: int):
    """Seeded weights that keep activations O(1) through the unnormalised
    condition embedding: kernels N(0, 1/fan_in), biases N(0, 0.05^2), norm
    scales 1 + N(0, 0.1^2)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        name = getattr(path[-1], "key", None)
        if len(s.shape) >= 2:
            val = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            val = 1.0 + 0.1 * rng.randn(*s.shape)
        else:
            val = 0.05 * rng.randn(*s.shape)
        leaves.append(val.astype(np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def controlnet_pair(kw=TINY_CN, seed: int = 0):
    """(jax model, jax params, port model) with the same random weights."""
    jcfg = JaxUNetConfig(**kw, use_motion_module=False)
    jmodel = JaxControlNet(jcfg)
    F_ = 2
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, F_, 8, 8, 4)), jnp.asarray([1]),
        jnp.zeros((1, 7, kw["cross_attention_dim"])), jnp.zeros((1, F_, 64, 64, 3)))["params"])
    params = lecun_params(shapes, seed)
    cfg = UNet3DConfig(**kw, use_motion_module=False)
    tmodel = ControlNetModel(cfg).eval()
    tmodel.load_state_dict(from_jax.controlnet_state_dict(params, cfg))
    return jmodel, params, tmodel


def _inputs(seed, kw, B=1, F_=2, h=8, w=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, F_, h, w, 4).astype(np.float32)
    ctx = rng.randn(B, 7, kw["cross_attention_dim"]).astype(np.float32)
    cond = rng.rand(B, F_, 8 * h, 8 * w, 3).astype(np.float32)
    return x, ctx, cond


def _run_both(jmodel, params, tmodel, x, t, ctx, cond, **kw):
    downs_j, mid_j = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t),
                                  jnp.asarray(ctx), jnp.asarray(cond), **kw)
    with torch.no_grad():
        downs_t, mid_t = tmodel(torch.from_numpy(x), torch.from_numpy(t),
                                torch.from_numpy(ctx), torch.from_numpy(cond), **kw)
    return (downs_j, mid_j), (downs_t, mid_t)


@pytest.mark.parametrize("guess_mode", [False, True])
@pytest.mark.parametrize("kw", [TINY_CN, LCM_CN], ids=["tiny", "lcm"])
def test_controlnet_matches_jax(kw, guess_mode):
    jmodel, params, tmodel = controlnet_pair(kw, seed=3)
    x, ctx, cond = _inputs(4, kw, B=2)
    t = np.asarray([10, 900])
    (downs_j, mid_j), (downs_t, mid_t) = _run_both(
        jmodel, params, tmodel, x, t, ctx, cond, conditioning_scale=0.7, guess_mode=guess_mode)
    assert len(downs_t) == len(downs_j) == 4
    for d_t, d_j in zip(downs_t, downs_j):
        assert d_t.shape == d_j.shape
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(mid_t.numpy(), np.asarray(mid_j), atol=1e-4, rtol=1e-4)
    assert float(mid_t.abs().max()) > 1e-2  # the heads are not zero here


def test_zero_heads_give_zero_residuals():
    _, _, tmodel = controlnet_pair(seed=5)
    with torch.no_grad():
        for head in list(tmodel.controlnet_down_blocks) + [tmodel.controlnet_mid_block]:
            head.weight.zero_()
            head.bias.zero_()
        x, ctx, cond = (torch.from_numpy(a) for a in _inputs(6, TINY_CN))
        downs, mid = tmodel(x, torch.tensor([5]), ctx, cond)
    assert all(float(d.abs().max()) == 0.0 for d in downs) and float(mid.abs().max()) == 0.0


def test_scale_and_multi_net_sum_match_jax():
    """A net's residuals scale with `conditioning_scale`; two nets' residuals
    sum residual by residual, as the JAX sum does."""
    jmodel, params, tmodel = controlnet_pair(seed=7)
    _, params2, tmodel2 = controlnet_pair(seed=8)
    x, ctx, cond = _inputs(9, TINY_CN)
    t = np.asarray([500])
    (d1_j, m1_j), (d1_t, m1_t) = _run_both(jmodel, params, tmodel, x, t, ctx, cond)
    (d2_j, m2_j), (d2_t, m2_t) = _run_both(jmodel, params2, tmodel2, x, t, ctx, cond,
                                           conditioning_scale=0.5)
    with torch.no_grad():
        d_half, m_half = tmodel(*(torch.from_numpy(a) for a in (x, t, ctx, cond)),
                                conditioning_scale=0.5)
    torch.testing.assert_close(m_half, m1_t * 0.5)
    for a, b in zip(d_half, d1_t):
        torch.testing.assert_close(a, b * 0.5)
    downs_t, mid_t = sum_controlnet_residuals([(d1_t, m1_t), (d2_t, m2_t)])
    downs_j, mid_j = jax_sum([(d1_j, m1_j), (d2_j, m2_j)])
    torch.testing.assert_close(mid_t, m1_t + m2_t)
    np.testing.assert_allclose(mid_t.numpy(), np.asarray(mid_j), atol=1e-4, rtol=1e-4)
    for a, b in zip(downs_t, downs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)
    assert sum_controlnet_residuals([]) == (None, None)


@pytest.mark.parametrize("kw", [TINY_CN, LCM_CN], ids=["tiny", "lcm"])
def test_controlnet_mapping_is_the_port_state_dict(kw):
    cfg = UNet3DConfig(**kw, use_motion_module=False)
    sd = ControlNetModel(cfg).state_dict()
    _, params, _ = controlnet_pair(kw)
    carried = from_jax.controlnet_state_dict(params, cfg)
    assert set(carried) == set(sd)
    assert all(tuple(v.shape) == tuple(sd[k].shape) for k, v in carried.items())


def test_full_width_key_table_covers_every_parameter():
    """At SD1.5 width (meta device) the port's key table is every parameter
    of its ControlNet, the JAX table's keys exactly, with 13 heads."""
    with torch.device("meta"):
        model = ControlNetModel(SD15_CONTROLNET)
    sd = model.state_dict()
    keys = controlnet_keys(SD15_CONTROLNET)
    assert len(keys) == len(set(keys)) and set(keys) == set(sd)
    jcfg = JaxUNetConfig(use_motion_module=False)
    assert set(keys) == {t for t, _, _ in jax_mapping(jcfg)}
    assert len(model.controlnet_down_blocks) == 12
    assert sum(p.numel() for p in model.parameters()) > 3.6e8
    # a checkpoint missing a key raises; extra keys are ignored
    full = {k: torch.zeros(1) for k in keys}
    assert set(controlnet_state_dict_from_torch({**full, "extra": 1}, SD15_CONTROLNET)) == set(keys)
    full.pop("controlnet_mid_block.bias")
    with pytest.raises(KeyError, match="controlnet_mid_block.bias"):
        controlnet_state_dict_from_torch(full, SD15_CONTROLNET)


def test_config_from_json():
    """Absent fields take the SD1.5 values; the fields a diffusers
    config.json carries set the architecture."""
    assert controlnet_config_from_json({}) == (SD15_CONTROLNET, (16, 32, 96, 256))
    cfg, cond = controlnet_config_from_json({
        "block_out_channels": [8, 16], "layers_per_block": 1, "attention_head_dim": 2,
        "cross_attention_dim": 16, "norm_num_groups": 4,
        "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
        "conditioning_embedding_out_channels": [4, 8]})
    assert cfg == UNet3DConfig(**LCM_CN, use_motion_module=False) and cond == (4, 8)


def test_unet_with_residuals_matches_jax():
    """The tiny LCM UNet with ControlNet-shaped residuals on every skip and
    the mid block, against the JAX UNet at 1e-4."""
    jmodel, params, tmodel = unet_pair(LCM_UNET, LCM_MOTION, seed=11)
    _, _, cn = controlnet_pair(LCM_CN, seed=12)
    rng = np.random.RandomState(13)
    B, F_ = 1, 3
    x = rng.randn(B, F_, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(B, 7, 16).astype(np.float32)
    cond = rng.rand(B, F_, 64, 64, 3).astype(np.float32)
    w = rng.randn(B, 8).astype(np.float32)
    t = np.asarray([700])
    with torch.no_grad():
        downs, mid = cn(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                        torch.from_numpy(cond))
        out_t = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                       timestep_cond=torch.from_numpy(w),
                       down_block_additional_residuals=downs,
                       mid_block_additional_residual=mid).numpy()
        plain = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
                       timestep_cond=torch.from_numpy(w)).numpy()
    out_j = np.asarray(jmodel.apply(
        {"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
        timestep_cond=jnp.asarray(w),
        down_block_additional_residuals=[jnp.asarray(d.numpy()) for d in downs],
        mid_block_additional_residual=jnp.asarray(mid.numpy())))
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, rtol=1e-4)
    assert np.abs(out_t - plain).max() > 1e-3  # the residuals moved the output
