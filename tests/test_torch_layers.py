"""The port's primitives, resnet3d, transformer and motion module against the
JAX package's, on the same random weights and inputs (fp32, CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models import layers as jl
from controlanimate_tpu.models import motion_module as jmm
from controlanimate_tpu.models import resnet3d as jr
from controlanimate_tpu.models import transformer as jt
from controlanimate_tpu.ops.upsample import upsample2x_conv3x3 as jax_upsample
from controlanimate_tpu_torch.models import layers as tl
from controlanimate_tpu_torch.models import motion_module as tmm
from controlanimate_tpu_torch.models import resnet3d as tr
from controlanimate_tpu_torch.models import transformer as tt
from controlanimate_tpu_torch.ops.upsample import upsample2x_conv3x3
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import random_params

ATOL, RTOL = 2e-5, 1e-4  # fp32 reduction order differs (the JAX kernel test's gate)


def _carry(params, entries):
    """Flax params -> state_dict through from_jax table entries written
    relative to the module itself (leading separators dropped)."""
    fixed = ((t.lstrip("."), f.lstrip("/"), kind) for t, f, kind in entries)
    return from_jax._state_dict(params, fixed)


def _pair(jmodule, tmodule, entries, *args, seed=0, **kw):
    """Random weights into both modules; returns (jax apply fn, params)."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw)["params"])
    params = random_params(shapes, seed)
    tmodule.load_state_dict(_carry(params, entries))
    tmodule.eval()
    return lambda *a, **k: jmodule.apply({"params": params}, *a, **k)


def _np(*shape, seed=1, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def _close(t_out, j_out, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=atol, rtol=rtol)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding(dim):
    t = np.asarray([0, 1, 500, 999], np.int64)
    _close(tl.timestep_embedding(torch.from_numpy(t), dim), jl.timestep_embedding(jnp.asarray(t), dim))


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_groupnorm_and_layernorm(eps):
    x = _np(2, 6, 5, 16, scale=3.0) + 1.5
    gn = tl.GroupNorm(4, 16, eps)
    f = _pair(jl.GroupNorm(4, epsilon=eps), gn, from_jax._norm("", ""), jnp.asarray(x))
    with torch.no_grad():
        _close(gn(torch.from_numpy(x)), f(jnp.asarray(x)))
    ln = tl.LayerNorm32(16, eps)
    f = _pair(jl.LayerNorm32(epsilon=eps), ln, from_jax._norm("", ""), jnp.asarray(x))
    with torch.no_grad():
        _close(ln(torch.from_numpy(x)), f(jnp.asarray(x)))


@pytest.mark.parametrize("cross", [False, True])
def test_attention(cross):
    x, ctx = _np(2, 12, 16), _np(2, 7, 24, seed=2)
    jm = jl.Attention(16, heads=2, dim_head=8, cross_attention_dim=24 if cross else None)
    tm = tl.Attention(16, heads=2, dim_head=8, cross_attention_dim=24 if cross else None)
    args = (jnp.asarray(x), jnp.asarray(ctx)) if cross else (jnp.asarray(x),)
    f = _pair(jm, tm, from_jax._attn("", ""), *args)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ctx) if cross else None)
    _close(out, f(*args))


def test_feedforward():
    x = _np(2, 5, 16)
    tm = tl.FeedForward(16)
    f = _pair(jl.FeedForward(), tm, from_jax._ff("", ""), jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), f(jnp.asarray(x)))


def test_upsample2x_conv3x3():
    x, w, b = _np(2, 5, 6, 8), _np(3, 3, 8, 12, seed=2, scale=0.2), _np(12, seed=3)
    out = upsample2x_conv3x3(torch.from_numpy(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                             torch.from_numpy(b))
    _close(out, jax_upsample(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("inflated,cin", [(True, 16), (False, 16), (True, 32)])
def test_resnet_block3d(inflated, cin):
    x, temb = _np(2, 3, 6, 6, cin), _np(2, 40, seed=2)
    jm = jr.ResnetBlock3D(32, use_inflated_groupnorm=inflated, groups=8)
    tm = tr.ResnetBlock3D(cin, 32, 40, groups=8, inflated=inflated)
    f = _pair(jm, tm, from_jax._resnet("", "", cin != 32), jnp.asarray(x), jnp.asarray(temb))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), torch.from_numpy(temb)), f(jnp.asarray(x), jnp.asarray(temb)))


def test_down_and_upsample3d():
    x = _np(1, 2, 6, 6, 8)
    tm = tr.Downsample3D(8, 8)
    f = _pair(jr.Downsample3D(8), tm, from_jax._conv(".conv", "conv/conv"), jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), f(jnp.asarray(x)))
    tm = tr.Upsample3D(8, 8)
    f = _pair(jr.Upsample3D(8), tm, from_jax._conv(".conv", "conv/conv"), jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), f(jnp.asarray(x)))


def test_spatial_transformer():
    x, ctx = _np(1, 2, 4, 4, 32), _np(1, 7, 24, seed=2)
    jm = jt.SpatialTransformer(heads=4, dim_head=8, cross_attention_dim=24, groups=8)
    tm = tt.SpatialTransformer(32, 4, 8, cross_attention_dim=24, groups=8)
    f = _pair(jm, tm, from_jax._spatial("", ""), jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x), torch.from_numpy(ctx)), f(jnp.asarray(x), jnp.asarray(ctx)))


@pytest.mark.parametrize("frames", [3, 8])
def test_motion_module(frames):
    from controlanimate_tpu_torch.models.unet3d import UNet3DConfig

    x = _np(1, frames, 4, 4, 32)
    jm = jmm.MotionModule(heads=4, max_len=8, groups=8)
    tm = tmm.MotionModule(32, heads=4, max_len=8, groups=8)
    cfg = UNet3DConfig()  # the table reads only its (default) motion topology
    f = _pair(jm, tm, from_jax._motion("", "", cfg), jnp.asarray(x))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), f(jnp.asarray(x)))


def test_motion_module_rejects_long_window_and_unported_paths():
    tm = tmm.MotionModule(32, heads=4, max_len=8, groups=8)
    with pytest.raises(ValueError, match="max_len"):
        tm(torch.zeros(1, 9, 2, 2, 32))
    # a band and the UNet's two attention variants are ported
    # (tests/test_torch_attention_variants.py); ToMe is not, and a negative
    # band has no meaning (JAX fails inside jnp.stack for it)
    with pytest.raises(ValueError, match="negative"):
        tmm.MotionModule(32, heads=4, band=-1)
    with pytest.raises(NotImplementedError, match="ToMe"):
        tmm.MotionModule(32, heads=4, tome_ratio=0.5)
    with pytest.raises(NotImplementedError, match="ToMe"):
        tt.SpatialTransformer(32, 4, 8, cross_frame=True, tome_ratio=0.5)
