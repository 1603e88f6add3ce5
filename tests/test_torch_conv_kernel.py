"""K2 in the port against the JAX package on the CPU: the plain version of
`conv3x3_fused` against the JAX Pallas kernel in interpret mode (the shapes
of tests/test_conv_kernel.py), `groupnorm_fold`, and the VAE with K2 on
against the JAX VAE with its kernel enabled.

Tolerances: fp32 at atol = rtol = 1e-4, the JAX kernel test's gate. bf16:
|port - jax| <= 2e-2 * (|jax| + rms(jax)). The two sides round the
activated input to bf16 at possibly different places (XLA may keep the
affine in fp32 between the multiply and the add), so single inputs can
differ by one bf16 ulp (2**-8 relative), and the output takes one more
rounding: two ulps of the output and its scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.ops import conv_kernel as jck
from controlanimate_tpu_torch.ops import conv_kernel as ck
from test_torch_common import random_params
from controlanimate_tpu_torch.weights import from_jax


def _inputs(B=2, H=16, W=16, Cin=128, Cout=128, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, Cin).astype(np.float32)
    kernel = (rng.randn(3, 3, Cin, Cout) * 0.05).astype(np.float32)
    bias = (rng.randn(Cout) * 0.1).astype(np.float32)
    a = (1.0 + 0.1 * rng.randn(B, Cin)).astype(np.float32)
    b = (0.1 * rng.randn(B, Cin)).astype(np.float32)
    res = rng.randn(B, H, W, Cout).astype(np.float32)
    return x, kernel, bias, a, b, res


def _bf16_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt(np.mean(np.square(ref)))
    excess = (np.abs(out - ref) - 2e-2 * (np.abs(ref) + rms)).max()
    assert excess <= 0, f"bf16 error exceeds 2e-2 (|ref| + rms = {rms}) by {excess}"


CASES = {
    # name: (shape kwargs, use affine + silu, use residual, JAX kernel kwargs)
    "plain": (dict(), False, False, {}),
    "affine_silu_residual": (dict(), True, True, {}),
    "multi_row_multi_cout": (dict(B=1, H=32, W=16, Cout=256), True, False,
                             dict(rows_per_block=8, block_cout=128)),
    "no_affine_residual": (dict(B=1, H=16, W=32), False, True, {}),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_conv3x3_fused_matches_jax_kernel(case, dtype):
    shape, affine, residual, jkw = CASES[case]
    x, kernel, bias, a, b, res = _inputs(**shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    j = jck.conv3x3_fused(
        jnp.asarray(x, jdt), jnp.asarray(kernel, jdt), jnp.asarray(bias),
        affine=(jnp.asarray(a, jdt), jnp.asarray(b, jdt)) if affine else None,
        act="silu" if affine else None, residual=jnp.asarray(res, jdt) if residual else None,
        interpret=True, **jkw)
    t = ck.conv3x3_fused(
        torch.from_numpy(x).to(tdt), torch.from_numpy(kernel).to(tdt), torch.from_numpy(bias),
        affine=(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)) if affine else None,
        act="silu" if affine else None,
        residual=torch.from_numpy(res).to(tdt) if residual else None)
    assert t.dtype == tdt and tuple(t.shape) == tuple(j.shape)
    jf = np.asarray(j.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(t.numpy(), jf, atol=1e-4, rtol=1e-4)
    else:
        _bf16_close(t.float().numpy(), jf)


def test_border_reads_zero_after_the_activation():
    """The padding is applied after affine + SiLU: a border tap reads 0, not
    silu(b). With x = 0 and a shift b, only a zero-padded activation gives
    the interior value at the border minus the missing taps."""
    x = torch.zeros(1, 4, 4, 16)
    b = torch.full((1, 16), 2.0)
    w = torch.ones(3, 3, 16, 128)
    out = ck.conv3x3_fused(x, w, torch.zeros(128), affine=(torch.ones(1, 16), b), act="silu")
    s = float(torch.nn.functional.silu(torch.tensor(2.0))) * 16
    assert torch.allclose(out[0, 1, 1], torch.full((128,), 9 * s))  # interior: 9 taps
    assert torch.allclose(out[0, 0, 0], torch.full((128,), 4 * s))  # corner: 4 taps
    assert torch.allclose(out[0, 0, 1], torch.full((128,), 6 * s))  # edge: 6 taps


def test_groupnorm_fold_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 8, 128).astype(np.float32) * 2 + 0.5
    scale = (1.0 + 0.2 * rng.randn(128)).astype(np.float32)
    bias = (0.3 * rng.randn(128)).astype(np.float32)
    ja, jb = jck.groupnorm_fold(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6)
    ta, tb = ck.groupnorm_fold(torch.from_numpy(x), torch.from_numpy(scale),
                               torch.from_numpy(bias), 32, 1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=1e-5)


def test_supported_rule_takes_every_sd_vae_conv():
    for hw in (64, 128, 256, 512):
        for cin, cout in ((128, 128), (128, 256), (256, 256), (256, 512), (512, 512),
                          (512, 256), (256, 128)):
            assert ck.supported(hw, hw, cin, cout)
    assert not ck.supported(64, 64, 3, 128) and not ck.supported(64, 64, 128, 8)


def test_kernel_launch_needs_cuda_or_raises():
    """A CPU tensor takes the plain version and counts no launch; the kernel
    path refuses what it cannot take before touching a library."""
    ck.reset_launch_counts()
    x, kernel, bias, *_ = _inputs(B=1, H=4, W=4)
    ck.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(kernel), torch.from_numpy(bias))
    assert ck.conv3x3_fused.launches == 0
    with pytest.raises(ValueError, match="not supported"):
        ck.check_kernel_args(torch.zeros(1, 4, 4, 8), torch.zeros(3, 3, 8, 128), None, None)
    with pytest.raises(ValueError, match="CUDA"):
        ck.check_kernel_args(torch.zeros(1, 4, 4, 16), torch.zeros(3, 3, 16, 128), None, None)
    with pytest.raises(ValueError, match="HWIO"):
        ck.conv3x3_fused(torch.zeros(1, 4, 4, 16), torch.zeros(128, 16, 3, 3), torch.zeros(128))


# -- the VAE with K2 on against the JAX VAE with its kernel enabled ----------
def _jax_kernel_on(fn):
    jck.set_conv_kernel_enabled(True)
    try:
        return fn()
    finally:
        jck.set_conv_kernel_enabled(False)


def test_vae_resnet_block_with_k2_matches_jax():
    from controlanimate_tpu.models.vae import VaeResnetBlock as JaxBlock
    from controlanimate_tpu_torch.models.vae import VaeResnetBlock

    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 128).astype(np.float32)
    jblock = JaxBlock(out_channels=256, groups=32)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    params = random_params(shapes["params"], seed=4, scale=0.05)
    ref = _jax_kernel_on(lambda: jblock.apply({"params": params}, jnp.asarray(x)))
    block = VaeResnetBlock(128, 256, groups=32).eval()
    carried = from_jax._state_dict({"blk": params}, from_jax._vae_resnet("blk", "blk", True))
    block.load_state_dict({k.removeprefix("blk."): v for k, v in carried.items()})
    block.use_conv_kernel = True
    with torch.no_grad():
        out = block(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vae_upsample_with_k2_matches_jax():
    from controlanimate_tpu.models.vae import Upsample2D as JaxUp
    from controlanimate_tpu_torch.models.vae import Upsample2D

    rng = np.random.RandomState(1)
    x = rng.randn(1, 8, 8, 128).astype(np.float32)
    jup = JaxUp(out_channels=128)
    shapes = jax.eval_shape(lambda: jup.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    params = random_params(shapes["params"], seed=5, scale=0.05)
    ref = _jax_kernel_on(lambda: jup.apply({"params": params}, jnp.asarray(x)))
    up = Upsample2D(128).eval()
    up.load_state_dict({
        "conv.weight": torch.from_numpy(np.asarray(params["conv"]["kernel"]).transpose(3, 2, 0, 1)),
        "conv.bias": torch.from_numpy(np.asarray(params["conv"]["bias"])),
    })
    up.use_conv_kernel = True
    with torch.no_grad():
        out = up(torch.from_numpy(x))
    assert out.shape == (1, 16, 16, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def test_vae_decode_with_k2_matches_jax(monkeypatch):
    """A small VAE with 128-channel levels, so that every resnet branch and
    upsample conv takes K2 on both sides (JAX's rule wants 128-lane channels
    and W >= 16), decoded at the UNet gate of 1e-4."""
    from controlanimate_tpu.models.vae import AutoencoderKL as JaxVAE
    from controlanimate_tpu_torch.models.vae import AutoencoderKL

    ch, groups = (128, 128), 32
    jvae = JaxVAE(block_out_channels=ch, groups=groups)
    shapes = jax.eval_shape(lambda: jvae.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    params = random_params(shapes["params"], seed=6, scale=0.05)
    tvae = AutoencoderKL(block_out_channels=ch, groups=groups).eval()
    tvae.load_state_dict(from_jax.vae_state_dict(params, ch))
    tvae.set_conv_kernel(True)
    z = np.random.RandomState(7).randn(1, 16, 16, 4).astype(np.float32)
    ref = _jax_kernel_on(lambda: jax.jit(
        lambda p, z: jvae.apply({"params": p}, z, method=JaxVAE.decode))(params, jnp.asarray(z)))
    calls = []
    wrapper = ck.conv3x3_fused

    def spy(x, *args, **kw):
        calls.append((tuple(x.shape), kw.get("act"), kw.get("residual") is not None))
        return wrapper(x, *args, **kw)

    monkeypatch.setattr(ck, "conv3x3_fused", spy)
    with torch.no_grad():
        out = tvae.decode(torch.from_numpy(z))
    assert out.shape == (1, 32, 32, 3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    # the dispatch went through K2's wrapper: 8 resnets x 2 branches (the
    # second with the residual) and the upsample conv with no activation
    assert len(calls) == 17
    assert sum(act == "silu" and res for _, act, res in calls) == 8
    assert calls.count(((1, 32, 32, 128), None, False)) == 1
