"""K4 in the port against the JAX package on the CPU: the plain versions of
`conv3x3_lrelu` and `upsample2x_conv3x3_lrelu` against the JAX Pallas kernels
in interpret mode (the shapes of tests/test_upconv_kernel.py), both modes,
with and without leaky ReLU; the weight fold against `ops/upsample.py`'s
composite; the bf16 path; and the dispatch rules.

Tolerances: fp32 at atol = rtol = 1e-4, the JAX kernel tests' gate. bf16:
both sides fold the same bf16 weights in fp32, round the fold once, sum
bf16 products in fp32 and round the result once, so they differ by the
summation order and then one bf16 ulp: |port - jax| <= 1e-2 * (|jax| +
rms(jax)), as K2's bf16 gate (2**-7 < 1e-2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.ops import upconv_kernel as juk
from controlanimate_tpu.ops.upsample import upsample2x_conv3x3 as jax_upsample_conv
from controlanimate_tpu_torch.ops import upconv_kernel as uk


def _inputs(B, H, W, Ci, Co, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, H, W, Ci).astype(np.float32)
    k = (rs.randn(3, 3, Ci, Co) * 0.1).astype(np.float32)
    b = rs.randn(Co).astype(np.float32)
    return x, k, b


def _bf16_close(out, ref):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    rms = np.sqrt(np.mean(np.square(ref)))
    excess = (np.abs(out - ref) - 1e-2 * (np.abs(ref) + rms)).max()
    assert excess <= 0, f"bf16 error exceeds 1e-2 (|ref| + rms = {rms}) by {excess}"


def _jax(mode, x, k, b, act):
    if mode == "conv":
        return juk.conv3x3_small(x, k, b, act=act, interpret=True)
    return juk.upsample2x_conv3x3_fine(x, k, b, act=act, interpret=True)


def _port(mode, x, k, b, act):
    fn = uk.conv3x3_lrelu if mode == "conv" else uk.upsample2x_conv3x3_lrelu
    return fn(x, k, b, act=act)


# the shapes of tests/test_upconv_kernel.py, (B, H, W, Ci, Co)
SHAPES = [(1, 8, 16, 8, 8), (2, 16, 32, 16, 8), (1, 12, 16, 8, 16), (1, 16, 16, 16, 8)]


@pytest.mark.parametrize("act", [None, "lrelu"])
@pytest.mark.parametrize("mode", ["conv", "upsample"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matches_jax_kernel_fp32(shape, mode, act):
    x, k, b = _inputs(*shape)
    want = np.asarray(_jax(mode, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b), act))
    got = _port(mode, torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), act)
    B, H, W, _, Co = shape
    scale = 2 if mode == "upsample" else 1
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, scale * H, scale * W, Co)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("mode", ["conv", "upsample"])
def test_matches_jax_kernel_bf16(mode):
    """bf16 input and weights (the same bf16 values on both sides), fp32 bias."""
    x, k, b = _inputs(2, 16, 16, 16, 16, seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    kb = jnp.asarray(k, jnp.bfloat16)
    want = _jax(mode, xb, kb, jnp.asarray(b), "lrelu")
    got = _port(mode, torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
                torch.from_numpy(b), "lrelu")
    assert got.dtype == torch.bfloat16
    _bf16_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_bf16_weights_fold_in_fp32_then_round_once():
    """Folding fp32 weights rounds bf16(w1 + w2), as the JAX fold does: the
    port's kernel-layout weights equal the JAX dense fold's nonzero taps."""
    _, k, _ = _inputs(1, 1, 1, 8, 8, seed=6)
    jfold = np.asarray(juk.fold_upsample_kernel_s2d(jnp.asarray(k)).astype(jnp.bfloat16)
                       .astype(jnp.float32)).reshape(3, 3, 8, 2, 2, 8)
    mine = uk._kernel_weights(torch.from_numpy(k), torch.bfloat16, True).float().numpy()
    for p in (0, 1):
        for q in (0, 1):
            for a in (0, 1):
                for c in (0, 1):
                    np.testing.assert_array_equal(
                        mine[2 * p + q, 2 * a + c].T, jfold[p + a, q + c, :, p, q, :])


def test_fold_matches_upsample_composite():
    """The fold against `controlanimate_tpu/ops/upsample.py`'s exact
    nearest-2x + conv3x3 composite, odd H and W included (the image border
    is where a parity reads the zero halo)."""
    x, k, b = _inputs(2, 5, 7, 8, 8, seed=2)
    want = np.asarray(jax_upsample_conv(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    got = uk.upsample2x_conv3x3_lrelu(torch.from_numpy(x), torch.from_numpy(k),
                                      torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    # and against nearest-2x then conv3x3, spelled out in torch
    t = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                        scale_factor=2.0, mode="nearest")
    naive = torch.nn.functional.conv2d(t, torch.from_numpy(k).permute(3, 2, 0, 1),
                                       torch.from_numpy(b), padding=1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), naive.numpy(), atol=1e-4, rtol=1e-4)


def test_fold_structure_matches_jax():
    """The s2d fold the plain version convolves with is the JAX kernel's
    dense (9 Ci, 4 Co) matrix, 5/9 of it zeros."""
    _, k, _ = _inputs(1, 1, 1, 2, 3, seed=4)
    want = np.asarray(juk.fold_upsample_kernel_s2d(jnp.asarray(k)))
    got = uk.fold_upsample_s2d(torch.from_numpy(k)).reshape(9 * 2, 12).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).mean() == pytest.approx(5 / 9)


def test_kernel_weight_layout_reproduces_the_function():
    """The (P, T, Co, Ci) weights the CUDA kernel stages, applied with its tap
    table (parity p reads patch rows p + a, columns q + b; the conv's tap t
    rows t // 3, columns t % 3) in numpy, give the plain version's output."""
    x, k, b = _inputs(1, 3, 4, 8, 4, seed=3)
    xp = np.pad(x[0], ((1, 1), (1, 1), (0, 0)))
    for upsample in (True, False):
        w = uk._kernel_weights(torch.from_numpy(k), torch.float32, upsample).numpy()
        P, T = w.shape[:2]
        out = np.zeros((2 * 3, 2 * 4, 4) if upsample else (3, 4, 4), np.float32)
        for par in range(P):
            for y in range(3):
                for xx in range(4):
                    acc = b.copy()
                    for tap in range(T):
                        oy, ox = ((par >> 1) + (tap >> 1), (par & 1) + (tap & 1)) if upsample \
                            else (tap // 3, tap % 3)
                        acc = acc + w[par, tap] @ xp[y + oy, xx + ox]
                    at = (2 * y + (par >> 1), 2 * xx + (par & 1)) if upsample else (y, xx)
                    out[at] = acc
        want = uk.upconv3x3(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b),
                            upsample=upsample)[0].numpy()
        np.testing.assert_allclose(out, want, atol=1e-5, rtol=1e-5)


def test_supported_rule():
    assert uk.supported(512, 512, 64, 64) and uk.supported(1, 1, 32, 32)
    assert uk.supported(7, 9, 64, 32)
    assert not uk.supported(8, 8, 16, 64) and not uk.supported(8, 8, 64, 48)


def test_cpu_tensor_takes_plain_path_and_kernel_refuses():
    """A CPU tensor takes the plain version and counts no launch; the kernel
    path refuses what it cannot take before touching a library."""
    uk.reset_launch_counts()
    x, k, b = _inputs(1, 4, 4, 32, 32)
    uk.conv3x3_lrelu(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b), "lrelu")
    uk.upsample2x_conv3x3_lrelu(torch.from_numpy(x), torch.from_numpy(k), torch.from_numpy(b))
    assert uk.upconv3x3.launches == 0 and not uk.upconv3x3.launches_by_shape
    with pytest.raises(ValueError, match="not supported"):
        uk.check_kernel_args(torch.zeros(1, 4, 4, 16), torch.zeros(3, 3, 16, 64))
    with pytest.raises(ValueError, match="CUDA"):
        uk.check_kernel_args(torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 64))
    with pytest.raises(ValueError, match="HWIO"):
        uk.conv3x3_lrelu(torch.zeros(1, 4, 4, 32), torch.zeros(64, 32, 3, 3), torch.zeros(64))
    with pytest.raises(ValueError, match="act"):
        uk.conv3x3_lrelu(torch.zeros(1, 4, 4, 32), torch.zeros(3, 3, 32, 64), torch.zeros(64),
                         act="silu")
    with pytest.raises(TypeError):
        uk.conv3x3_lrelu(torch.zeros(1, 4, 4, 32, dtype=torch.float16),
                         torch.zeros(3, 3, 32, 64), torch.zeros(64))
