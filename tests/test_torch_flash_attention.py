"""K1 (flash attention): the port's plain version against the JAX kernel and
its oracle, a numpy emulation of the bf16 CUDA kernel's arithmetic against
the plain version, and the wrapper's argument checks and dispatch. The CUDA
kernel itself is held against the plain version in tests/test_torch_gpu.py."""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

from controlanimate_tpu.ops.attention import reference_attention as jax_reference
from controlanimate_tpu.ops.flash_attention import flash_attention as jax_flash
from controlanimate_tpu_torch.ops import attention as port_attention
from controlanimate_tpu_torch.ops.flash_attention import (
    check_kernel_args,
    flash_attention,
    flash_attention_plain,
)

# the JAX kernel test's shapes, plus the UNet's D = 80 / 160, a VAE-like
# (1, 64, 1, 512) case, the depth ViTs' 577 tokens at D = 64 (a 24 x 24
# grid and the class token) and GLPN's D = 32 (its b0 widths); tolerance is
# the JAX test's own
SHAPES = [(2, 256, 2, 40), (1, 512, 4, 64), (2, 256, 2, 128), (2, 128, 2, 80),
          (1, 64, 2, 160), (1, 64, 1, 512), (1, 577, 2, 64), (2, 96, 5, 32)]
ATOL, RTOL = 2e-5, 1e-4


def _qkv(shape, seed=0, nk=None):
    rng = np.random.RandomState(seed)
    kshape = shape if nk is None else (shape[0], nk, *shape[2:])
    return (rng.randn(*shape).astype(np.float32), rng.randn(*kshape).astype(np.float32),
            rng.randn(*kshape).astype(np.float32))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_kernel_and_oracle(shape):
    q, k, v = _qkv(shape)
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    ref = np.asarray(jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    kern = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True))
    np.testing.assert_allclose(out, kern, atol=ATOL, rtol=RTOL)


def test_plain_matches_jax_multi_block_kv_loop():
    """The JAX kernel's online-softmax branch (several K/V blocks)."""
    q, k, v = _qkv((2, 512, 2, 40), seed=2)
    out = flash_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    kern = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                     block_q=128, block_k=128)
    np.testing.assert_allclose(out, np.asarray(kern), atol=ATOL, rtol=RTOL)


def test_wrapper_on_cpu_is_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv((2, 77, 2, 40), seed=3))
    before = flash_attention.launches
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               atol=0, rtol=0)
    assert flash_attention.launches == before  # a CPU call launches nothing


def test_wrapper_argument_checks():
    q, k, v = map(torch.from_numpy, _qkv((1, 16, 2, 40)))
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :1], v[:, :, :1])
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    for d in (8, 96, 128, 513):
        qd = torch.zeros(1, 16, 2, d)
        with pytest.raises(ValueError, match="head dim"):
            check_kernel_args(qd, qd, qd)
    with pytest.raises(ValueError, match="CUDA"):
        check_kernel_args(q, k, v)


def test_dispatch_rule(monkeypatch):
    """Unmasked self-attention goes to K1's wrapper; cross-attention and the
    causal mask take the plain form."""
    calls = []

    def spy(q, k, v):
        calls.append(q.shape)
        return flash_attention_plain(q, k, v)

    monkeypatch.setattr(port_attention, "flash_attention", spy)
    q, k, v = map(torch.from_numpy, _qkv((1, 16, 2, 40), nk=16))
    port_attention.dot_product_attention(q, k, v)
    assert len(calls) == 1
    qx, kx, vx = map(torch.from_numpy, _qkv((1, 16, 2, 40), nk=77))
    out = port_attention.dot_product_attention(qx, kx, vx)
    ref = jax_reference(*map(jnp.asarray, (qx.numpy(), kx.numpy(), vx.numpy())))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    mask = torch.tril(torch.ones(16, 16, dtype=torch.bool))[None, None]
    out = port_attention.dot_product_attention(q, k, v, mask=mask)
    ref = jax_reference(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                        mask=jnp.asarray(mask.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    assert len(calls) == 1


def _bf16(shape, seed, nk=None):
    """Seeded numpy inputs rounded to bf16, as torch tensors."""
    return tuple(torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(shape, seed, nk))


@pytest.mark.parametrize("shape", [(2, 256, 2, 40), (1, 256, 1, 512)])
@pytest.mark.parametrize("block_k", [None, 128])
def test_bf16_plain_matches_jax_kernel(shape, block_k):
    """In bf16 the plain version rounds P to bf16 before P @ v, as the JAX
    kernel does; one pass (all keys in one block) and the online loop over
    128-key blocks. The gate is `chip_smoke.k1_mismatch`'s bf16 gate:
    atol = rtol = 3e-2, and |out - ref| <= 1e-2 * (|ref| + rms(ref))."""
    q, k, v = _bf16(shape, seed=4)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v))
    kern = jax_flash(jq, jk, jv, interpret=True, block_k=block_k)
    kern = torch.from_numpy(np.array(kern.astype(jnp.float32))).to(torch.bfloat16)
    out = flash_attention_plain(q, k, v)
    assert out.dtype == torch.bfloat16
    bad = chip_smoke.k1_mismatch(torch, kern, out)
    assert bad is None, bad


def _kernel_tiles() -> dict:
    """BK (keys a tile) of each bf16 tile plan, read from the CUDA source's
    `RowsPlan` aliases and `WidePlan`."""
    src = (Path(__file__).resolve().parents[1] / "controlanimate_tpu_torch" / "csrc"
           / "flash_attention.cu").read_text()
    plans = {int(d): int(bk) for d, bk in
             re.findall(r"using Rows\d+ = RowsPlan<(\d+), \d+, \d+, (\d+)>;", src)}
    wide = re.search(r"struct WidePlan \{.*?int D = (\d+);.*?int BK = (\d+);", src, re.S)
    plans[int(wide.group(1))] = int(wide.group(2))
    return plans


def test_kernel_tile_plans_cover_the_head_dims():
    from controlanimate_tpu_torch.ops.flash_attention import SUPPORTED_HEAD_DIMS

    assert sorted(_kernel_tiles()) == sorted(SUPPORTED_HEAD_DIMS)


def emulate_bf16_kernel(q, k, v, bk: int):
    """The bf16 CUDA kernel's arithmetic in numpy, tile by tile: BK-key tiles
    with the ragged tail at -inf; pass 1 takes each row's exact max of
    S = q k^T (fp32 sums of bf16 products) and scales it by scale * log2(e);
    pass 2 takes P = exp2(S * scale * log2(e) - max), with the product and
    the difference rounded once as the kernel's fmaf does, adds the unrounded
    P to the row sums, rounds P to bf16 and adds P @ V_tile to the fp32
    output; the output is divided by the row sums at the end and rounded to
    bf16. q: (B, Nq, H, D), k/v: (B, Nk, H, D), bf16 tensors."""
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    sl = np.float32(np.float32(1.0 / math.sqrt(D)) * np.float32(1.4426950408889634))
    qf, kf, vf = (t.float().numpy().transpose(0, 2, 1, 3) for t in (q, k, v))  # (B, H, N, D)
    tiles = [(k0, min(k0 + bk, Nk)) for k0 in range(0, Nk, bk)]

    def scores(k0, k1):
        s = np.full((B, H, Nq, bk), -np.inf, np.float32)
        s[..., :k1 - k0] = qf @ kf[:, :, k0:k1].transpose(0, 1, 3, 2)
        return s

    m = np.full((B, H, Nq, 1), -np.inf, np.float32)
    for k0, k1 in tiles:
        m = np.maximum(m, scores(k0, k1).max(-1, keepdims=True))
    m = m * sl
    acc = np.zeros((B, H, Nq, D), np.float32)
    rowsum = np.zeros((B, H, Nq, 1), np.float32)
    for k0, k1 in tiles:
        arg = (scores(k0, k1).astype(np.float64) * sl - m).astype(np.float32)
        p = np.exp2(arg)
        rowsum += p.sum(-1, keepdims=True, dtype=np.float32)
        p16 = torch.from_numpy(p[..., :k1 - k0]).to(torch.bfloat16).float().numpy()
        acc += p16 @ vf[:, :, k0:k1]
    out = (acc / rowsum).transpose(0, 2, 1, 3)
    return torch.from_numpy(np.ascontiguousarray(out)).to(torch.bfloat16)


# (B, Nq, Nk, H, D): chip_smoke.ODD_SHAPES and the bf16 cases of
# tests/test_torch_gpu.py `test_kernel_matches_plain`
EMULATED_SHAPES = list(chip_smoke.ODD_SHAPES) + [
    (2, 256, 256, 2, 40), (2, 77, 77, 2, 80), (1, 100, 100, 3, 160), (1, 130, 130, 1, 512),
    (2, 64, 200, 2, 40), (1, 1, 1, 1, 80), (1, 200, 333, 2, 80), (2, 77, 300, 2, 160),
    (1, 64, 129, 1, 512), (3, 129, 77, 2, 40), (2, 577, 577, 2, 64),
    (2, 384, 24, 1, 32), (1, 96, 96, 8, 32),
]


@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_kernel_emulation_matches_plain(shape):
    """The bf16 kernel's tile order and rounding (numpy) against the plain
    version, at `chip_smoke.k1_mismatch`'s bf16 gate."""
    B, Nq, Nk, H, D = shape
    q, k, v = _bf16((B, Nq, H, D), seed=6, nk=Nk)
    out = emulate_bf16_kernel(q, k, v, _kernel_tiles()[D])
    bad = chip_smoke.k1_mismatch(torch, out, flash_attention_plain(q, k, v))
    assert bad is None, bad


def test_alignment_check():
    """bf16 inputs need 16-byte-aligned data pointers and (B, N, H) strides
    (the kernel's 16-byte cp.async); the check names the tensor and raises,
    it does not copy. An aligned input gets past it to the device check."""
    q = torch.zeros(1, 16, 2, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        check_kernel_args(q, q, q)
    # a view one element into its storage
    shifted = torch.zeros(1 + q.numel(), dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="k's data pointer is not 16-byte aligned"):
        check_kernel_args(q, shifted, q)
    # head stride of 44 elements (88 bytes)
    sliced = torch.zeros(1, 16, 2, 44, dtype=torch.bfloat16)[..., :40]
    with pytest.raises(ValueError, match="v's stride 44 of dimension 2"):
        check_kernel_args(q, q, sliced)
    # aligned, so only the device check raises: q, k, v as views of one
    # packed (B, N, 3, H, D) projection; a length-1 dimension, whose stride
    # is never used (the VAE's one head); fp32, which takes no check
    qkv = torch.zeros(2, 16, 3, 2, 40, dtype=torch.bfloat16)
    one_head = torch.zeros(1, 16, 40, dtype=torch.bfloat16)[:, :, None]
    for args in (qkv.unbind(2), (one_head,) * 3, (shifted.float(), sliced.float(), q.float())):
        with pytest.raises(ValueError, match="CUDA"):
            check_kernel_args(*args)
