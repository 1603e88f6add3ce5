"""The port on a CUDA card: K1, K2, K3 and K4 against their plain versions, a
small pipeline on the card against the same pipeline on the CPU (without
the optional kernels, with K2, and with K3), and a small RealESRGAN upscaler
(its x4 tail on K4) on the card against the CPU.

Every test here is marked `gpu` and skips without a card. The file imports
neither jax nor the other test modules, so on the card's machine (which has
no jax) it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from controlanimate_tpu_torch.ops import conv_kernel as ck
from controlanimate_tpu_torch.ops import motion_kernel as mk
from controlanimate_tpu_torch.ops import upconv_kernel as uk
from controlanimate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, device, dtype, nk=None, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    kshape = shape if nk is None else (shape[0], nk, *shape[2:])
    return tuple(torch.randn(s, generator=g, device=device).to(dtype)
                 for s in (shape, kshape, kshape))


@pytest.mark.parametrize("shape,nk", [((2, 256, 2, 40), None), ((2, 77, 2, 80), None),
                                      ((1, 100, 3, 160), None), ((1, 130, 1, 512), None),
                                      ((2, 64, 2, 40), 200), ((1, 1, 1, 80), None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, nk, dtype):
    """The gates of `chip_smoke.k1_mismatch`: fp32 at 1e-4 (TF32 off in the
    plain version), bf16 within the JAX bf16 gate and one bf16 ulp; query and
    key lengths may differ and need not be tile multiples."""
    import chip_smoke

    q, k, v = _qkv(shape, cuda, dtype, nk)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    bad = chip_smoke.k1_mismatch(torch, out, flash_attention_plain(q, k, v))
    assert bad is None, bad


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one packed (B, N, 3, H, D) projection: the kernel
    reads them by their strides."""
    qkv = torch.randn(2, 96, 3, 4, 40, device=cuda)
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 64), cuda, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 40), cuda, torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)


def test_small_pipeline_card_matches_cpu(cuda):
    import chip_smoke

    ref = chip_smoke.small_reference(torch)
    assert ref["max_lsb"] <= 1, ref


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 128, 128), (2, 32, 32, 256, 512), (1, 16, 16, 512, 256),  # VAE-like
    (2, 9, 37, 128, 128), (1, 7, 21, 256, 128), (2, 1, 16, 128, 256),  # ragged tiles
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain(cuda, shape, dtype):
    """The gates of `chip_smoke.k2_mismatch` (fp32 at 1e-4 with TF32 off,
    bf16 within one output ulp and the rms), with and without the affine,
    SiLU and residual; each call is one launch."""
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    before = ck.conv3x3_fused.launches
    chip_smoke.check_k2(torch, ck, shape, dtype, g)
    torch.cuda.synchronize()
    assert ck.conv3x3_fused.launches == before + 2


def test_conv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 24, device=cuda)  # Cin not a multiple of 16
    with pytest.raises(ValueError, match="not supported"):
        ck.conv3x3_fused(x, torch.zeros(3, 3, 24, 128, device=cuda), torch.zeros(128, device=cuda))
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ck.conv3x3_fused(x, torch.zeros(3, 3, 16, 128, device=cuda, dtype=torch.float16),
                         torch.zeros(128, device=cuda))


def test_small_pipeline_with_conv_kernel_card_matches_cpu(cuda):
    import chip_smoke

    ck.reset_launch_counts()
    ref = chip_smoke.small_reference(torch, conv_kernel=True)
    assert ref["max_lsb"] <= 1, ref
    assert ck.conv3x3_fused.launches > 0


@pytest.mark.parametrize("shape", [
    (1, 4, 32, 64, 8, True), (1, 4, 32, 64, 8, False),  # the CPU parity tests' shape
    (2, 16, 37, 80, 2, True), (1, 8, 130, 160, 2, True),  # the small pipeline's widths
    (1, 24, 9, 320, 8, True), (1, 32, 5, 40, 1, False),  # 24 and 32 frames; one head of 40
])
def test_motion_kernel_matches_plain(cuda, shape):
    """The gates of `chip_smoke.k3_mismatch` (fp32 at 1e-4, bf16 within
    5e-2 of |ref| + rms(ref)) at small and ragged shapes, fp32 and bf16; one
    launch a call."""
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(2)
    before = mk.motion_module_fused.launches
    chip_smoke.check_k3(torch, mk, shape, g)
    torch.cuda.synchronize()
    assert mk.motion_module_fused.launches == before + 2


def test_motion_kernel_never_takes_the_plain_version(cuda, monkeypatch):
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(3)
    mod, x = chip_smoke.k3_inputs(torch, (1, 4, 32, 64, 8, True), g)
    p, pe = mod.fused_operands(x)

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(mk, "motion_module_plain", refuse)
    with torch.no_grad():
        out = mk.motion_module_fused(x, p, heads=8, pe=pe)
    torch.cuda.synchronize()
    assert out.is_cuda and out.shape == x.shape and bool(torch.isfinite(out).all())


def test_motion_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="C % 8"):
        mk.check_kernel_args(torch.zeros(1, 4, 8, 36, device=cuda), 4)
    with pytest.raises(ValueError, match="frames"):
        mk.check_kernel_args(torch.zeros(1, 33, 8, 64, device=cuda), 8)
    with pytest.raises(ValueError, match="shared memory"):
        mk.check_kernel_args(torch.zeros(1, 32, 8, 4096, device=cuda), 1)
    with pytest.raises(TypeError):
        mk.motion_module_fused(torch.zeros(1, 4, 8, 64, device=cuda, dtype=torch.float16), {},
                               heads=8)


def test_small_pipeline_with_motion_kernel_card_matches_cpu(cuda):
    import chip_smoke

    mk.reset_launch_counts()
    ref = chip_smoke.small_reference(torch, motion_kernel=True)
    assert ref["max_lsb"] <= 1, ref
    assert mk.motion_module_fused.launches > 0


@pytest.mark.parametrize("shape", [
    (1, 64, 64, 64, 64), (2, 40, 48, 64, 64),  # the tail's widths
    (2, 9, 37, 64, 64), (1, 1, 16, 64, 64), (1, 13, 21, 32, 32), (3, 8, 17, 32, 64),  # ragged
])
@pytest.mark.parametrize("upsample", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_kernel_matches_plain(cuda, shape, upsample, dtype):
    """The gates of `chip_smoke.k4_mismatch` (fp32 at 1e-4 with TF32 off,
    bf16 within one output ulp and the rms) in both modes; H and W off the
    8 x 16 tile; one launch a call, counted under its shape."""
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    before = uk.upconv3x3.launches
    key = tuple(shape) + (upsample,)
    before_shape = uk.upconv3x3.launches_by_shape[key]
    chip_smoke.check_k4(torch, uk, shape, upsample, dtype, g)
    torch.cuda.synchronize()
    assert uk.upconv3x3.launches == before + 1
    assert uk.upconv3x3.launches_by_shape[key] == before_shape + 1


def test_upconv_kernel_reads_strided_inputs(cuda):
    """A crop of a larger NHWC tensor (batch, row and column strides of the
    parent) is read in place, without a copy, and agrees with the plain
    version on the same values."""
    g = torch.Generator(device=cuda)
    g.manual_seed(5)
    parent = torch.randn((2, 20, 40, 64), generator=g, device=cuda)
    x = parent[:, 3:14, 5:30]
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda) / 24.0
    b = torch.randn((64,), generator=g, device=cuda)
    for upsample in (True, False):
        torch.testing.assert_close(uk.upconv3x3(x, w, b, upsample=upsample, act="lrelu"),
                                   uk.upconv3x3_plain(x.contiguous(), w, b, upsample=upsample,
                                                      act="lrelu"),
                                   atol=1e-4, rtol=1e-4)


def test_upconv_kernel_cpu_tensor_takes_the_plain_version(cuda):
    uk.reset_launch_counts()
    x, w, b = torch.randn(1, 8, 8, 64), torch.randn(3, 3, 64, 64), torch.randn(64)
    out = uk.upsample2x_conv3x3_lrelu(x, w, b, "lrelu")
    assert out.device.type == "cpu" and uk.upconv3x3.launches == 0
    torch.testing.assert_close(out, uk.upconv3x3_plain(x, w, b, upsample=True, act="lrelu"))


def test_upconv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 16, device=cuda)  # Ci not a multiple of 32
    with pytest.raises(ValueError, match="not supported"):
        uk.conv3x3_lrelu(x, torch.zeros(3, 3, 16, 64, device=cuda), torch.zeros(64, device=cuda))
    x = torch.zeros(1, 8, 8, 64, device=cuda)  # Co not a multiple of 32
    with pytest.raises(ValueError, match="not supported"):
        uk.upsample2x_conv3x3_lrelu(x, torch.zeros(3, 3, 64, 48, device=cuda),
                                    torch.zeros(48, device=cuda))
    with pytest.raises(TypeError):
        uk.conv3x3_lrelu(x.half(), torch.zeros(3, 3, 64, 64, device=cuda),
                         torch.zeros(64, device=cuda))


@pytest.mark.parametrize("scale", [4.0, 2.0])
def test_small_upscaler_card_matches_cpu(cuda, scale):
    import chip_smoke

    uk.reset_launch_counts()
    ref = chip_smoke.small_upscaler_reference(torch, scale)
    assert ref["max_lsb"] <= 1, ref
    assert uk.upconv3x3.launches == 3
