"""The port on a CUDA card: K1, K2, K3 and K4 against their plain versions, a
small pipeline on the card against the same pipeline on the CPU (without
the optional kernels, with K2, and with K3), a small pipeline built from
disk against the injected one, a small RealESRGAN upscaler (its x4 tail
on K4) on the card against the CPU, the face step (RetinaFace, the
aligned crop, GFPGAN, the paste, and the OpenCV stand-ins under them) on
the card against the CPU, the ControlNet slice: canny and HED on the
card against the CPU, and a small pipeline with two ControlNets; softedge
(PidiNet), lineart_anime, NormalBae, lineart at 48x96, the full-depth
DPT and DPT-hybrid depth networks and GLPN at the b0 widths (K1 at head
dim 32) on the card against the CPU, each call on the card equal to the
one before, and K1 at GLPN's b4 shapes; and the
multi-step samplers: small windows under classifier-free guidance (Euler
with a ControlNet, the LCM-LoRA tail, DPM-Solver) on the card against the
CPU; the IP-Adapter's image encoder: K1 at its (1, 257, 16, 80) shape, and a
narrow tower of its token count and head width in bf16 (on K1) against the
same tower in fp32 through the plain attention; and the segment-parallel
loop on the card against the CPU and against the sequential loop.

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
                                      ((2, 64, 2, 40), 200), ((1, 1, 1, 80), None),
                                      ((3, 129, 2, 40), 77), ((1, 200, 2, 80), 333),
                                      ((2, 77, 2, 160), 300), ((1, 64, 1, 512), 129),
                                      ((2, 577, 12, 64), None), ((1, 77, 2, 64), 300),
                                      ((3, 129, 1, 64), None), ((1, 1536, 1, 32), 24),
                                      ((1, 384, 2, 32), 24), ((1, 96, 5, 32), 24),
                                      ((1, 24, 8, 32), None), ((3, 97, 2, 32), 50)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(cuda, shape, nk, dtype):
    """The gates of `chip_smoke.k1_mismatch`: fp32 at 1e-4 (TF32 off in the
    plain version), bf16 within the JAX bf16 gate and 1e-2 (|ref| + rms);
    query and key lengths may differ and need not be tile multiples. In bf16
    every tile plan (D = 40, 80, 160, 512) runs with ragged Nq and Nk, with
    Nq != Nk, and with more than two K/V tiles, so the two-stage ring wraps
    (BK = 64, 64, 64 and 32 keys). D = 32 at GLPN's b0 shapes at 128x192
    (24 keys: one ragged tile) and an odd one."""
    import chip_smoke

    q, k, v = _qkv(shape, cuda, dtype, nk)
    before = flash_attention.launches
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    bad = chip_smoke.k1_mismatch(torch, out, flash_attention_plain(q, k, v))
    assert bad is None, bad


@pytest.mark.parametrize("shape", [(16, 24576, 384, 1, 64), (16, 6144, 384, 2, 64),
                                   (16, 1536, 384, 5, 64), (16, 384, 384, 8, 64)])
def test_kernel_at_glpn_b4_shapes(cuda, shape):
    """K1's fp32 plan at the four shapes of GLPN's b4 stages on a 16-frame
    512x768 window (Nk = Nq / sr^2 but the last), against the plain
    version at the fp32 gate."""
    import chip_smoke

    B, Nq, Nk, H, D = shape
    q, k, v = _qkv((B, Nq, H, D), cuda, torch.float32, Nk)
    bad = chip_smoke.k1_mismatch(torch, flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert bad is None, bad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_at_the_image_encoder_shape(cuda, dtype):
    """K1 at the CLIP ViT-H/14 tower's self-attention, (1, 257, 16, 80):
    257 = 4 * 64 + 1 leaves one valid row in the last query and key tiles;
    `chip_smoke.k1_mismatch`'s gates."""
    import chip_smoke

    q, k, v = _qkv((1, 257, 16, 80), cuda, dtype, seed=3)
    bad = chip_smoke.k1_mismatch(torch, flash_attention(q, k, v), flash_attention_plain(q, k, v))
    assert bad is None, bad


def test_image_encoder_bf16_on_k1_matches_fp32_plain(cuda, monkeypatch):
    """A CLIP vision tower of ViT-H/14's token count and head width (224 px,
    patch 14: 257 tokens; 2 heads of 80; 4 layers), seeded: in bf16 its
    self-attention runs on K1 (4 launches at (2, 257, 257, 2, 80) for two
    frames); in fp32 with the plain attention it is the reference. Gate:
    each output within 5e-2 of the reference's largest magnitude (bf16
    activations through four layers)."""
    from controlanimate_tpu_torch.models.clip import (CLIPVisionConfig,
                                                      CLIPVisionModelWithProjection)
    from controlanimate_tpu_torch.ops import attention as attention_module
    from controlanimate_tpu_torch.pipelines.ip_adapter import preprocess_clip_image

    torch.manual_seed(0)
    tower = CLIPVisionModelWithProjection(CLIPVisionConfig(
        hidden_size=160, num_layers=4, num_heads=2, intermediate_size=320,
        projection_dim=64)).to(cuda).eval()
    frames = torch.randint(0, 256, (2, 96, 72, 3), dtype=torch.uint8, device=cuda)
    px = preprocess_clip_image(frames)
    with torch.no_grad():
        fp32_tower = CLIPVisionModelWithProjection(tower.config).to(cuda).eval()
        fp32_tower.load_state_dict(tower.state_dict())
        with monkeypatch.context() as m:
            m.setattr(attention_module, "flash_attention", flash_attention_plain)
            want = fp32_tower(px)
        tower.to(torch.bfloat16)
        flash_attention.launches_by_shape.clear()
        got = tower(px.to(torch.bfloat16))
    assert dict(flash_attention.launches_by_shape) == {(2, 257, 257, 2, 80): 4}
    for key in ("image_embeds", "pooled_output", "penultimate_hidden_states"):
        ref = want[key].float()
        err = float((got[key].float() - ref).abs().max())
        assert err <= 5e-2 * float(ref.abs().max()), (key, err)


def test_kernel_reads_strided_inputs(cuda):
    """q, k, v as views of one packed (B, N, 3, H, D) projection: the kernel
    reads them by their strides."""
    qkv = torch.randn(2, 96, 3, 4, 40, device=cuda)
    q, k, v = qkv.unbind(2)
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                               atol=1e-4, rtol=1e-4)


def test_kernel_rejects_misaligned_bf16(cuda):
    """The bf16 kernel copies 16 bytes at a time: a view whose data pointer
    or head stride is not a multiple of 16 bytes raises, and launches
    nothing."""
    q, k, v = _qkv((1, 16, 2, 40), cuda, torch.bfloat16)
    shifted = torch.zeros(1 + q.numel(), device=cuda, dtype=torch.bfloat16)[1:].view(q.shape)
    sliced = torch.zeros(1, 16, 2, 44, device=cuda, dtype=torch.bfloat16)[..., :40]
    before = flash_attention.launches
    with pytest.raises(ValueError, match="q's data pointer"):
        flash_attention(shifted, k, v)
    with pytest.raises(ValueError, match="v's stride 44 of dimension 2"):
        flash_attention(q, k, sliced)
    assert flash_attention.launches == before


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 16, 2, 48), cuda, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, k, v)
    q, k, v = _qkv((1, 16, 2, 40), cuda, torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, k, v)


def test_small_pipeline_card_matches_cpu(cuda):
    import chip_smoke

    ref = chip_smoke.small_reference(torch)
    assert ref["max_lsb"] <= 1, ref


def test_small_disk_built_pipeline_equals_injected(cuda, tmp_path):
    """A small bf16 pipeline built from a snapshot on disk (safetensors
    components, a motion checkpoint with its PE tables) against the injected
    pipeline of the same weights, both on the card: frames equal."""
    import chip_smoke

    ref = chip_smoke.small_disk_reference(torch, tmp_path / "snapshot")
    assert ref["max_lsb"] == 0 and ref["config_equal"], ref


@pytest.mark.parametrize("shape", [
    (2, 64, 64, 128, 128), (2, 32, 32, 256, 512), (1, 16, 16, 512, 256),  # VAE-like
    (2, 9, 37, 128, 128), (1, 7, 21, 256, 128), (2, 1, 16, 128, 256),  # ragged tiles
    # H and W off the 16 x 16 tile with a short last 32-channel chunk (48, 80),
    # or only one (16), at Cout = 256 and 512
    (1, 20, 35, 48, 256), (1, 5, 9, 80, 512), (2, 23, 45, 80, 256), (1, 16, 16, 16, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_matches_plain(cuda, shape, dtype):
    """The gates of `chip_smoke.k2_mismatch` (fp32 at 1e-4 with TF32 off,
    bf16 within one output ulp and the rms), with neither, either or both of
    the affine + SiLU and the residual, and the affine or the SiLU alone
    (each a kernel of its own in bf16); each call is one launch."""
    import chip_smoke

    variants = ({}, {"affine": True, "act": "silu"}, {"residual": True},
                {"affine": True, "act": "silu", "residual": True}, {"affine": True},
                {"act": "silu"})
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    before = ck.conv3x3_fused.launches
    chip_smoke.check_k2(torch, ck, shape, dtype, g, variants)
    torch.cuda.synchronize()
    assert ck.conv3x3_fused.launches == before + len(variants)


def test_conv_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(1, 8, 8, 24, device=cuda)  # Cin not a multiple of 16
    with pytest.raises(ValueError, match="not supported"):
        ck.conv3x3_fused(x, torch.zeros(3, 3, 24, 128, device=cuda), torch.zeros(128, device=cuda))
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ck.conv3x3_fused(x, torch.zeros(3, 3, 16, 128, device=cuda, dtype=torch.float16),
                         torch.zeros(128, device=cuda))


def test_conv_kernel_rejects_misaligned_bf16(cuda):
    """The bf16 kernel copies x and reads the affine terms 16 bytes at a
    time: a view one element into its storage raises, and launches nothing."""
    x = torch.zeros(1, 8, 8, 16, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 128, device=cuda, dtype=torch.bfloat16)
    bias = torch.zeros(128, device=cuda)
    shifted = torch.zeros(1 + x.numel(), device=cuda, dtype=torch.bfloat16)[1:].view(x.shape)
    a = torch.ones(1, 16, device=cuda, dtype=torch.bfloat16)
    a_shifted = torch.ones(17, device=cuda, dtype=torch.bfloat16)[1:].view(1, 16)
    before = ck.conv3x3_fused.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.conv3x3_fused(shifted, w, bias)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ck.conv3x3_fused(x, w, bias, affine=(a_shifted, a), act="silu")
    assert ck.conv3x3_fused.launches == before


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
    # the main path's short grid: M = 1024 at C = 1280, whose C-wide GEMMs take
    # 64-row tiles and the others 128-row tiles; and C = 320 with N = 37, a
    # ragged last row tile and a partial last attention block
    (1, 16, 64, 1280, 8, True), (1, 16, 37, 320, 8, True),
    # head dim 12: 8-column attention tasks that span two heads, scalar logits
    (1, 6, 9, 96, 8, True),
])
def test_motion_kernel_matches_plain(cuda, shape):
    """The gates of `chip_smoke.k3_mismatch` (fp32 at 1e-4, bf16 within
    5e-2 of |ref| + rms(ref)) at small, ragged and short-grid shapes, fp32
    and bf16; one launch a call."""
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


def test_motion_kernel_stage_times(cuda):
    """The timed chain returns one positive time per launch of `STAGES` and
    counts each of its `reps` chains as a launch."""
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    mod, x = chip_smoke.k3_inputs(torch, (1, 16, 37, 320, 8, True), g)
    mod, x = mod.to(torch.bfloat16), x.bfloat16()
    before = mk.motion_module_fused.launches
    with torch.no_grad():
        p, pe = mod.fused_operands(x)
        ms = mk.motion_module_stage_ms(x, p, heads=8, pe=pe, reps=2)
    assert list(ms) == list(mk.STAGES) and all(t > 0 for t in ms.values())
    assert mk.motion_module_fused.launches == before + 2


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


@pytest.mark.parametrize("shape", [
    (16, 4096, 320, 8), (16, 1024, 640, 8), (16, 256, 1280, 8), (16, 64, 1280, 8),  # main path
    (4, 37, 64, 8), (6, 9, 96, 8), (24, 9, 320, 8), (32, 5, 40, 1),
])
@pytest.mark.parametrize("item", [2, 4], ids=["bf16", "fp32"])
def test_motion_attention_plan_fits(cuda, shape, item):
    """The CUDA source's frame attention plan: a head group that divides the
    heads in whole 8-column units, 1 to N positions a block, within shared
    memory, and two blocks an SM at the main path's bf16 shapes."""
    F_, N, C, heads = shape
    hg, P, smem = mk.attention_plan(F_, C, heads, N, item)
    assert heads % hg == 0 and hg * (C // heads) % 8 == 0 and 1 <= P <= N
    assert 0 < smem <= 232448
    if item == 2 and F_ == 16 and C >= 320:
        assert 2 * (smem + 1024) <= 233472
    assert mk.attention_plan(32, 4096, 1, 8, 4) is None


def test_small_pipeline_with_motion_kernel_card_matches_cpu(cuda):
    import chip_smoke

    mk.reset_launch_counts()
    ref = chip_smoke.small_reference(torch, motion_kernel=True)
    assert ref["max_lsb"] <= 1, ref
    assert mk.motion_module_fused.launches > 0


@pytest.mark.parametrize("shape", [
    (1, 64, 64, 64, 64), (2, 40, 48, 64, 64),  # the tail's widths
    (2, 9, 37, 64, 64), (1, 1, 16, 64, 64), (1, 13, 21, 32, 32), (3, 8, 17, 32, 64),  # ragged
    (1, 11, 19, 128, 64), (1, 9, 23, 256, 96),  # weights staged with each patch; BN = 32
])
@pytest.mark.parametrize("upsample", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upconv_kernel_matches_plain(cuda, shape, upsample, dtype):
    """The gates of `chip_smoke.k4_mismatch` (fp32 at 1e-4 with TF32 off,
    bf16 within one output ulp and the rms) in both modes, with the weights
    folded in the call and folded once (`chip_smoke.check_k4` calls both);
    H and W off the 8 x 16 tile; one launch a call, counted under its
    shape."""
    import chip_smoke

    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    before = uk.upconv3x3.launches
    key = tuple(shape) + (upsample,)
    before_shape = uk.upconv3x3.launches_by_shape[key]
    chip_smoke.check_k4(torch, uk, shape, upsample, dtype, g)
    torch.cuda.synchronize()
    assert uk.upconv3x3.launches == before + 2
    assert uk.upconv3x3.launches_by_shape[key] == before_shape + 2


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


def test_upconv_kernel_takes_weights_folded_once(cuda):
    """Weights folded once (`kernel_weights`, as the upscaler caches them)
    give the output of weights folded in the call, bit for bit, in both
    modes."""
    g = torch.Generator(device=cuda)
    g.manual_seed(6)
    x = torch.randn((2, 19, 45, 64), generator=g, device=cuda).bfloat16()
    w = torch.randn((3, 3, 64, 64), generator=g, device=cuda) / 24.0
    b = torch.randn((64,), generator=g, device=cuda)
    for upsample in (True, False):
        packed = uk.kernel_weights(w, x.dtype, upsample)
        want = uk.upconv3x3(x, w, b, upsample=upsample, act="lrelu")
        assert torch.equal(uk.upconv3x3(x, w, b, upsample=upsample, act="lrelu", packed=packed),
                           want)


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


def test_small_face_step_card_matches_cpu(cuda):
    """`chip_smoke.small_face_reference`'s gates: the detector's outputs
    within 1e-3 of their largest value, the crops equal, the restored crops
    and the pasted frame within 1 LSB."""
    import chip_smoke

    ref = chip_smoke.small_face_reference(torch)
    assert ref["detector_rel_err"] <= 1e-3 and ref["crop_max_lsb"] == 0, ref
    assert ref["restore_max_lsb"] <= 1 and ref["paste_max_lsb"] <= 1, ref


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_warp_ops_card_match_cpu(cuda, dtype):
    """The OpenCV stand-ins compute the same on the card as on the CPU (the
    warp's fused multiply-adds in float64; the blur two fp32 convolutions,
    TF32 off)."""
    import numpy as np

    from controlanimate_tpu_torch.ops.warp import erode, gaussian_blur, warp_affine

    g = torch.Generator().manual_seed(3)
    src = (torch.rand((70, 90, 3), generator=g) * 255).to(dtype)
    M = np.array([[0.9, -0.35, 12.5], [0.4, 1.1, -7.25]], np.float32)
    want = warp_affine(src, M, (101, 77), (135, 133, 132))
    assert torch.equal(warp_affine(src.to(cuda), M, (101, 77), (135, 133, 132)).cpu(), want)
    mask = torch.rand((60, 80), generator=g)
    assert torch.equal(erode(mask.to(cuda), 6).cpu(), erode(mask, 6))
    torch.testing.assert_close(gaussian_blur(mask.to(cuda), 15).cpu(), gaussian_blur(mask, 15),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", [(4, 512, 512), (2, 768, 512), (3, 37, 53), (1, 1, 29)])
@pytest.mark.parametrize("edges", [False, True], ids=["smooth", "edge_rich"])
def test_canny_card_matches_cpu(cuda, shape, edges):
    """Canny's int32 Sobel, fixed-point suppression and label-propagation
    hysteresis give the same maps on the card as on the CPU."""
    import numpy as np

    import chip_smoke

    frames = chip_smoke.synthetic_video(np, *shape, chip_smoke.SEED)
    if edges:
        frames = chip_smoke.edge_rich(np, frames)
    chip_smoke.canny_reference(torch, np, frames)


def test_small_hed_card_matches_cpu(cuda):
    import chip_smoke

    ref = chip_smoke.small_hed_reference(torch)
    assert ref["max_lsb"] <= 1 and ref["std"] > 0.02, ref


def test_small_controlnet_window_card_matches_cpu(cuda):
    """The small fp32 pipeline with two ControlNets (canny and HED) on the
    card against the CPU: uint8 within 1 LSB, and the nets change the
    frames."""
    import chip_smoke

    ref = chip_smoke.small_controlnet_reference(torch)
    assert ref["max_lsb"] <= 1 and ref["controlnet_change_max"] > 0, ref


def test_small_segment_run_card_matches_cpu(cuda, tmp_path):
    """The small fp32 pipeline's segment-parallel loop (2 segments of two
    windows) on the card against the CPU: each window within 1 LSB; and its
    first window against the sequential loop on each segment alone on the
    card, within 1 LSB."""
    import chip_smoke

    ref = chip_smoke.small_segment_reference(torch, tmp_path / "segments")
    assert ref["max_lsb"] <= 1 and ref["sequential_max_lsb"] <= 1, ref
    assert ref["windows"] == 2, ref


@pytest.mark.parametrize("case", ["EULER_CFG", "LCM_LORA", "DPM_CFG"])
def test_small_multistep_windows_card_match_cpu(cuda, case):
    """Two small fp32 windows of a multi-step sampler under CFG (a whole one,
    then an overlap one from its last outputs; Euler with a canny
    ControlNet) on the card against the CPU: uint8 within 1 LSB."""
    import chip_smoke

    ref = chip_smoke.small_reference(torch, controlnet=case == "EULER_CFG",
                                     **getattr(chip_smoke, case))
    assert ref["max_lsb"] <= 1, ref


@pytest.mark.parametrize("name,hw", [("softedge", (64, 80)), ("softedge", (45, 61)),
                                     ("softedge", (48, 96)), ("lineart_anime", (256, 256)),
                                     ("lineart_anime", (200, 120))])
def test_softedge_and_lineart_anime_card_match_cpu(cuda, name, hw):
    """The seeded full-width PidiNet and lineart_anime in fp32 on the card
    against the CPU on the same frames: within 1 LSB after the facade's
    uint8 quantisation, not saturated, and a second call on the card equal
    to the first (no transposed conv reaches cuDNN)."""
    import copy

    import numpy as np

    import chip_smoke
    from controlanimate_tpu_torch.models.annotators import seeded
    from controlanimate_tpu_torch.models.annotators.lineart_anime import (
        LineartAnimeAnnotator, UnetGenerator)
    from controlanimate_tpu_torch.models.annotators.pidinet import PidiNetAnnotator

    frames = torch.from_numpy(chip_smoke.edge_rich(np, chip_smoke.synthetic_video(
        np, 2, *hw, chip_smoke.SEED)))
    g = torch.Generator().manual_seed(chip_smoke.SEED)
    if name == "softedge":
        ckpt = seeded.pidinet_checkpoint(g, frames)
        cpu = PidiNetAnnotator(seeded.pidinet_model(ckpt, "cpu"))
        card = PidiNetAnnotator(seeded.pidinet_model(ckpt, "cuda"))
    else:
        net = seeded.seed_lineart_anime_(UnetGenerator(), g)
        cpu = LineartAnimeAnnotator(net)
        card = LineartAnimeAnnotator(copy.deepcopy(net).cuda())
    want = cpu(frames)
    first = card(frames.cuda())
    assert torch.equal(card(frames.cuda()), first)
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    assert int((q(want) - q(first.cpu())).abs().max()) <= 1
    assert float(want.std()) > 0.02


@pytest.mark.parametrize("hw", [(64, 80), (45, 61)])
def test_normalbae_card_matches_cpu(cuda, hw):
    """The seeded full-B5 NormalBae (its statistics from the 64x80 frames) in
    fp32 on the card against the CPU on the same frames: the frame's size
    (at 45x61 the network's 46x62 cut to it), within 1 LSB after the
    facade's uint8 quantisation, no channel saturated, and a second call on
    the card equal to the first."""
    import numpy as np

    import chip_smoke
    from controlanimate_tpu_torch.models.annotators import seeded
    from controlanimate_tpu_torch.models.annotators.normalbae import NormalBaeAnnotator

    def frames_at(h, w):
        return torch.from_numpy(chip_smoke.edge_rich(np, chip_smoke.synthetic_video(
            np, 2, h, w, chip_smoke.SEED)))

    ckpt = seeded.normalbae_checkpoint(torch.Generator().manual_seed(chip_smoke.SEED),
                                       frames_at(64, 80))
    frames = frames_at(*hw)
    want = NormalBaeAnnotator(seeded.normalbae_model(ckpt, "cpu"))(frames)
    card = NormalBaeAnnotator(seeded.normalbae_model(ckpt, "cuda"))
    first = card(frames.cuda())
    assert first.shape == want.shape == (2, *hw, 3)
    assert torch.equal(card(frames.cuda()), first)
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    assert int((q(want) - q(first.cpu())).abs().max()) <= 1
    assert float(want.reshape(-1, 3).std(0).min()) > 0.02


def test_lineart_card_matches_cpu_at_48x96(cuda):
    """The seeded lineart generator in fp32 on the card against the CPU at
    48x96 (chip_smoke.py's reference holds 64x80): within 1 LSB after the
    facade's uint8 quantisation, not saturated, and a second call on the
    card equal to the first."""
    import copy

    import numpy as np

    import chip_smoke
    from controlanimate_tpu_torch.models.annotators import seeded
    from controlanimate_tpu_torch.models.annotators.edge_nets import (LineartAnnotator,
                                                                     LineartGenerator)

    frames = torch.from_numpy(chip_smoke.edge_rich(np, chip_smoke.synthetic_video(
        np, 2, 48, 96, chip_smoke.SEED)))
    net = seeded.seed_lineart_(LineartGenerator(), torch.Generator().manual_seed(chip_smoke.SEED))
    want = LineartAnnotator(net)(frames)
    card = LineartAnnotator(copy.deepcopy(net).cuda())
    first = card(frames.cuda())
    assert torch.equal(card(frames.cuda()), first)
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    assert int((q(want) - q(first.cpu())).abs().max()) <= 1
    assert float(want.std()) > 0.02


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
def test_depth_card_matches_cpu(cuda, kind):
    """The full-depth seeded DPT (Intel/dpt-large geometry) or DPT-hybrid
    (dpt-hybrid-midas), its head calibrated on the frames, in fp32 on the
    card (K1's fp32 plan at head dim 64) against the CPU at 64x80: within
    1e-4 and 1 LSB after the facade's uint8 quantisation, not constant, and
    a second call on the card equal to the first."""
    import numpy as np

    import chip_smoke
    from controlanimate_tpu_torch.models.annotators import seeded
    from controlanimate_tpu_torch.models.annotators.depth import DepthAnnotator, depth_network

    frames = torch.from_numpy(chip_smoke.edge_rich(np, chip_smoke.synthetic_video(
        np, 2, 64, 80, chip_smoke.SEED)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    make = seeded.dpt_checkpoint if kind == "plain" else seeded.dpt_hybrid_checkpoint
    config, sd = make(gen, frames)
    want = DepthAnnotator(depth_network(config, sd, "cpu"))(frames)
    card = DepthAnnotator(depth_network(config, sd, "cuda"))
    first = card(frames.cuda())
    assert first.shape == want.shape == (2, 64, 80, 3)
    assert torch.equal(card(frames.cuda()), first)
    assert float((first.cpu() - want).abs().max()) <= 1e-4
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    assert int((q(want) - q(first.cpu())).abs().max()) <= 1
    assert float(want.std()) > 0.05


def test_glpn_card_matches_cpu(cuda):
    """A seeded GLPN at the MiT-b0 widths (K1's fp32 plan at head dim 32 on
    every stage), its head calibrated on the frames, on the card against
    the CPU at 128x192: within 1e-4 and 1 LSB after the facade's uint8
    quantisation, not flat, K1 launched once a layer, and a second call on
    the card equal to the first."""
    import numpy as np

    import chip_smoke
    from controlanimate_tpu_torch.models.annotators import seeded
    from controlanimate_tpu_torch.models.annotators.depth import DepthAnnotator, depth_network
    from controlanimate_tpu_torch.models.annotators.glpn import GLPN_B0

    frames = torch.from_numpy(chip_smoke.edge_rich(np, chip_smoke.synthetic_video(
        np, 2, 128, 192, chip_smoke.SEED)))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    config, sd = seeded.glpn_checkpoint(gen, frames, GLPN_B0)
    want = DepthAnnotator(depth_network(config, sd, "cpu"))(frames)
    card = DepthAnnotator(depth_network(config, sd, "cuda"))
    before = flash_attention.launches
    first = card(frames.cuda())
    assert flash_attention.launches - before == sum(GLPN_B0.depths)
    assert first.shape == want.shape == (2, 128, 192, 3)
    assert torch.equal(card(frames.cuda()), first)
    assert float((first.cpu() - want).abs().max()) <= 1e-4
    q = lambda m: (m.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8).int()  # noqa: E731
    assert int((q(want) - q(first.cpu())).abs().max()) <= 1
    assert float(want.std()) > 0.05
