"""K3 in the port against the JAX package on the CPU: the plain version of
`motion_module_fused` against the JAX Pallas kernel in interpret mode, the
port's MotionModule and a tiny UNet3D with K3 on against the JAX modules
forced onto their fused path (the way tests/test_motion_kernel.py forces it),
the flat parameter dict, the facade's switch, and the wrapper's calls per
UNet forward.

Tolerances: the module gate of tests/test_motion_kernel.py (atol 2e-5,
rtol 1e-4) for the kernel and the module, and the UNet gate of
tests/test_unet3d.py (1e-4) for the UNet; everything in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from controlanimate_tpu.models import motion_module as jmm
from controlanimate_tpu.models.motion_module import MotionModule as JaxMotionModule
from controlanimate_tpu.models.motion_module import temporal_positional_encoding
from controlanimate_tpu.ops import motion_kernel as jmk
from controlanimate_tpu_torch.config import MotionModuleConfig, RunConfig
from controlanimate_tpu_torch.models.motion_module import MotionModule
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from controlanimate_tpu_torch.ops import motion_kernel as mk
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import TINY_MOTION, TINY_UNET, clip_pair, random_params, unet_pair, vae_pair

ATOL, RTOL = 2e-5, 1e-4
B, F, H, W, C, HEADS = 1, 4, 4, 8, 64, 8  # N = 32, head dim 8


def _kernel_params(seed=0):
    """The flat K3 parameter dict as numpy, lecun-scaled matrices, small
    biases, norm scales near 1."""
    rng = np.random.RandomState(seed)

    def mat(i, o):
        return (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)

    def vec(n, base=0.0):
        return (base + 0.1 * rng.randn(n)).astype(np.float32)

    p = {"gn_a": vec(B * F * C, 1.0).reshape(B, F, C), "gn_b": vec(B * F * C).reshape(B, F, C),
         "win": mat(C, C), "bin": vec(C), "wout": mat(C, C), "bout": vec(C),
         "lsf": vec(C, 1.0), "lbf": vec(C), "w1": mat(C, 8 * C), "b1": vec(8 * C),
         "w2": mat(4 * C, C), "b2": vec(C)}
    for i in (0, 1):
        p.update({f"ls{i}": vec(C, 1.0), f"lb{i}": vec(C), f"wq{i}": mat(C, C),
                  f"wk{i}": mat(C, C), f"wv{i}": mat(C, C), f"wo{i}": mat(C, C),
                  f"ob{i}": vec(C)})
    return p


@pytest.mark.parametrize("use_pe", [True, False])
def test_plain_matches_jax_kernel(use_pe):
    p = _kernel_params()
    x = np.random.RandomState(1).randn(B, F, H * W, C).astype(np.float32)
    pe = temporal_positional_encoding(8, C)[:F] if use_pe else None
    ref = jmk.motion_module_fused(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                                  heads=HEADS, pe=pe, interpret=True)
    mk.reset_launch_counts()
    out = mk.motion_module_fused(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()},
                                 heads=HEADS, pe=None if pe is None else torch.from_numpy(pe))
    assert mk.motion_module_fused.launches == 0  # a CPU tensor launches nothing
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


def _force_jax_fused(monkeypatch, calls):
    """JAX's MotionModule dispatch onto its fused path, the kernel in
    interpret mode; each fused call appends its p to `calls`."""
    monkeypatch.setattr(jmm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jmm, "_single_device", lambda: True)
    monkeypatch.setattr(jmm, "motion_kernel_enabled", lambda: True)

    def fused_interpret(x, p, **kw):
        calls.append(p)
        return jmk.motion_module_fused(x, p, **dict(kw, interpret=True))

    monkeypatch.setattr(jmm, "motion_module_fused", fused_interpret)


def _spy_port(monkeypatch, calls):
    """Record the port's K3 calls as (x shape, p)."""
    wrapper = mk.motion_module_fused

    def spy(x, p, **kw):
        calls.append((tuple(x.shape), p))
        return wrapper(x, p, **kw)

    monkeypatch.setattr(mk, "motion_module_fused", spy)


@pytest.fixture(scope="module", params=[True, False], ids=["pe", "no_pe"])
def module_pair(request):
    """A JAX MotionModule and the port's with the same random weights, its
    input, and the JAX fused path's output and flat parameter dict."""
    use_pe = request.param
    jmodule = JaxMotionModule(heads=HEADS, max_len=8, use_pos_encoding=use_pe, groups=8)
    x = (np.random.RandomState(2).randn(B, F, H, W, C) * 0.5).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jnp.zeros(x.shape)))
    params = random_params(shapes["params"], seed=3, scale=0.1)
    cfg = UNet3DConfig(motion=MotionModuleConfig(
        num_attention_heads=HEADS, temporal_position_encoding=use_pe,
        temporal_position_encoding_max_len=8))
    carried = from_jax._state_dict({"mm": params}, from_jax._motion("mm", "mm", cfg))
    module = MotionModule(C, heads=HEADS, max_len=8, use_pos_encoding=use_pe, groups=8).eval()
    module.load_state_dict({k.removeprefix("mm."): v for k, v in carried.items()})
    with pytest.MonkeyPatch.context() as mp:
        calls = []
        _force_jax_fused(mp, calls)
        ref = np.asarray(jmodule.apply({"params": params}, jnp.asarray(x)))
    assert len(calls) == 1, "the JAX fused path was not taken"
    return module, x, ref, calls[0]


@pytest.mark.parametrize("reference", ["jax_fused", "port_dense"])
def test_module_with_kernel_matches(module_pair, monkeypatch, reference):
    module, x, jax_ref, _ = module_pair
    xt = torch.from_numpy(x)
    if reference == "jax_fused":
        ref = jax_ref
    else:
        module.use_motion_kernel = False
        with torch.no_grad():
            ref = module(xt).numpy()
    calls = []
    _spy_port(monkeypatch, calls)
    module.use_motion_kernel = True
    try:
        with torch.no_grad():
            out = module(xt).numpy()
    finally:
        module.use_motion_kernel = False
    assert [shape for shape, _ in calls] == [(B, F, H * W, C)]
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_flat_params_match_jax(module_pair, monkeypatch):
    """The port's flat p equals the one JAX's MotionModule hands its kernel:
    the weights exactly, the folded GroupNorm terms to fp32 rounding."""
    module, x, _, jax_p = module_pair
    calls = []
    _spy_port(monkeypatch, calls)
    module.use_motion_kernel = True
    try:
        with torch.no_grad():
            module(torch.from_numpy(x))
    finally:
        module.use_motion_kernel = False
    (_, p), = calls
    assert set(p) == set(jax_p)
    for key, value in p.items():
        got, want = value.detach().numpy(), np.asarray(jax_p[key])
        assert got.shape == want.shape, key
        if key.startswith("gn_"):
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("use_pe", [True, False], ids=["pe", "no_pe"])
def test_unet_with_kernel_matches_jax(monkeypatch, use_pe):
    """A tiny UNet3D with every motion module on K3 against the JAX UNet with
    its kernel forced; at 8x8 latents JAX's `pick_nblk` takes both levels
    (N = 64 and 16), so all 7 motion modules run fused on both sides."""
    motion = dict(TINY_MOTION, temporal_position_encoding=use_pe)
    jmodel, params, tmodel = unet_pair(TINY_UNET, motion, seed=8)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 3, 8, 8, 4).astype(np.float32)
    t = np.asarray([10, 900])
    ctx = rng.randn(2, 7, TINY_UNET["cross_attention_dim"]).astype(np.float32)
    jax_calls, port_calls = [], []
    _force_jax_fused(monkeypatch, jax_calls)
    out_j = np.asarray(jax.jit(lambda p, x, t, c: jmodel.apply({"params": p}, x, t, c))(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    _spy_port(monkeypatch, port_calls)
    tmodel.set_motion_kernel(True)
    with torch.no_grad():
        out_t = tmodel(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx)).numpy()
    assert len(jax_calls) == len(port_calls) == 7
    np.testing.assert_allclose(out_t, out_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("env,expected", [("1", True), ("0", False), (None, False)])
def test_facade_reads_the_motion_switch(monkeypatch, env, expected):
    """CONTROLANIMATE_PALLAS_MOTION=1 when the pipeline is built puts every
    motion module on K3; unset or anything else leaves them dense."""
    if env is None:
        monkeypatch.delenv(tfacade.MOTION_ENV, raising=False)
    else:
        monkeypatch.setenv(tfacade.MOTION_ENV, env)
    _, _, tunet = unet_pair()
    _, _, tvae = vae_pair()
    _, _, tclip = clip_pair()
    tunet.set_motion_kernel(not expected)  # the build must overwrite it
    tfacade.ControlAnimatePipeline(
        RunConfig(width=32, height=32, frame_count=4, use_lcm=True, dtype="float32"),
        models=tengine.EngineModels(unet=tunet, vae=tvae),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")
    switches = [m.use_motion_kernel for m in tunet.modules() if isinstance(m, MotionModule)]
    assert switches and all(s == expected for s in switches)


def test_wrapper_calls_per_full_topology_forward(monkeypatch):
    """A full-topology UNet (4 levels, 2 layers a block, the mid block) at
    tiny widths calls the wrapper 21 times a forward, by shape as
    chip_smoke's `expected_k3_launches` reads the module tree; on the CPU it
    counts no launch."""
    torch.manual_seed(0)
    cfg = UNet3DConfig(block_out_channels=(16, 16, 32, 32), attention_heads=2,
                       cross_attention_dim=16, norm_num_groups=8,
                       motion=MotionModuleConfig(num_attention_heads=2,
                                                 temporal_position_encoding_max_len=8))
    unet = UNet3DConditionModel(cfg).eval()
    unet.set_motion_kernel(True)
    calls = []
    _spy_port(monkeypatch, calls)
    mk.reset_launch_counts()
    with torch.no_grad():
        unet(torch.randn(1, 2, 16, 16, 4), torch.tensor([5]), torch.randn(1, 7, 16))
    assert len(calls) == 21 and mk.motion_module_fused.launches == 0
    by_shape = {}
    for (b, f, n, c), _ in calls:
        by_shape[(b, f, n, c, 2)] = by_shape.get((b, f, n, c, 2), 0) + 1
    assert by_shape == chip_smoke.expected_k3_launches(unet, 16, 2, steps=1, windows=1)


def _fp64_sums(monkeypatch):
    """The plain version with its products and LayerNorm statistics summed
    in fp64: the same function, another summation order."""
    def dense(z, kernel, bias=None, residual=None):
        y = z.double() @ kernel.to(z.dtype).double()
        if bias is not None:
            y = y + bias.to(z.dtype).double()
        if residual is not None:
            y = y + residual.double()
        return y.float()

    def layernorm(h, scale, bias, eps=mk.LN_EPS):
        h64 = h.double()
        mean = h64.mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(torch.clamp(h64.square().mean(dim=-1, keepdim=True) - mean.square(),
                                      min=0.0) + eps).float()
        a, b = inv.to(h.dtype), (-mean.float() * inv).to(h.dtype)
        return (h * a + b) * scale.to(h.dtype) + bias.to(h.dtype)

    monkeypatch.setattr(mk, "_dense32", dense)
    monkeypatch.setattr(mk, "_layernorm", layernorm)


@pytest.mark.parametrize("shape", [(1, 16, 64, 640), (1, 16, 128, 320)])
def test_bf16_gate_admits_another_summation_order(monkeypatch, shape):
    """`chip_smoke.k3_mismatch`'s bf16 bound is set by the function: the
    plain version in bf16 against itself with fp64 sums passes it (their
    worst difference is 1.9-2.5e-2 of |ref| + rms(ref) at these widths), while
    a real fault (the PE rows left out) fails it."""
    from controlanimate_tpu_torch.models.motion_module import TemporalTransformer3D

    B_, F_, N_, C_ = shape
    torch.manual_seed(11)
    mod = TemporalTransformer3D(C_, 8, 1, ("Temporal_Self", "Temporal_Self"), 32, True, 32)
    with torch.no_grad():
        for name, prm in mod.named_parameters():
            if prm.ndim >= 2:
                prm.normal_(0.0, prm.shape[1] ** -0.5)
            else:
                prm.normal_(0.0 if name.endswith("bias") else 1.0, 0.1)
    mod = mod.to(torch.bfloat16)
    x = torch.randn(shape).bfloat16()
    with torch.no_grad():
        p, pe = mod.fused_operands(x)
        ref = mk.motion_module_plain(x, p, heads=8, pe=pe)
        no_pe = mk.motion_module_plain(x, p, heads=8, pe=None)
        _fp64_sums(monkeypatch)
        other_order = mk.motion_module_plain(x, p, heads=8, pe=pe)
    assert not torch.equal(other_order, ref)
    assert chip_smoke.k3_mismatch(torch, other_order, ref) is None
    assert chip_smoke.k3_mismatch(torch, no_pe, ref) is not None


def test_packed_weights_are_kept_until_a_parameter_changes():
    """K3's packed weights are made once per module and reused, made again
    after an in-place change of a parameter, and dropped when the UNet
    switches K3 off."""
    cfg = UNet3DConfig(**TINY_UNET, motion=MotionModuleConfig(**TINY_MOTION))
    unet = UNet3DConditionModel(cfg).eval()
    tt = unet.down_blocks[0].motion_modules[0].temporal_transformer
    p = tt.motion_params()
    packed = tt._packed(p, torch.float32)
    assert tt._packed(p, torch.float32) is packed
    torch.testing.assert_close(packed["wqkv0"], torch.cat([p["wq0"].t(), p["wk0"].t(), p["wv0"].t()]))
    assert packed["win"].data_ptr() == tt.proj_in.weight.data_ptr()  # no copy
    with torch.no_grad():
        tt.proj_in.weight.add_(1.0)
    assert tt._packed(p, torch.float32) is not packed
    unet.set_motion_kernel(True)
    assert tt._packing is not None
    unet.set_motion_kernel(False)
    assert tt._packing is None
