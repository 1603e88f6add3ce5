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

import re
from pathlib import Path

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


# -- a numpy emulation of the CUDA chain's tile order ------------------------
_SOURCE = (Path(__file__).resolve().parents[1] / "controlanimate_tpu_torch" / "csrc"
           / "motion_module.cu")
EPI_BIAS, EPI_BIAS_RES, EPI_QKV, EPI_GEGLU = range(4)


def _k3_plan() -> dict:
    """The integer constants of the CUDA source (tile widths, ring depth,
    limits), and LDC, the product tile's pitch."""
    src = _SOURCE.read_text()
    plan = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    plan["LDC"] = plan["BN"] + int(re.search(r"constexpr int LDC = BN \+ (\d+);", src).group(1))
    return plan


def _rnd(a, dtype):
    """a (float32) rounded to `dtype` and back."""
    a = np.ascontiguousarray(a, np.float32)
    return a if dtype == torch.float32 else torch.from_numpy(a).to(dtype).float().numpy()


def _emulate_normalize(h, dtype, n, frames, *, gn=None, ln=None, pe=None):
    """`motion_normalize_kernel` on h (M, C): the folded GroupNorm affine of
    row m's sample m // n, or the LayerNorm with its fp32 statistics summed
    as the warp sums them (lane l takes 8-element units l, l + 32, ..., then
    the xor butterfly), scale, bias and the PE row of frame (m // n) % F, a
    rounding to `dtype` after every op."""
    M, C = h.shape
    sample = np.arange(M) // n
    if gn is not None:
        return _rnd(_rnd(h * gn[0][sample], dtype) + gn[1][sample], dtype)
    s, s2 = np.zeros((M, 32), np.float32), np.zeros((M, 32), np.float32)
    for u in range(C // 8):
        for i in range(8):
            v = h[:, 8 * u + i]
            s[:, u % 32] += v
            s2[:, u % 32] += v * v
    for off in (16, 8, 4, 2, 1):
        s, s2 = s + s[:, np.arange(32) ^ off], s2 + s2[:, np.arange(32) ^ off]
    mean = s[:, :1] / np.float32(C)
    var = np.maximum(s2[:, :1] / np.float32(C) - mean * mean, np.float32(0))
    inv = np.float32(1) / np.sqrt(var + np.float32(1e-5))
    ra, rb = _rnd(inv, dtype), _rnd(-mean * inv, dtype)
    z = _rnd(_rnd(h * ra, dtype) + rb, dtype)
    z = _rnd(_rnd(z * ln[0], dtype) + ln[1], dtype)
    return z if pe is None else _rnd(z + pe[sample % frames], dtype)


def _ldmatrix(stage, addr):
    """ldmatrix.x4 over byte addresses addr (warps, 32 lanes) of a stage of
    bf16 values: matrix i's row r is the 8 elements at lane 8i + r's
    address. Returns (warps, 4, 8, 8)."""
    return stage[(addr // 2)[..., None] + np.arange(8)].reshape(addr.shape[0], 4, 8, 8)


def _products_bf16(a, w, m0, n0, bm, plan):
    """`motion_gemm_bf16_kernel`'s (bm x BN) fp32 products at (m0, n0): each
    k-tile's A and W rows copied to a ring stage at the swizzled offsets of
    `swz` (zero outside the matrices), the stage filled with NaN before its
    copies (a read of a unit the tile did not stage shows in the output); the
    ring order (stages 0 .. kRing - 2 first, then k-tile kt + kRing - 1 into
    the stage k-tile kt - 1 used, before kt's products); each warp's A and B
    fragments read back by its ldmatrix lane offsets, step ks XORing
    (ks << 5); products in fp32."""
    BN, BK, S = plan["BN"], plan["BK"], plan["kRing"]
    rb, mt_n, cols = 2 * BK, bm // 64, BN // 2
    M, K = a.shape
    Nw = w.shape[0]
    ring = np.full((S, (bm + BN) * BK), np.nan, np.float32)
    idx = np.arange((bm + BN) * 8)
    row, u = idx >> 3, idx & 7
    dst = (row * rb + ((u ^ (row & 7)) << 4)) // 2
    is_a = row < bm
    src = np.where(is_a, m0 + row, n0 + row - bm)

    def load(slot, k0):
        ring[slot] = np.nan
        k = k0 + u * 8
        valid = np.where(is_a, src < M, src < Nw) & (k < K)
        vals = np.zeros((idx.size, 8), np.float32)
        ks = k[:, None] + np.arange(8)
        for mat, sel in ((a, valid & is_a), (w, valid & ~is_a)):
            vals[sel] = mat[src[sel][:, None], ks[sel]]
        ring[slot][dst[:, None] + np.arange(8)] = vals

    warp, lane = np.arange(8), np.arange(32)
    wm, wn, key = warp[:, None] & 3, warp[:, None] >> 2, lane & 7
    a_off = [(wm * 16 * mt_n + mt * 16 + (lane & 15)) * rb + (((lane >> 4) ^ key) << 4)
             for mt in range(mt_n)]
    b_off = ((bm + wn * cols + (lane & 7) + ((lane >> 4) << 3)) * rb
             + ((((lane >> 3) & 1) ^ key) << 4))
    ktiles = -(-K // BK)
    for s in range(min(S - 1, ktiles)):
        load(s, s * BK)
    acc = np.zeros((8, mt_n, 16, cols), np.float32)
    for kt in range(ktiles):
        if kt + S - 1 < ktiles:
            load((kt + S - 1) % S, (kt + S - 1) * BK)
        stage = ring[kt % S]
        for ks in range(BK // 16):
            bt = []
            for j in range(cols // 16):
                m = _ldmatrix(stage, (b_off + j * 16 * rb) ^ (ks << 5))  # (warp, 4, 8 n, 8 k)
                # n8 tile 2j: matrices 0 | 1 (k 0-7 | 8-15); tile 2j + 1: 2 | 3
                bt += [np.concatenate([m[:, 0], m[:, 1]], -1),
                       np.concatenate([m[:, 2], m[:, 3]], -1)]
            bfr = np.concatenate(bt, axis=1)  # (warp, n, 16 k)
            for mt in range(mt_n):
                m = _ldmatrix(stage, a_off[mt] ^ (ks << 5))  # (warp, 4, 8 rows, 8 k)
                # rows 0-7: matrices 0 | 2 (k 0-7 | 8-15); rows 8-15: 1 | 3
                afr = np.concatenate([np.concatenate([m[:, 0], m[:, 2]], -1),
                                      np.concatenate([m[:, 1], m[:, 3]], -1)], axis=1)
                acc[:, mt] += np.einsum("wrk,wnk->wrn", afr, bfr)
    tile = np.empty((bm, BN), np.float32)
    for wi in range(8):
        for mt in range(mt_n):
            r0, c0 = (wi & 3) * 16 * mt_n + mt * 16, (wi >> 2) * cols
            tile[r0:r0 + 16, c0:c0 + cols] = acc[wi, mt]
    return tile


def _products_f32(a, w, m0, n0, plan):
    """`motion_gemm_f32_kernel`'s (BM32 x BN) products: BK32-deep stages,
    zero outside the matrices."""
    bm, BN, BK = plan["BM32"], plan["BN"], plan["BK32"]
    rows, cols = m0 + np.arange(bm), n0 + np.arange(BN)
    tile = np.zeros((bm, BN), np.float32)
    for k0 in range(0, a.shape[1], BK):
        ks = k0 + np.arange(BK)
        at = np.where((rows < a.shape[0])[:, None] & (ks < a.shape[1]),
                      a[np.minimum(rows, a.shape[0] - 1)][:, np.minimum(ks, a.shape[1] - 1)], 0)
        wt = np.where((cols < w.shape[0])[:, None] & (ks < w.shape[1]),
                      w[np.minimum(cols, w.shape[0] - 1)][:, np.minimum(ks, w.shape[1] - 1)], 0)
        tile += at.astype(np.float32) @ wt.astype(np.float32).T
    return tile


def _emulate_gemm(a, w, bias, epi, dtype, plan, sms, *, ldo, res=None, split=0):
    """One GEMM launch: the grid (128-row bf16 tiles when they give each of
    `sms` SMs a block, else 64-row tiles; 128-row fp32 tiles), each block's
    products, and the epilogue: the tile staged at pitch LDC, read back in
    8-column units, masked at the ragged M and Nw edges, + bias, + residual,
    the q|k / v split at column `split`, or the GEGLU gate of the tile's
    [GEGLU_GROUP values | their gates]. Outputs start NaN and every unit is
    written once; returns (out, out32 or None)."""
    M, BN, ldc, group = a.shape[0], plan["BN"], plan["LDC"], mk.GEGLU_GROUP
    Nw = w.shape[0]
    ny = -(-Nw // BN)
    if dtype == torch.float32:
        bm = plan["BM32"]
    else:
        bm = 128 if -(-M // 128) * ny >= sms else 64
    products = ((m0, n0, _products_f32(a, w, m0, n0, plan) if dtype == torch.float32
                 else _products_bf16(a, w, m0, n0, bm, plan))
                for m0 in range(0, M, bm) for n0 in range(0, ny * BN, BN))
    out = np.full((M, ldo), np.nan, np.float32)
    out32 = np.full((M, Nw - split), np.nan, np.float32) if epi == EPI_QKV else None
    written = np.zeros((M, ldo), np.int32)
    for m0, n0, tile in products:
        staged = np.full(bm * ldc, np.nan, np.float32)
        staged[(np.arange(bm)[:, None] * ldc + np.arange(BN)).ravel()] = tile.ravel()
        units = group // 8 if epi == EPI_GEGLU else BN // 8
        r, c = np.divmod(np.arange(bm * units), units)
        c = c * 8
        m = m0 + r
        cols = (n0 // 2 if epi == EPI_GEGLU else n0) + c
        keep = (m < M) & (cols < (ldo if epi == EPI_GEGLU else Nw))
        r, c, m, cols = r[keep], c[keep], m[keep], cols[keep]
        e8 = np.arange(8)
        prod = staged[(r * ldc + c)[:, None] + e8]
        if epi == EPI_GEGLU:
            val = _rnd(prod + bias[n0 + c[:, None] + e8], dtype)
            gate = _rnd(staged[(r * ldc + c)[:, None] + group + e8]
                        + bias[n0 + c[:, None] + group + e8], dtype)
            erf = torch.erf(torch.from_numpy(gate * np.float32(0.70710678118654752))).numpy()
            v = _rnd(val * _rnd(np.float32(0.5) * gate * (np.float32(1) + erf), dtype), dtype)
        elif epi == EPI_QKV:
            lo = cols < split
            out32[m[~lo][:, None], cols[~lo][:, None] - split + e8] = prod[~lo]
            m, cols, v = m[lo], cols[lo], _rnd(prod[lo], dtype)
        else:
            v = prod + bias[cols[:, None] + e8]
            if epi == EPI_BIAS_RES:
                v = v + res[m[:, None], cols[:, None] + e8]
            v = _rnd(v, dtype)
        out[m[:, None], cols[:, None] + e8] = v
        written[m[:, None], cols[:, None] + e8] += 1
    assert (written == 1).all(), "an output unit was written other than once"
    return out, out32


def _attention_plans(F_, C, heads, N):
    """(heads a block, positions a block) pairs the frame attention kernel
    takes: head groups that divide `heads` in whole 8-column units, runs of
    about half the positions (a part-empty last run when N is odd), of one
    and of all N. The first is the chain's: the CUDA source's
    `attention_plan` picks the pair by its shared memory (checked on the
    card), and the kernel's blocks are the same for any pair."""
    D = C // heads
    groups = [hg for hg in range(heads, 0, -1) if heads % hg == 0 and hg * D % 8 == 0]
    runs = list(dict.fromkeys(((N + 1) // 2, 1, N)))
    return [(hg, P) for hg in groups for P in runs]


def _emulate_attention(qk, v, shape, dtype, hg, P):
    """`motion_frame_attention_kernel` with hg heads and P positions a block:
    (sample, position tile, head group); q | k of the block's np positions
    staged as (F, P) rows at pitch 2 CW + one 16-byte unit and v as (F, P, CW)
    rows, each staging NaN before its copies; logits and softmax in fp32,
    probabilities rounded, P V in fp32, the output rounded."""
    B, F_, N, C, heads = shape
    item = 4 if dtype == torch.float32 else 2
    D = C // heads
    cw, lq = hg * D, 2 * hg * D + 16 // item
    scale = np.float32(1) / np.sqrt(np.float32(D))
    out = np.full((B * F_ * N, C), np.nan, np.float32)
    f, p = np.meshgrid(np.arange(F_), np.arange(P), indexing="ij")
    for b in range(B):
        for n0 in range(0, N, P):
            npos = min(P, N - n0)
            sel = p < npos
            fs, ps = f[sel], p[sel]
            rows = (b * F_ + fs) * N + n0 + ps
            for c0 in range(0, C, cw):
                sqk = np.full(F_ * P * lq, np.nan, np.float32)
                base = (fs * P + ps) * lq
                sqk[base[:, None] + np.arange(cw)] = qk[rows, c0:c0 + cw]
                sqk[base[:, None] + cw + np.arange(cw)] = qk[rows, C + c0:C + c0 + cw]
                sv = np.full(F_ * P * cw, np.nan, np.float32)
                sv[((fs * P + ps) * cw)[:, None] + np.arange(cw)] = v[rows, c0:c0 + cw]
                for pp in range(npos):
                    o = np.zeros((F_, cw), np.float32)
                    for h in range(hg):
                        q_ = sqk[((np.arange(F_) * P + pp) * lq + h * D)[:, None] + np.arange(D)]
                        k_ = sqk[((np.arange(F_) * P + pp) * lq + cw + h * D)[:, None]
                                 + np.arange(D)]
                        logits = (q_ @ k_.T) * scale
                        e = np.exp(logits - logits.max(axis=1, keepdims=True))
                        probs = _rnd(e / e.sum(axis=1, keepdims=True), dtype)
                        vh = sv[((np.arange(F_) * P + pp) * cw + h * D)[:, None] + np.arange(D)]
                        o[:, h * D:(h + 1) * D] = probs @ vh
                    out[(b * F_ + np.arange(F_)) * N + n0 + pp, c0:c0 + cw] = _rnd(o, dtype)
    return out


def emulate_chain(x, p, heads, pe, sms, attn_plan=None):
    """The CUDA chain on x (B, F, N, C) in x's dtype, launch by launch as
    `run` orders them, each launch emulated as above on `pack_weights`'s
    layouts (W1 grouped by GEGLU_GROUP rows); the frame attention's blocks
    by `attn_plan` (hg, P), by default the first of `_attention_plans`.
    Returns the delta."""
    plan = _k3_plan()
    dt = x.dtype
    B, F_, N, C = x.shape
    hg, P = attn_plan or _attention_plans(F_, C, heads, N)[0]
    M = B * F_ * N
    w = {k: t.float().numpy() for k, t in mk.pack_weights(p, dt).items()}
    pe_np = None if pe is None else _rnd(pe[:F_].float().numpy(), dt)

    def gemm(a, key, bias, epi, **kw):
        return _emulate_gemm(a, w[key], None if bias is None else w[bias], epi, dt, plan, sms, **kw)

    def norm(h, **kw):
        return _emulate_normalize(h, dt, N, F_, **kw)

    gn = tuple(_rnd(p[k].float().numpy().reshape(B * F_, C), dt) for k in ("gn_a", "gn_b"))
    z = norm(x.float().numpy().reshape(M, C), gn=gn)
    h = gemm(z, "win", "bin", EPI_BIAS, ldo=C)[0]
    for i in (0, 1):
        z = norm(h, ln=(w[f"ls{i}"], w[f"lb{i}"]), pe=pe_np)
        qk, v = gemm(z, f"wqkv{i}", None, EPI_QKV, ldo=2 * C, split=2 * C)
        attn = _emulate_attention(qk, v, (B, F_, N, C, heads), dt, hg, P)
        h = gemm(attn, f"wo{i}", f"ob{i}", EPI_BIAS_RES, ldo=C, res=h)[0]
    z = norm(h, ln=(w["lsf"], w["lbf"]))
    gg = gemm(z, "w1", "b1", EPI_GEGLU, ldo=4 * C)[0]
    h = gemm(gg, "w2", "b2", EPI_BIAS_RES, ldo=C, res=h)[0]
    out = gemm(h, "wout", "bout", EPI_BIAS, ldo=C)[0]
    return torch.from_numpy(out.reshape(B, F_, N, C)).to(dt)


def _chain_params(B_, F_, C_, seed):
    """A flat K3 parameter dict (torch, fp32) at width C_: lecun-scaled
    matrices, small biases, norm scales near 1."""
    rng = np.random.RandomState(seed)

    def mat(i, o):
        return torch.from_numpy((rng.randn(i, o) / np.sqrt(i)).astype(np.float32))

    def vec(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.randn(n)).astype(np.float32))

    p = {"gn_a": vec(B_ * F_ * C_, 1.0).reshape(B_, F_, C_),
         "gn_b": vec(B_ * F_ * C_).reshape(B_, F_, C_), "win": mat(C_, C_), "bin": vec(C_),
         "wout": mat(C_, C_), "bout": vec(C_), "lsf": vec(C_, 1.0), "lbf": vec(C_),
         "w1": mat(C_, 8 * C_), "b1": vec(8 * C_), "w2": mat(4 * C_, C_), "b2": vec(C_)}
    for i in (0, 1):
        p.update({f"ls{i}": vec(C_, 1.0), f"lb{i}": vec(C_), f"wq{i}": mat(C_, C_),
                  f"wk{i}": mat(C_, C_), f"wv{i}": mat(C_, C_), f"wo{i}": mat(C_, C_),
                  f"ob{i}": vec(C_)})
    return p


# (B, F, N, C, heads, PE, SMs the tile rule sees): ragged M with C = 64
# (one part-empty column tile; the q|k / v split inside a tile; the GEGLU's
# last group padded) on 64-row and 128-row tiles; the small pipeline's
# width, C = 80 (head dim 40; K = 80, a part-empty k-tile); C = 320 with
# K = 320 and 1280, where the three-stage ring wraps; and head dim 12.
EMULATED_K3 = [(1, 4, 37, 64, 8, True, 132), (1, 4, 37, 64, 8, False, 1),
               (2, 16, 7, 80, 2, True, 132), (1, 4, 9, 320, 8, True, 1),
               (1, 3, 5, 320, 8, False, 132), (1, 6, 9, 96, 8, True, 132)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", EMULATED_K3, ids=[str(c) for c in EMULATED_K3])
def test_kernel_emulation_matches_plain(case, dtype):
    """The chain in the CUDA kernels' order (numpy): the normalize passes,
    each GEMM's grid, cp.async ring, swizzled staging, ldmatrix fragment
    reads and masked 16-byte epilogue (the fp32 GEMM's own tiles in fp32),
    and the frame attention's blocks, against the plain version at
    `chip_smoke.k3_mismatch`'s gates (fp32 at 1e-4, bf16 within 5e-2 of
    |ref| + rms); a read of an unstaged unit or an unwritten output is NaN."""
    B_, F_, N_, C_, heads, use_pe, sms = case
    p = _chain_params(B_, F_, C_, seed=sum(case[:5]))
    x = torch.from_numpy(np.random.RandomState(C_).randn(B_, F_, N_, C_).astype(np.float32))
    x = x.to(dtype)
    pe = torch.from_numpy(temporal_positional_encoding(32, C_)) if use_pe else None
    out = emulate_chain(x, p, heads, pe, sms)
    ref = mk.motion_module_plain(x, p, heads=heads, pe=pe)
    bad = chip_smoke.k3_mismatch(torch, out, ref)
    assert bad is None, bad


# head dim 12 at C = 96, N = 9: head groups of 8, 4 and 2 heads, runs of 5
# positions (the last one part-empty), 1 and 9
ATTN_PLAN_CASE = (1, 4, 9, 96, 8)
ATTN_PLANS = _attention_plans(4, 96, 8, 9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("attn_plan", ATTN_PLANS, ids=[f"hg{hg}-P{P}" for hg, P in ATTN_PLANS])
def test_kernel_emulation_matches_plain_at_any_attention_plan(attn_plan, dtype):
    """The chain's emulation with each head group and position run the frame
    attention kernel takes, against the plain version at
    `chip_smoke.k3_mismatch`'s gates."""
    B_, F_, N_, C_, heads = ATTN_PLAN_CASE
    p = _chain_params(B_, F_, C_, seed=7)
    x = torch.from_numpy(np.random.RandomState(3).randn(B_, F_, N_, C_).astype(np.float32))
    x = x.to(dtype)
    pe = torch.from_numpy(temporal_positional_encoding(32, C_))
    out = emulate_chain(x, p, heads, pe, 132, attn_plan)
    ref = mk.motion_module_plain(x, p, heads=heads, pe=pe)
    bad = chip_smoke.k3_mismatch(torch, out, ref)
    assert bad is None, bad


def test_kernel_plan_ties_to_the_source():
    """The wrapper's constants match the CUDA source's: the GEGLU group is
    half a column tile, the launches are `STAGES`, the frame limit; a bf16
    GEMM block's ring (its
    product tile in the same space) fits, two 64-row blocks an SM; and the
    ring's copies and every ldmatrix
    8x8 matrix the lanes address hit 8 different 16-byte bank groups."""
    plan = _k3_plan()
    BN, BK = plan["BN"], plan["BK"]
    assert mk.GEGLU_GROUP == BN // 2 and len(mk.STAGES) == plan["kLaunches"]
    assert mk.MAX_FRAMES == plan["kMaxFrames"]
    for C_ in (320, 640, 1280):
        assert C_ % BN == 0 and 3 * C_ % BN == 0  # no part-empty column tile on the main path
    for bm in (64, 128):
        # the ring, or the product tile in its space: two 64-row blocks fit an SM
        smem = max(plan["kRing"] * (bm + BN) * BK * 2, bm * plan["LDC"] * 4)
        assert smem <= plan["kSmemLimit"] and (bm == 128 or 2 * (smem + 1024) <= 233_472)
        lane = np.arange(32)
        key = lane & 7
        for wm in range(4):
            for wn in range(2):
                offs = [(wm * bm // 4 + mt * 16 + (lane & 15)) * 2 * BK + (((lane >> 4) ^ key) << 4)
                        for mt in range(bm // 64)]
                offs += [(bm + wn * BN // 2 + (lane & 7) + ((lane >> 4) << 3) + 16 * j) * 2 * BK
                         + ((((lane >> 3) & 1) ^ key) << 4) for j in range(BN // 32)]
                for off in offs:
                    for ks in range(BK // 16):
                        groups = ((off ^ (ks << 5)).reshape(4, 8) // 16) % 8
                        assert all(len(set(g)) == 8 for g in groups.tolist())
        idx = np.arange((bm + BN) * 8)
        row, u = idx >> 3, idx & 7
        addr = row * 2 * BK + ((u ^ (row & 7)) << 4)
        assert all(len(set(g)) == 8 for g in ((addr.reshape(-1, 8) // 16) % 8).tolist())
