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

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 128), (3, 64, 320)])
def test_groupnorm_fold_fp32_reductions_match_jax(dtype, shape):
    """The fold's fp32 sum and squared norm of each group, read from x as it
    is, against the JAX fold at 1e-5, in fp32 and bf16, on a VAE map and on
    the motion module's (B*F, N, C) layout; the fold leaves x as it was."""
    rng = np.random.RandomState(4)
    C = shape[-1]
    x = rng.randn(*shape).astype(np.float32) * 2 + 0.5
    scale = (1.0 + 0.2 * rng.randn(C)).astype(np.float32)
    bias = (0.3 * rng.randn(C)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ja, jb = jck.groupnorm_fold(jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
                                32, 1e-6)
    tx = torch.from_numpy(x).to(tdt)
    before = tx.clone()
    ta, tb = ck.groupnorm_fold(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-6)
    assert torch.equal(tx, before)
    assert ta.dtype == tdt and tb.dtype == tdt
    for t, j in ((ta, ja), (tb, jb)):
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j.astype(jnp.float32)),
                                   atol=1e-5, rtol=1e-5)


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


# -- a numpy emulation of the bf16 CUDA kernel's index math ------------------
def _kernel_plan() -> dict:
    """The bf16 plan's tile side, output channels a block and channels a
    chunk, read from the CUDA source."""
    src = (Path(__file__).resolve().parents[1] / "controlanimate_tpu_torch" / "csrc"
           / "conv3x3_fused.cu").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
            for name in ("kTile", "BN", "KC", "kThreads")}


def _swz(row, key, u):
    """The kernel's `swz`: byte offset of 16-byte unit u of a 64-byte staged
    row, the unit XORed with bits 1-2 of key."""
    return row * 64 + ((u ^ ((key >> 1) & 3)) << 4)


def _lane_offsets(wm, wn, lane, tile, w_bytes):
    """The kernel's `lane_offsets` for arrays of warps and lanes: B (weights)
    by s, A (patch) by (dx, s), in bytes from the stage."""
    bn = wn * 64 + (lane & 7) + ((lane >> 4) << 3)
    b = [_swz(bn, bn, 2 * s + ((lane >> 3) & 1)) for s in range(2)]
    a = [[w_bytes + _swz(4 * wm * (tile + 2) + (lane & 15) + dx, (lane & 15) + dx,
                         2 * s + (lane >> 4)) for s in range(2)] for dx in range(3)]
    return a, b


def _ldmatrix_x4(stage, addr):
    """ldmatrix.x4 over byte addresses addr (..., 32): matrix i's row r is the
    8 bf16 at lane 8i + r's address. Returns (..., 4, 8, 8)."""
    rows = stage[(addr // 2)[..., None] + np.arange(8)]  # (..., 32, 8)
    return rows.reshape(*addr.shape[:-1], 4, 8, 8)


def emulate_bf16_kernel(x, weight, bias, affine=None, act=None, residual=None):
    """The bf16 kernel's staging and fragment addressing in numpy: blocks by
    (tile, 128 output channels), output-channel blocks fastest; 16 x 16 pixel
    tiles with the 1-pixel halo zeroed after the activation; Cin in chunks of
    KC with a short last chunk; each chunk's weight slab and patch written to
    a stage at the kernel's swizzled offsets, with the units a chunk does not
    stage left NaN (a read of one shows in the output); then each warp's A
    and B fragments read back by the kernel's ldmatrix lane offsets for every
    tap and k16 step, multiplied in fp32; and the epilogue's + bias,
    + residual and one rounding, with the residual and the output tile
    staged and read back at the kernel's swizzled offsets, and the ragged
    masks. The activated input is the plain version's
    (`ck.activate`), element by element what the kernel computes."""
    plan = _kernel_plan()
    T, BN, KC = plan["kTile"], plan["BN"], plan["KC"]
    P = T + 2
    B, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    z = ck.activate(x, affine, act).float().numpy()
    wk = weight.to(x.dtype).permute(0, 1, 3, 2).reshape(9, Cout, Cin).float().numpy()
    w_bytes = 9 * BN * KC * 2
    stage_elems = (9 * BN + P * P) * KC
    warp = np.arange(8)
    wm, wn = warp & 3, warp >> 2
    lane = np.arange(32)
    a_off, b_off = _lane_offsets(wm[:4, None], wn[::4, None], lane[None], T, w_bytes)
    # weight units: row (tap, n), unit u; patch units: pixel, unit u
    wrow, wu = np.meshgrid(np.arange(9 * BN), np.arange(KC // 8), indexing="ij")
    pix, pu = np.meshgrid(np.arange(P * P), np.arange(KC // 8), indexing="ij")
    py, px = pix // P, pix % P
    tiles_y, tiles_x, nblk = -(-H // T), -(-W // T), Cout // BN
    out = np.zeros((B, H, W, Cout), np.float32)
    bias_np = bias.float().numpy()
    res_np = None if residual is None else residual.float().numpy()
    for block in range(B * tiles_y * tiles_x * nblk):
        tile, nb = divmod(block, nblk)
        bi, t = divmod(tile, tiles_y * tiles_x)
        y0, x0, n0 = (t // tiles_x) * T, (t % tiles_x) * T, nb * BN
        acc = np.zeros((4, 4, 16, 2, 64), np.float32)  # (wm, mt, row, wn, channel)
        for c0 in range(0, Cin, KC):
            kc = min(KC, Cin - c0)
            stage = np.full(stage_elems, np.nan, np.float32)
            on = wu * 8 < kc
            ch = c0 + wu[on, None] * 8 + np.arange(8)
            stage[_swz(wrow[on], wrow[on], wu[on])[:, None] // 2 + np.arange(8)] = \
                wk[wrow[on] // BN, n0 + wrow[on] % BN][np.arange(ch.shape[0])[:, None], ch]
            y, xx = y0 - 1 + py, x0 - 1 + px
            inside = (y >= 0) & (y < H) & (xx >= 0) & (xx < W)
            on = pu * 8 < kc
            vals = np.zeros(on.sum() * 8, np.float32).reshape(-1, 8)
            ins = inside[on]
            ch = c0 + pu[on][ins, None] * 8 + np.arange(8)
            vals[ins] = z[bi, y[on][ins], xx[on][ins]][np.arange(ch.shape[0])[:, None], ch]
            stage[(w_bytes + _swz(pix[on], px[on], pu[on]))[:, None] // 2 + np.arange(8)] = vals
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                for s in range(kc // 16):
                    mats = _ldmatrix_x4(stage, (tap * BN + 16 * np.arange(4)[None, :, None]) * 64
                                        + b_off[s][:, None])  # (wn, j, 4, 8 n, 8 k)
                    # n8 tile 2j: matrices 0 | 1 (k 0-7 | 8-15); tile 2j + 1: 2 | 3
                    bt = np.concatenate([np.concatenate([mats[:, :, 0], mats[:, :, 1]], -1),
                                         np.concatenate([mats[:, :, 2], mats[:, :, 3]], -1)],
                                        axis=2).reshape(2, 64, 16)  # (wn, n = 16j + row, k)
                    am = _ldmatrix_x4(stage, (np.arange(4)[None, :, None] + dy) * P * 64
                                      + a_off[dx][s][:, None])  # (wm, mt, 4, 8, 8)
                    # rows 0-7: matrices 0 | 2 (k 0-7 | 8-15); rows 8-15: 1 | 3
                    a = np.concatenate([np.concatenate([am[:, :, 0], am[:, :, 2]], -1),
                                        np.concatenate([am[:, :, 1], am[:, :, 3]], -1)],
                                       axis=2)  # (wm, mt, 16 rows, 16 k)
                    acc += np.einsum("wmrk,vnk->wmrvn", a, bt)
        if residual is not None:
            # the residual tile as load_residual stages it (256-byte pixel
            # rows, unit u at u ^ (x & 7)), read back as the epilogue reads it
            ty, tx = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
            inside = (y0 + ty < H) & (x0 + tx < W)
            tpix = (ty * T + tx)[inside]
            gx = (x0 + tx)[inside]
            res_stage = np.full(T * T * BN, np.nan, np.float32)
            for u in range(BN // 8):
                res_stage[(tpix * BN * 2 + ((u ^ (gx & 7)) << 4))[:, None] // 2 + np.arange(8)] = \
                    res_np[bi, (y0 + ty)[inside], gx, n0 + 8 * u:n0 + 8 * u + 8]
            c = np.arange(BN)
            read = res_stage[(ty * T + tx)[..., None] * BN + ((c >> 3) ^ ((x0 + tx)[..., None] & 7))
                             * 8 + (c & 7)]  # (tile row, tile col, channel)
        # the epilogue: fragment (wm, mt, row r, wn, channel) is pixel (tile
        # row 4wm + mt, column r); + bias [+ residual], rounded, written to
        # the output stage at the residual's swizzled offsets, and stored
        # from there unit by unit for the pixels inside the image
        tile = acc.reshape(T, T, BN) + bias_np[n0:n0 + BN]
        ty, tx = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
        c = np.arange(BN)
        if residual is not None:
            tile = tile + read
        tile = torch.from_numpy(np.ascontiguousarray(tile)).to(x.dtype).float().numpy()
        out_stage = np.full(T * T * BN, np.nan, np.float32)
        out_stage[(ty * T + tx)[..., None] * BN + ((c >> 3) ^ (tx[..., None] & 7)) * 8
                  + (c & 7)] = tile
        for u in range(BN // 8):
            keep = (y0 + ty < H) & (x0 + tx < W)
            src = (ty * T + tx)[keep] * BN + ((u ^ ((x0 + tx)[keep] & 7)) * 8)
            out[bi, (y0 + ty)[keep], (x0 + tx)[keep], n0 + 8 * u:n0 + 8 * u + 8] = \
                out_stage[src[:, None] + np.arange(8)]
    return torch.from_numpy(out).to(x.dtype)


# (B, H, W, Cin, Cout): chip_smoke.K2_ODD_SHAPES and the small cases of
# tests/test_torch_gpu.py `test_conv_kernel_matches_plain`: H and W off the
# 16 x 16 tile, one row, Cin with a short last chunk (48, 80) or only one
# (16), and Cout of 128, 256 and 512
EMULATED_SHAPES = list(chip_smoke.K2_ODD_SHAPES) + [
    (1, 16, 16, 16, 128), (1, 20, 35, 48, 256), (1, 5, 9, 80, 512), (2, 17, 16, 64, 128)]
VARIANTS = {"plain": (False, False), "affine_silu": (True, False), "residual": (False, True),
            "affine_silu_residual": (True, True)}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", EMULATED_SHAPES)
def test_kernel_emulation_matches_plain(shape, variant):
    """The bf16 kernel's tile map, halo, tap shifts, swizzled staging and
    fragment reads, chunk order (short last chunk included) and ragged masks
    (numpy) against the plain version, at `chip_smoke.k2_mismatch`'s bf16
    gate; a read of a unit the chunk did not stage would be NaN."""
    B, H, W, Cin, Cout = shape
    has_affine, has_res = VARIANTS[variant]
    x, kernel, bias, a, b, res = (torch.from_numpy(t) for t in
                                  _inputs(B, H, W, Cin, Cout, seed=sum(shape)))
    x, kernel = x.bfloat16(), kernel.bfloat16()
    kw = {}
    if has_affine:
        kw.update(affine=(a.bfloat16(), b.bfloat16()), act="silu")
    if has_res:
        kw["residual"] = res.bfloat16()
    out = emulate_bf16_kernel(x, kernel, bias, **kw)
    bad = chip_smoke.k2_mismatch(torch, out, ck.conv3x3_fused_plain(x, kernel, bias, **kw))
    assert bad is None, bad


def test_kernel_plan_fits_and_swizzle_is_conflict_free():
    """The plan read from the source: 8 warps of 4 x 2 (64 pixels x 64
    channels), two stages and the raw patch within the 227 KB a block may
    use, Cin chunks that are whole k16 steps; and every ldmatrix 8x8 matrix
    the lanes address, and every 8 consecutive threads' 16-byte stores, hit
    8 different 16-byte bank groups."""
    plan = _kernel_plan()
    T, BN, KC = plan["kTile"], plan["BN"], plan["KC"]
    assert plan["kThreads"] == 256 and T * T == 4 * 64 and BN == 2 * 64
    assert KC % ck.CIN_MULTIPLE == 0 and BN == ck.COUT_MULTIPLE
    P = T + 2
    stage = (9 * BN + P * P) * KC * 2
    assert 2 * stage + P * P * KC * 2 <= 232_448
    lane = np.arange(32)
    for wm in range(4):
        for wn in range(2):
            a_off, b_off = _lane_offsets(wm, wn, lane, T, 9 * BN * KC * 2)
            addrs = [o + (tap * BN + 16 * j) * 64 for o in b_off for tap in range(9)
                     for j in range(4)]
            addrs += [o + (mt + dy) * P * 64 for row in a_off for o in row for mt in range(4)
                      for dy in range(3)]
            for addr in addrs:
                groups = (addr.reshape(4, 8) // 16) % 8
                assert all(len(set(g)) == 8 for g in groups.tolist())
    # staging: thread idx writes unit idx & 3 of row (or pixel) idx >> 2
    idx = np.arange(8 * 9 * BN * KC // 8)
    rows, u = idx >> 2, idx & 3
    for addr in (_swz(rows, rows, u), _swz(rows, rows % P, u)):
        assert all(len(set(g)) == 8 for g in ((addr.reshape(-1, 8) // 16) % 8).tolist())
