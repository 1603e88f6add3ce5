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

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import k4_split
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
    mine = uk.kernel_weights(torch.from_numpy(k), torch.bfloat16, True).float().numpy()
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
        w = uk.kernel_weights(torch.from_numpy(k), torch.float32, upsample).numpy()
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


def test_packed_weights_are_checked():
    """`packed` must be the kernel layout of the weights in x's dtype on x's
    device (on the CPU it is checked and the plain version runs)."""
    x, k, b = (torch.from_numpy(t) for t in _inputs(1, 4, 5, 32, 32))
    for upsample in (True, False):
        packed = uk.kernel_weights(k, torch.float32, upsample)
        assert packed.is_contiguous()
        assert tuple(packed.shape) == ((4, 4, 32, 32) if upsample else (1, 9, 32, 32))
        torch.testing.assert_close(uk.upconv3x3(x, k, b, upsample=upsample, packed=packed),
                                   uk.upconv3x3_plain(x, k, b, upsample=upsample))
        with pytest.raises(ValueError, match="packed"):
            uk.upconv3x3(x, k, b, upsample=upsample, packed=packed.bfloat16())
        with pytest.raises(ValueError, match="packed"):
            uk.upconv3x3(x, k, b, upsample=not upsample, packed=packed)


# -- a numpy emulation of the bf16 CUDA kernel's index math ------------------
_SOURCE = (Path(__file__).resolve().parents[1] / "controlanimate_tpu_torch" / "csrc"
           / "upconv3x3.cu")


def _k4_plan() -> dict:
    """The bf16 kernel's constants, read from the CUDA source: the tile
    width, channels a step, threads, ring slots, pixels an epilogue round,
    the shared-memory limit, and the coarse tile rows of each mode."""
    src = _SOURCE.read_text()
    plan = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    th = re.search(r"int TH = kUp \? (\d+) : (\d+);", src)
    plan["TH_UP"], plan["TH_CONV"] = int(th.group(1)), int(th.group(2))
    return plan


def _swz(row, key, u):
    """The kernel's `swz`: byte offset of 16-byte unit u of a 64-byte staged
    row, the unit XORed with bits 1-2 of key."""
    return row * 64 + ((u ^ ((key >> 1) & 3)) << 4)


def _ost(sp, u, BN):
    """The kernel's `ost`: byte offset of unit u of output-stage pixel sp."""
    return sp * 128 + ((u ^ (sp & 7)) << 4) if BN == 64 else _swz(sp, sp, u)


def _ldmatrix_x4(smem, addr):
    """ldmatrix.x4 over byte addresses addr (..., 32): matrix i's row r is the
    8 bf16 at lane 8i + r's address. Returns (..., 4, 8, 8)."""
    rows = smem[(addr // 2)[..., None] + np.arange(8)]
    return rows.reshape(*addr.shape[:-1], 4, 8, 8)


def k4_smem_layout(Ci, upsample, BN, plan=None):
    """The block's shared memory as `Plan::smem` lays it out: (resident,
    ring offset, slot bytes, output-stage offset, total bytes)."""
    plan = plan or _k4_plan()
    TH = plan["TH_UP"] if upsample else plan["TH_CONV"]
    ntap = 16 if upsample else 9
    p_bytes = (TH + 2) * (plan["TW"] + 2) * plan["KC"] * 2
    w_chunk = ntap * BN * plan["KC"] * 2
    o_bytes = plan["kOutPix"] * BN * 2
    nck = Ci // plan["KC"]
    resident = nck * w_chunk + plan["kSlots"] * p_bytes + o_bytes <= plan["kSmemLimit"]
    ring = nck * w_chunk if resident else 0
    slot = p_bytes + (0 if resident else w_chunk)
    ostage = ring + plan["kSlots"] * slot
    return resident, ring, slot, ostage, ostage + o_bytes


K4_FAULTS = ("halo", "swizzle", "tap_row", "parity_col", "ring", "store_parity")


def emulate_bf16_kernel(x, weight, bias, *, upsample, act="lrelu", sm_slots=3, fault=None):
    """The bf16 kernel in numpy, index by index: the grid (persistent blocks
    over `sm_slots` block slots) and each block's walk over tiles gridDim.x
    apart; the resident weights (or a chunk's
    with its patch when they do not fit), the patch of each step written at
    its swizzled offsets into the ring slot the kernel uses, step s + 1
    issued before step s's products; each warp's A and B fragments read back
    by the kernel's ldmatrix lane addresses (six patch rows a column offset,
    every tap of the column on them, all four parities from one patch),
    multiplied in fp32; and the epilogue's + bias, leaky ReLU and one
    rounding through the output stage at its swizzled offsets, stored pixel
    by pixel in the fine layout, ragged pixels masked. Shared memory and the
    output start NaN, so a read of an unstaged byte or an unwritten output
    shows. `fault` injects one index fault of `K4_FAULTS`."""
    plan = _k4_plan()
    TW, KC = plan["TW"], plan["KC"]
    TH = plan["TH_UP"] if upsample else plan["TH_CONV"]
    PW = TW + 2
    B, H, W, Ci = x.shape
    Co = weight.shape[-1]
    BN = 64 if Co % 64 == 0 else 32
    NT8, ntap = BN // 16, (16 if upsample else 9)
    NP, NCOL, NROW = (2, 2, 4) if upsample else (1, 3, 3)
    nck = Ci // KC
    resident, ring, slot_bytes, ostage, total = k4_smem_layout(Ci, upsample, BN, plan)
    w_chunk, p_bytes = ntap * BN * KC * 2, (TH + 2) * PW * KC * 2
    xs = x.float().numpy()
    wk = uk.kernel_weights(weight, torch.bfloat16, upsample).float().numpy().reshape(ntap, Co, Ci)
    bias_np = bias.float().numpy()
    tiles_x, tiles_y = -(-W // TW), -(-H // TH)
    ntiles = B * tiles_x * tiles_y
    grid_x = max(1, min(ntiles, -(-sm_slots // (Co // BN))))
    scale = 2 if upsample else 1
    out = np.full((B, scale * H, scale * W, Co), np.nan, np.float32)

    warp, lane = np.arange(8)[:, None], np.arange(32)[None, :]
    wm, wn = warp & 3, warp >> 2
    q = (wm >> 1) if upsample else np.zeros_like(wm)
    q_col = np.zeros_like(q) if fault == "parity_col" else q
    rbase = 4 * (wm & 1) if upsample else 4 * wm
    # lane offsets: offA[j][s] and offB[s], (8 warps, 32 lanes)
    offA = [[None] * 2 for _ in range(NCOL)]
    offB = [None] * 2
    for s in range(2):
        bn = wn * (BN // 2) + (lane & 7) + ((lane >> 4) << 3)
        offB[s] = _swz(bn, bn, 2 * s + ((lane >> 3) & 1))
        for j in range(NCOL):
            col = (lane & 15) + (q_col if upsample else 0) + j
            key = col if fault != "swizzle" else np.zeros_like(col)
            offA[j][s] = _swz(rbase * PW + col, key, 2 * s + (lane >> 4))

    def tile_at(t):
        bi, r = divmod(t, tiles_x * tiles_y)
        return bi, (r // tiles_x) * TH, (r % tiles_x) * TW

    pix = np.arange((TH + 2) * PW)
    py, px = pix // PW, pix % PW
    wrow = np.arange(ntap * BN)

    for by in range(Co // BN):
        n0 = by * BN
        for bx in range(grid_x):
            t0, stride = bx, grid_x
            count = -(-(ntiles - t0) // stride)
            smem = np.full(total // 2, np.nan, np.float32)

            def load_weights(dst, c):
                for u in range(4):
                    vals = wk[wrow // BN, n0 + wrow % BN, c * KC + 8 * u:c * KC + 8 * u + 8]
                    smem[(dst + _swz(wrow, wrow, u))[:, None] // 2 + np.arange(8)] = vals

            def issue(s):
                t, c = t0 + (s // nck) * stride, s % nck
                slot = ring + ((s if fault != "ring" else s - 1) % plan["kSlots"]) * slot_bytes
                bi, y0, x0 = tile_at(t)
                shift = 0 if fault == "halo" else 1
                y, xx = y0 - shift + py, x0 - shift + px
                inside = (y >= 0) & (y < H) & (xx >= 0) & (xx < W)
                for u in range(4):
                    vals = np.zeros((len(pix), 8), np.float32)
                    vals[inside] = xs[bi, y[inside], xx[inside], c * KC + 8 * u:c * KC + 8 * u + 8]
                    smem[(slot + _swz(pix, px, u))[:, None] // 2 + np.arange(8)] = vals
                if not resident:
                    load_weights(slot + p_bytes, c)

            if resident:
                for c in range(nck):
                    load_weights(c * w_chunk, c)
            issue(0)
            acc = np.zeros((8, NP, 4, 16, BN // 2), np.float32)
            for s in range(count * nck):
                if s + 1 < count * nck:
                    issue(s + 1)
                c = s % nck
                slot = ring + (s % plan["kSlots"]) * slot_bytes
                wts = c * w_chunk if resident else slot + p_bytes
                for ks in range(KC // 16):
                    for j in range(NCOL):
                        am = _ldmatrix_x4(smem, slot + np.arange(6)[None, :, None] * PW * 64
                                          + offA[j][ks][:, None, :])  # (warp, row, 4, 8, 8)
                        # rows 0-7: matrices 0 | 2 (k 0-7 | 8-15); rows 8-15: 1 | 3
                        a = np.concatenate([np.concatenate([am[:, :, 0], am[:, :, 2]], -1),
                                            np.concatenate([am[:, :, 1], am[:, :, 3]], -1)],
                                           axis=2)  # (warp, patch row, 16 pixels, 16 k)
                        for t in range(NROW):
                            if upsample:
                                pr, aa = t >> 1, t & 1
                                dy = pr + aa if fault != "tap_row" else pr
                                tap = (2 * pr + q) * 4 + 2 * aa + j  # (warp, 1)
                            else:
                                pr, dy, tap = 0, t, np.full_like(q, 3 * t + j)
                            bm = _ldmatrix_x4(smem, wts + (tap[:, :, None] * BN + 16 * np.arange(
                                NT8 // 2)[None, :, None]) * 64 + offB[ks][:, None, :])
                            # n8 tile 2jj: matrices 0 | 1 (k 0-7 | 8-15); 2jj + 1: 2 | 3
                            b = np.concatenate([np.concatenate([bm[:, :, 0], bm[:, :, 1]], -1),
                                                np.concatenate([bm[:, :, 2], bm[:, :, 3]], -1)],
                                               axis=2).reshape(8, BN // 2, 16)
                            acc[:, pr] += np.einsum("wmrk,wnk->wmrn", a[:, dy:dy + 4], b)
                if c != nck - 1:
                    continue
                # the epilogue: fragment (warp, pr, mt, m16 row, channel) is
                # coarse row rbase + mt, column m16 row, channel wn*BN/2 + n
                bi, y0, x0 = tile_at(t0 + (s // nck) * stride)
                cc = (wn[:, :, None, None] * (BN // 2)
                      + np.arange(BN // 2)).reshape(8, 1, 1, BN // 2)
                sp = ((q * TH * TW * int(upsample))[:, :, None, None]
                      + (rbase[:, :, None, None] + np.arange(4)[None, :, None, None]) * TW
                      + np.arange(16)[None, None, :, None])  # (warp, mt, m, 1)
                for pr in range(NP):
                    v = acc[:, pr] + bias_np[n0 + cc[:, 0]][:, None]
                    if act == "lrelu":
                        v = np.where(v >= 0, v, v * np.float32(0.2))
                    v = torch.from_numpy(np.ascontiguousarray(v, np.float32)).bfloat16()
                    v = v.float().numpy()
                    spb, ccb = np.broadcast_arrays(sp, cc)
                    smem[(ostage + _ost(spb, ccb >> 3, BN)) // 2 + (ccb & 7)] = v
                    idx = np.arange(plan["kOutPix"] * (BN // 8))
                    p_, u = idx // (BN // 8), idx % (BN // 8)
                    if upsample:
                        r, fc = p_ >> 5, p_ & 31
                        qq = fc & 1 if fault != "store_parity" else 1 - (fc & 1)
                        spo = qq * TH * TW + r * TW + (fc >> 1)
                        y, xx = y0 + r, x0 + (fc >> 1)
                        oy, ox = 2 * y + pr, 2 * x0 + fc
                    else:
                        spo = p_
                        y, xx = y0 + (p_ >> 4), x0 + (p_ & 15)
                        oy, ox = y, xx
                    keep = (y < H) & (xx < W)
                    vals = smem[((ostage + _ost(spo, u, BN)) // 2)[:, None] + np.arange(8)]
                    out[bi, oy[keep, None], ox[keep, None],
                        n0 + 8 * u[keep, None] + np.arange(8)] = vals[keep]
                acc[:] = 0.0
    return torch.from_numpy(out).bfloat16()


# (B, H, W, Ci, Co): chip_smoke.K4_ODD_SHAPES (H and W off the tiles, one
# row, Ci = Co = 32, Ci = 128 with the weights streamed with each patch) and two
# more: Co = 32 with Ci = 64 (BN = 32, two chunks), and a batch of 2 whose
# tiles a block walks across images
EMULATED_K4 = list(chip_smoke.K4_ODD_SHAPES) + [(1, 5, 20, 64, 32), (2, 7, 18, 32, 64)]


@pytest.mark.parametrize("sm_slots", [3, 1], ids=["3_slots", "1_slot"])
@pytest.mark.parametrize("upsample", [True, False], ids=["upsample", "conv"])
@pytest.mark.parametrize("shape", EMULATED_K4, ids=str)
def test_kernel_emulation_matches_plain(shape, upsample, sm_slots):
    """The bf16 kernel's grid, tile walk, ring slots, swizzled staging,
    per-tap ldmatrix addresses, four parities from one patch and the
    output stage's fine-layout stores (numpy) against the plain version, at
    `chip_smoke.k4_mismatch`'s bf16 gate: with 3 block slots (blocks walk
    tiles 3 apart) and with one (a single block walks every tile, its ring
    slots turning over across tiles and images)."""
    B, H, W, Ci, Co = shape
    x, k, b = _inputs(*shape, seed=sum(shape))
    x = torch.from_numpy(x).bfloat16()
    k, b = torch.from_numpy(k), torch.from_numpy(b)
    out = emulate_bf16_kernel(x, k, b, upsample=upsample, sm_slots=sm_slots)
    ref = uk.upconv3x3_plain(x, k, b, upsample=upsample, act="lrelu")
    bad = chip_smoke.k4_mismatch(torch, out, ref)
    assert bad is None, bad


@pytest.mark.parametrize("fault", K4_FAULTS)
def test_kernel_emulation_fails_on_index_faults(fault):
    """Each index fault of the emulation (the patch origin without its halo,
    reads without the swizzle, the upsample tap's row without a, the parity
    column without q, a step issued into the slot of the step before it, the
    stored fine columns with their parities swapped) fails the gate that
    the faithful emulation passes, in the mode where the fault applies."""
    shape = (2, 9, 37, 64, 64)
    x, k, b = _inputs(*shape, seed=1)
    x = torch.from_numpy(x).bfloat16()
    k, b = torch.from_numpy(k), torch.from_numpy(b)
    ref = uk.upconv3x3_plain(x, k, b, upsample=True, act="lrelu")
    out = emulate_bf16_kernel(x, k, b, upsample=True, fault=fault)
    assert chip_smoke.k4_mismatch(torch, out, ref) is not None
    if fault in ("halo", "swizzle", "ring"):
        ref = uk.upconv3x3_plain(x, k, b, upsample=False, act="lrelu")
        out = emulate_bf16_kernel(x, k, b, upsample=False, fault=fault)
        assert chip_smoke.k4_mismatch(torch, out, ref) is not None


def test_kernel_plan_fits_and_swizzle_is_conflict_free():
    """The plan read from the source: 8 warps; at the tail's 64 -> 64 the
    folded weights (131 KB upsample, 73.7 KB conv), the two-slot ring and
    the output stage fit the 227 KB a block may use with the weights
    resident, and Ci = 128 in the upsample mode streams them; every ldmatrix
    8x8 matrix the lanes address, every 8 consecutive 16-byte copies, and
    the 8 pixels of every epilogue fragment write hit 8 different 16-byte
    bank groups."""
    plan = _k4_plan()
    assert plan["kThreads"] == 256 and plan["kSlots"] == 2 and plan["KC"] == uk.CHANNEL_MULTIPLE
    assert plan["TH_UP"] * plan["TW"] * 2 == plan["kOutPix"] == plan["TH_CONV"] * plan["TW"]
    up = k4_smem_layout(64, True, 64, plan)
    conv = k4_smem_layout(64, False, 64, plan)
    assert up[0] and conv[0] and up[4] <= plan["kSmemLimit"] and conv[4] <= plan["kSmemLimit"]
    assert up[1] == 16 * 64 * 64 * 2 == 131_072 and conv[1] == 9 * 64 * 64 * 2 == 73_728
    assert not k4_smem_layout(128, True, 64, plan)[0] and k4_smem_layout(128, False, 64, plan)[0]
    assert k4_smem_layout(1024, True, 64, plan)[4] <= plan["kSmemLimit"]
    lane = np.arange(32)
    for upsample, TH in ((True, plan["TH_UP"]), (False, plan["TH_CONV"])):
        PW = plan["TW"] + 2
        for BN in (32, 64):
            for wm in range(4):
                q = wm >> 1 if upsample else 0
                rbase = 4 * (wm & 1) if upsample else 4 * wm
                for s in range(2):
                    for j in range(2 if upsample else 3):
                        col = (lane & 15) + q + j
                        for i in range(6):
                            addr = _swz((rbase + i) * PW + col, col, 2 * s + (lane >> 4))
                            groups = (addr.reshape(4, 8) // 16) % 8
                            assert all(len(set(g)) == 8 for g in groups.tolist())
                    for wn in range(2):
                        bn = wn * (BN // 2) + (lane & 7) + ((lane >> 4) << 3)
                        for tap in range(16 if upsample else 9):
                            addr = _swz(tap * BN + bn, bn, 2 * s + ((lane >> 3) & 1))
                            groups = (addr.reshape(4, 8) // 16) % 8
                            assert all(len(set(g)) == 8 for g in groups.tolist())
                # epilogue writes: lanes g = 0..7 write pixels sp0 + g, one unit
                for mt in range(4):
                    sp = (q * TH * plan["TW"] if upsample else 0) + (rbase + mt) * 16 + np.arange(8)
                    for u in range(BN // 8):
                        banks = (_ost(sp, u, BN) // 16) % 8
                        assert len(set(banks.tolist())) == 8
            # staging: 8 consecutive threads copy 8 consecutive units
            idx = np.arange(8 * (TH + 2) * PW * 4)
            pix = idx >> 2
            for addr in (_swz(pix, pix % PW, idx & 3), _swz(pix, pix, idx & 3)):
                assert all(len(set(g)) == 8 for g in ((addr.reshape(-1, 8) // 16) % 8).tolist())


@pytest.mark.parametrize("variant", list(k4_split.VARIANTS))
def test_split_probe_edits_apply_to_the_source(variant):
    """`k4_split.py` builds its variants by exact edits of the CUDA source;
    each edit finds its text once, so the probe times the kernel as it is."""
    src = k4_split.variant_source(k4_split.VARIANTS[variant])
    assert (src == _SOURCE.read_text()) == (variant == "all")
