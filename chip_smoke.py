#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

Phases, each printed as one JSON line with its seconds:
  device     the card's name, count and power limit; no card is an error.
  build      one nvcc call builds the CUDA kernels (K1 flash attention, K2
             fused GroupNorm -> SiLU -> conv3x3, K3 fused motion module, K4
             nearest-2x + conv3x3 + leaky ReLU); prints its time and nvcc's
             register / spill report, K2's, K3's and K4's each on a line of
             its own.
  reference  a small pipeline (head dims 40/80/512, fp32) on the card against
             the same pipeline on the CPU with the same weights and noise:
             uint8 frames within 1 LSB; then the same with
             `use_pallas_conv` and 128-channel VAE levels, so that K2 runs
             on the card, and once more with CONTROLANIMATE_PALLAS_MOTION=1,
             so that K3 runs on the card (K2's and K3's launches are counted
             and must be nonzero); then a small fp32 RealESRGAN `Upscaler`
             (64 features, 1 block, 2 frames of 64x64) on the card against
             the same on the CPU, at scale 4 and at scale 2 (the x4 network
             then Lanczos4): uint8 within 1 LSB, K4's launches nonzero.
  window     the native-LCM window at full SD1.5 width through the facade
             (512x512, 16 frames, 4 LCM steps, no CFG, strength 0.9), random
             bf16 weights made on the card from a seed. One warm-up window,
             WINDOWS windows without overlap (frames/s as bench.py counts it:
             16 frames a window), then WINDOWS windows of the overlap-8 stream
             (8 new frames a window, overlap latents reused). K1's launches
             are counted per shape over the phase and must equal what the
             UNet and VAE imply.
  window_plain_attention
             the overlap-8 windows again with the plain attention on the
             same inputs (time and uint8 difference reported, not gated).
  window_motion_kernel
             the overlap-8 windows again on the same models and inputs, from
             a pipeline built with CONTROLANIMATE_PALLAS_MOTION=1, so that
             the UNet's 21 motion modules run on K3 (after one warm-up
             window): seconds, new frames/s, peak memory, and the uint8
             difference against the K3-off windows (reported, not gated).
             K3's launches by shape must equal what the UNet implies (84 a
             window).
  vid2vid    the main path: the port's `vid2vid` loop at full width, the
             same models, 512x512, 16-frame windows with overlap 8, 4 LCM
             steps, strength 0.9, bf16, `use_pallas_conv` on: seeded
             synthetic frames with motion for one whole window and
             V2V_OVERLAP_WINDOWS overlap windows, from an ArrayFrameSource to
             an ArrayFrameSink. Checks the frames written, their shape and
             dtype, that the stitch's color match changed window 2 onwards,
             and K1's and K2's launches by shape against what the UNet and
             the VAE imply. Prints new frames/s (frames written / loop
             seconds, the first window included), the loop's phase timers
             and peak memory.
  vid2vid_plain_conv
             the same loop with `use_pallas_conv` off (time and uint8
             difference reported, not gated).
  vid2vid_upscale
             this slice's path: the same loop (K2 off) with `upscale` 4 and
             a full-width RealESRGAN x4 RRDBNet (64 features, 6 blocks,
             random weights seeded on the card, run in bf16), its tail on K4.
             Checks 40 frames of (2048, 2048, 3) uint8 written and K4's
             launches by shape against what the upscaler's chunking implies
             (3 a chunk); prints new frames/s, peak memory, the loop's
             timers, the device time of one emit's upscale and of its RRDB
             body (CUDA events), the share of output values at 0 or 255,
             and the uint8
             difference against the same upscaler applied on the card to the
             vid2vid_plain_conv phase's frames (reported, not gated).
  kernels    K1 against its plain version at every shape the window phase
             launched it with, plus odd lengths, in bf16 and fp32
             (`k1_mismatch` states the gates); K2 against its plain version
             at every shape the vid2vid phase launched it with, plus odd
             H and W, each with and without the affine + SiLU + residual, in
             bf16 and fp32 (`k2_mismatch`). Then each kernel's time, its
             plain version's, one PyTorch call's (SDPA for K1, `F.conv2d` on
             the activated input for K2: yardsticks the port never calls)
             and the bound.
  kernels_k3 K3 against its plain version at every shape the
             window_motion_kernel phase launched it with, plus odd shapes
             (N = 37, F = 8 and 24, PE off, C = 64), in bf16 and fp32
             (`k3_mismatch` states the gates); then K3's time, its plain
             version's, the port's dense `TemporalTransformer3D`'s in bf16
             (the stock PyTorch path K3 replaces, as the yardstick) and the
             bound.
  kernels_k4 K4 against its plain version at every shape vid2vid_upscale
             launched it with (bf16 as launched, fp32 at batch 1), plus odd
             shapes in both modes (H and W off the 8 x 16 tile, H = 1,
             Ci = Co = 32, B = 3), in bf16 and fp32 (`k4_mismatch` states the
             gates); then K4's time, its plain version's, one PyTorch call's
             (nearest-2x + `F.conv2d` + leaky ReLU in bf16, channels_last; a
             yardstick the port never calls), the bound over the useful work
             and the folded GEMM's work beside it.
Then the kernels line, the `nvidia-smi` name/power-limit line, and last the
`{"ok": true, "device": ...}` line. Any failure ends the run non-zero.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3

# K1 launches of one SD1.5 UNet forward on a 512x512, 16-frame window, by
# (B*F, Nq, Nk, H, D): the spatial self-attention of the 16 transformer blocks
# (5 at each of the 64x64, 32x32 and 16x16 levels, 1 in the 8x8 mid block)
UNET_SHAPES = {
    (16, 4096, 4096, 8, 40): 5,
    (16, 1024, 1024, 8, 80): 5,
    (16, 256, 256, 8, 160): 5,
    (16, 64, 64, 8, 160): 1,
}
ODD_SHAPES = [(2, 77, 77, 8, 40), (3, 333, 333, 2, 80), (1, 129, 129, 8, 160),
              (2, 77, 77, 1, 512)]
# odd K2 shapes (B, H, W, Cin, Cout): W not a multiple of the 16-pixel tile,
# H = 7, and H = 1 with W = 16
K2_ODD_SHAPES = [(2, 9, 37, 128, 128), (1, 7, 21, 256, 128), (2, 1, 16, 128, 256)]
# odd K3 shapes (B, F, N, C, heads, positional encoding): N not a multiple of
# the 128-row tile, 8 and 24 frames, PE off, and C = 64 (head dim 8)
K3_ODD_SHAPES = [(1, 16, 37, 320, 8, True), (1, 8, 64, 640, 8, True), (1, 24, 64, 320, 8, True),
                 (1, 16, 64, 1280, 8, False), (2, 16, 50, 64, 8, True)]
# odd K4 shapes (B, H, W, Ci, Co), each in both modes: H and W not multiples
# of the 8 x 16 tile, H = 1, Ci = Co = 32 (the 32-channel block), and B = 3
K4_ODD_SHAPES = [(2, 9, 37, 64, 64), (1, 1, 16, 64, 64), (1, 13, 21, 32, 32), (3, 8, 16, 64, 64)]
# conv_last's weight scale in the seeded RRDBNet (its bias is 0.5): keeps most
# uint8 outputs of the 6-block network off 0 and 255
RRDB_LAST_GAIN = 0.3
WINDOWS = 4  # timed windows of each kind
V2V_OVERLAP_WINDOWS = 3  # overlap windows after the vid2vid phase's first window
SEED = 7


def phase(name: str, t0: float, **fields) -> None:
    print(json.dumps({"phase": name, "seconds": round(time.perf_counter() - t0, 3), **fields}),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_report(log: str) -> list[dict]:
    """Registers, spills and shared memory per compiled kernel from -Xptxas -v."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = {"function": m.group(1)}
            rows.append(current)
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            current["spill_stores"], current["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            current["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            current["static_smem"] = int(m2.group(1)) if m2 else 0
    return rows


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean time of one call, by CUDA events over `iters` calls after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) times of softmax(QK^T)V on the card, in ms: FLOPs
    at the bf16 tensor rate, and each input read and the output written once
    at the memory rate. The bound is the larger."""
    B, Nq, Nk, H, D = shape
    flops = 4.0 * B * H * Nq * Nk * D
    nbytes = 2.0 * B * (Nq + Nk) * H * D * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def k1_mismatch(torch, out, ref) -> str | None:
    """K1's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: the JAX bf16 gate (atol = rtol = 3e-2), and also
    |out - ref| <= 1e-2 * (|ref| + rms(ref)), because outputs at the main
    path's lengths are about 0.03, so the first gate alone passes nearly
    anything. Both sides round one fp32 value to bf16, so a right kernel
    differs from the plain version by at most one bf16 ulp (< 2**-7 |ref|)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    tol = 3e-2 if bf16 else 1e-4
    if not torch.allclose(out, ref, atol=tol, rtol=tol):
        return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = {tol}"
    if bf16:
        rms = ref.square().mean().sqrt()
        excess = ((out - ref).abs() - 1e-2 * (ref.abs() + rms)).max().item()
        if excess > 0:
            return f"bf16 error exceeds 1e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


def check_kernel(torch, fa, shape, dtype, gen) -> float:
    """K1 at (B, Nq, Nk, H, D) against its plain version; max abs error."""
    B, Nq, Nk, H, D = shape
    q = torch.randn((B, Nq, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, Nk, H, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_plain(q, k, v)
    bad = k1_mismatch(torch, out, ref)
    if bad:
        raise AssertionError(f"K1 {shape} {dtype}: {bad}")
    return (out.float() - ref.float()).abs().max().item()


def conv_bound_ms(shape, itemsize: int, residual: bool) -> tuple[float, float]:
    """(operations, bytes) times of one K2 call in ms: 2*9*B*H*W*Cin*Cout
    FLOPs at the bf16 tensor rate; x, the weights and the residual read once
    and the output written once at the memory rate."""
    B, H, W, Cin, Cout = shape
    flops = 2.0 * 9 * B * H * W * Cin * Cout
    nbytes = (B * H * W * (Cin + Cout + (Cout if residual else 0)) + 9 * Cin * Cout) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def k2_mismatch(torch, out, ref) -> str | None:
    """K2's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: |out - ref| <= 1e-2 * (|ref| + rms(ref)). Both sides
    convolve the same bf16-rounded operands in fp32 and round once, so a
    right kernel differs by the summation order and then at most one bf16
    ulp (< 2**-7 |ref|)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        return f"shape {tuple(out.shape)} against {tuple(ref.shape)}"
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    if not bf16:
        if not torch.allclose(out, ref, atol=1e-4, rtol=1e-4):
            return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = 1e-4"
        return None
    rms = ref.square().mean().sqrt()
    excess = ((out - ref).abs() - 1e-2 * (ref.abs() + rms)).max().item()
    if excess > 0:
        return f"bf16 error exceeds 1e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


def k2_inputs(torch, shape, dtype, gen):
    """Seeded K2 operands at (B, H, W, Cin, Cout): x, HWIO weights, bias,
    the folded affine (a, b) and a residual."""
    B, H, W, Cin, Cout = shape
    x = torch.randn((B, H, W, Cin), generator=gen, device="cuda").to(dtype)
    w = (torch.randn((3, 3, Cin, Cout), generator=gen, device="cuda")
         / math.sqrt(9 * Cin)).to(dtype)
    bias = 0.1 * torch.randn((Cout,), generator=gen, device="cuda")
    a = (1.0 + 0.1 * torch.randn((B, Cin), generator=gen, device="cuda")).to(dtype)
    b = (0.1 * torch.randn((B, Cin), generator=gen, device="cuda")).to(dtype)
    res = torch.randn((B, H, W, Cout), generator=gen, device="cuda").to(dtype)
    return x, w, bias, (a, b), res


def check_k2(torch, ck, shape, dtype, gen) -> float:
    """K2 at (B, H, W, Cin, Cout) against its plain version, plain and with
    affine + SiLU + residual; max abs error."""
    x, w, bias, affine, res = k2_inputs(torch, shape, dtype, gen)
    err = 0.0
    for kw in ({}, {"affine": affine, "act": "silu", "residual": res}):
        out = ck.conv3x3_fused(x, w, bias, **kw)
        ref = ck.conv3x3_fused_plain(x, w, bias, **kw)
        bad = k2_mismatch(torch, out, ref)
        if bad:
            raise AssertionError(f"K2 {shape} {dtype} {sorted(kw)}: {bad}")
        err = max(err, (out.float() - ref.float()).abs().max().item())
    return err


def motion_bound_ms(shape, itemsize: int) -> tuple[float, float]:
    """(operations, bytes) times of one K3 call in ms, T = B*F*N tokens:
    T*(44 C^2 + 8 F C) FLOPs (the seven GEMMs and the frame attention) at the
    bf16 tensor rate; x read and the delta written once, and the 22 C^2
    weights read once, at the memory rate."""
    B, F, N, C = shape[:4]
    T = B * F * N
    flops = T * (44.0 * C * C + 8.0 * F * C)
    nbytes = (2.0 * T * C + 22.0 * C * C) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES


def k3_mismatch(torch, out, ref) -> str | None:
    """K3's gates on `out` against the plain version's `ref` (same dtype);
    None when it passes. fp32: atol = rtol = 1e-4 (TF32 off in the plain
    version). bf16: |out - ref| <= 5e-2 * (|ref| + rms(ref)). Both sides round
    the same fp32 values to bf16 at the same dozen places but sum in other
    orders, so intermediates (h, q, k, a LayerNorm term, a probability) round
    one bf16 ulp the other way here and there, and the seven GEMMs carry that
    on. The bound is set by the function, not by the kernel: the plain
    version against itself with fp64 sums reaches 1.9-2.5e-2 (|ref| +
    rms(ref)) at the main-path widths (tests/test_torch_motion_kernel.py
    `test_bf16_gate_admits_another_summation_order`); 5e-2 is twice that. A
    wrong index, head, bias, PE row or residual moves outputs by O(rms)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if out.shape != ref.shape:
        return f"shape {tuple(out.shape)} against {tuple(ref.shape)}"
    if not bool(torch.isfinite(out).all()):
        return "non-finite output"
    if not bf16:
        if not torch.allclose(out, ref, atol=1e-4, rtol=1e-4):
            return f"max abs err {(out - ref).abs().max().item()} over atol = rtol = 1e-4"
        return None
    rms = ref.square().mean().sqrt()
    excess = ((out - ref).abs() - 5e-2 * (ref.abs() + rms)).max().item()
    if excess > 0:
        return f"bf16 error exceeds 5e-2 * (|ref| + rms(ref) = {rms.item()}) by {excess}"
    return None


def k3_module(torch, C: int, heads: int, use_pe: bool, gen):
    """A port `TemporalTransformer3D` of width C on the card in fp32, with
    seeded weights rounded to bf16 values (so that its bf16 copy holds the
    same weights): lecun-normal matrices (proj_out too, so the delta is not
    0), biases and norm shifts N(0, 0.1^2), norm scales 1 + N(0, 0.1^2); 32
    GroupNorm groups, or as many as divide C."""
    from controlanimate_tpu_torch.models.motion_module import TemporalTransformer3D

    mod = TemporalTransformer3D(C, heads, 1, ("Temporal_Self", "Temporal_Self"), 32, use_pe,
                                math.gcd(C, 32)).to("cuda")
    with torch.no_grad():
        for name, p in mod.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=gen)
            elif name.endswith("bias"):
                p.normal_(0.0, 0.1, generator=gen)
            else:
                p.normal_(1.0, 0.1, generator=gen)
            p.copy_(p.to(torch.bfloat16))
    return mod.eval()


def k3_inputs(torch, shape, gen):
    """(fp32 module, fp32 x) for K3 at (B, F, N, C, heads, use_pe), x ~ N(0, 1)
    rounded to bf16 values like the weights."""
    B, F, N, C, heads, use_pe = shape
    mod = k3_module(torch, C, heads, use_pe, gen)
    x = torch.randn((B, F, N, C), generator=gen, device="cuda").to(torch.bfloat16).float()
    return mod, x


def check_k3(torch, mk, shape, gen) -> dict:
    """K3 at (B, F, N, C, heads, use_pe) against its plain version, in fp32
    and in bf16 on the same weights and input; the max abs errors, and the
    bf16 kernel's and the bf16 plain version's max abs error against the fp32
    plain version (how far each is from the function in fp32)."""
    import copy

    mod32, x32 = k3_inputs(torch, shape, gen)
    heads = shape[4]
    outs = {}
    with torch.no_grad():
        for mod, x in ((mod32, x32), (copy.deepcopy(mod32).to(torch.bfloat16), x32.bfloat16())):
            p, pe = mod.fused_operands(x)
            out = mk.motion_module_fused(x, p, heads=heads, pe=pe)
            ref = mk.motion_module_plain(x, p, heads=heads, pe=pe)
            bad = k3_mismatch(torch, out, ref)
            if bad:
                raise AssertionError(f"K3 {shape} {x.dtype}: {bad}")
            outs[x.dtype] = (out.float(), ref.float())
    (out32, ref32), (out16, ref16) = outs[torch.float32], outs[torch.bfloat16]
    return {"max_abs_err_bf16": (out16 - ref16).abs().max().item(),
            "max_abs_err_fp32": (out32 - ref32).abs().max().item(),
            "bf16_kernel_vs_fp32": (out16 - ref32).abs().max().item(),
            "bf16_plain_vs_fp32": (ref16 - ref32).abs().max().item()}


def upconv_bound_ms(shape, upsample: bool, itemsize: int) -> tuple[float, float, float]:
    """(operations, bytes) times of one K4 call in ms, and the folded GEMM's
    GFLOP: the useful work, 2*4*Ci*Co FLOPs a fine output pixel (upsample)
    or 2*9*Ci*Co an output pixel (conv), at the bf16 tensor rate; x and the
    HWIO weights read once and the output written once at the memory rate.
    The TPU kernel's dense fold multiplies 2*9*Ci*4*Co a coarse pixel."""
    B, H, W, Ci, Co = shape
    px = B * H * W
    out_px = 4 * px if upsample else px
    flops = 2.0 * (4 if upsample else 9) * Ci * Co * out_px
    folded = 2.0 * 9 * Ci * (4 if upsample else 1) * Co * px
    nbytes = (B * H * W * Ci + out_px * Co + 9 * Ci * Co) * itemsize
    return 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * nbytes / PEAK_BYTES, folded / 1e9


def k4_mismatch(torch, out, ref) -> str | None:
    """K4's gates, K2's (`k2_mismatch`): fp32 at atol = rtol = 1e-4 (TF32 off
    in the plain version); bf16 within 1e-2 (|ref| + rms(ref)). Both sides
    fold the weights in fp32 and round them once, sum the same bf16 products
    in fp32 and round the result once, so a right kernel differs by the
    summation order and then at most one bf16 ulp (< 2**-7 |ref|)."""
    return k2_mismatch(torch, out, ref)


def k4_inputs(torch, shape, dtype, gen):
    """Seeded K4 operands at (B, H, W, Ci, Co): x in `dtype`, fp32 HWIO
    weights (the wrapper rounds them, folded or not) and bias."""
    B, H, W, Ci, Co = shape
    x = torch.randn((B, H, W, Ci), generator=gen, device="cuda").to(dtype)
    w = torch.randn((3, 3, Ci, Co), generator=gen, device="cuda") / math.sqrt(9 * Ci)
    bias = 0.1 * torch.randn((Co,), generator=gen, device="cuda")
    return x, w, bias


def check_k4(torch, uk, shape, upsample: bool, dtype, gen) -> float:
    """K4 at (B, H, W, Ci, Co) in one mode, with leaky ReLU, against its
    plain version; max abs error."""
    x, w, bias = k4_inputs(torch, shape, dtype, gen)
    out = uk.upconv3x3(x, w, bias, upsample=upsample, act="lrelu")
    ref = uk.upconv3x3_plain(x, w, bias, upsample=upsample, act="lrelu")
    bad = k4_mismatch(torch, out, ref)
    if bad:
        raise AssertionError(f"K4 {shape} upsample={upsample} {dtype}: {bad}")
    return (out.float() - ref.float()).abs().max().item()


def init_rrdbnet_(torch, net, gen, last_gain: float) -> None:
    """Seeded weights for an RRDBNet on its device: `init_weights_`, then
    conv_last's weight times `last_gain` and its bias 0.5, so the [0, 1]
    output sits mostly inside the uint8 range."""
    init_weights_(torch, net, gen)
    with torch.no_grad():
        net.conv_last.weight.mul_(last_gain)
        net.conv_last.bias.fill_(0.5)


def small_upscaler_reference(torch, scale: float) -> dict:
    """A small fp32 Upscaler (64 features, 1 block; 2 frames of 64x64) on
    the CPU and on the card with the same weights: uint8 frames must agree
    within 1 LSB. Its x4 tail runs on K4 on the card; at a scale other than
    4 the Lanczos4 resize follows."""
    import copy

    import numpy as np

    from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler

    net = RRDBNet(num_feat=64, num_block=1)
    init_rrdbnet_(torch, net, torch.Generator().manual_seed(SEED), 1.0)
    frames = synthetic_video(np, 2, 64, SEED)
    out_cpu = Upscaler(scale, model=net, dtype=torch.float32, device="cpu").upscale_batch(frames)
    gpu = Upscaler(scale, model=copy.deepcopy(net), dtype=torch.float32, device="cuda")
    out_gpu = gpu.upscale_batch(frames)
    if out_gpu.shape != out_cpu.shape or out_gpu.shape[1] != int(64 * scale):
        raise AssertionError(f"upscaler output {out_gpu.shape} against {out_cpu.shape}")
    diff = np.abs(out_cpu.astype(np.int16) - out_gpu.astype(np.int16))
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.mean())}


def expected_k4_launches(upscaler, emits: list[int], size: int) -> dict:
    """K4 launches by (B, H, W, Ci, Co, upsample) for emits of `emits`
    frames of size x size: each chunk of the upscaler's runs up1 and up2
    (upsample) and conv_hr (conv)."""
    from collections import Counter

    nf = upscaler.model.conv_hr.out_channels
    out = Counter()
    for n in emits:
        for c in upscaler.chunk_sizes(n, size, size):
            out[(c, size, size, nf, nf, True)] += 1
            out[(c, 2 * size, 2 * size, nf, nf, True)] += 1
            out[(c, 4 * size, 4 * size, nf, nf, False)] += 1
    return dict(out)


def unet_k3_calls(unet, latent: int):
    """The K3 calls of one UNet forward on latent x latent maps, read off the
    module tree: a Counter of (N, C, heads) over the motion modules K3 takes."""
    from collections import Counter

    calls, hw = Counter(), latent

    def add(blk):
        for m in getattr(blk, "motion_modules", ()):
            if m.fusable:
                calls[(hw * hw, m.channels, m.heads)] += 1

    for blk in unet.down_blocks:
        add(blk)
        if hasattr(blk, "downsamplers"):
            hw //= 2
    add(unet.mid_block)
    for blk in unet.up_blocks:
        add(blk)
        if hasattr(blk, "upsamplers"):
            hw *= 2
    return calls


def expected_k3_launches(unet, latent: int, frames_n: int, steps: int, windows: int) -> dict:
    """K3 launches by (B, F, N, C, heads) over `windows` windows of `steps`
    UNet forwards each (batch 1: no CFG)."""
    return {(1, frames_n, n, c, h): k * steps * windows
            for (n, c, h), k in unet_k3_calls(unet, latent).items()}


@contextmanager
def motion_env(on: bool):
    """CONTROLANIMATE_PALLAS_MOTION, which the facade reads when a pipeline
    is built, set to 1 or 0 for the pipelines built inside, restored after."""
    from controlanimate_tpu_torch.pipelines.facade import MOTION_ENV

    old = os.environ.get(MOTION_ENV)
    os.environ[MOTION_ENV] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(MOTION_ENV)
        else:
            os.environ[MOTION_ENV] = old


def vae_k2_calls(vae, size: int) -> tuple:
    """The K2 calls of one VAE encode and one decode of a size x size image,
    read off the module tree: Counters of (H, W, Cin, Cout, affine, residual),
    each resnet giving conv1 (affine + SiLU) and conv2 (affine + SiLU +
    residual), each Upsample2D one call on the 2x map (no affine, no SiLU)."""
    from collections import Counter

    from controlanimate_tpu_torch.ops import conv_kernel as ck

    def resnets(blocks_and_hw):
        calls = Counter()
        for resnet, hw in blocks_and_hw:
            for conv, res in ((resnet.conv1, False), (resnet.conv2, True)):
                if ck.supported(hw, hw, conv.in_channels, conv.out_channels):
                    calls[(hw, hw, conv.in_channels, conv.out_channels, True, res)] += 1
        return calls

    enc, hw, seen = vae.encoder, size, []
    for blk in enc.down_blocks:
        seen += [(r, hw) for r in blk.resnets]
        if hasattr(blk, "downsamplers"):
            hw //= 2
    seen += [(r, hw) for r in enc.mid_block.resnets]
    encode = resnets(seen)

    dec, hw = vae.decoder, size // 8
    seen, ups = [(r, hw) for r in dec.mid_block.resnets], Counter()
    for blk in dec.up_blocks:
        seen += [(r, hw) for r in blk.resnets]
        if hasattr(blk, "upsamplers"):
            hw *= 2
            c = blk.upsamplers[0].conv
            ups[(hw, hw, c.in_channels, c.out_channels, False, False)] += 1
    return encode, resnets(seen) + ups


def expected_k2_launches(vae, size, frames_n, overlap, full_windows, overlap_windows) -> dict:
    """K2 launches by (B, H, W, Cin, Cout, affine, residual) for windows of
    `frames_n` frames: every window decodes all frames; a whole window
    encodes all, an overlap window only its new frames."""
    from collections import Counter

    encode, decode = vae_k2_calls(vae, size)
    out = Counter()
    for key, n in decode.items():
        out[(frames_n,) + key] += n * (full_windows + overlap_windows)
    for key, n in encode.items():
        out[(frames_n,) + key] += n * full_windows
        if overlap_windows:
            out[(frames_n - overlap,) + key] += n * overlap_windows
    return dict(out)


def synthetic_video(np, n: int, size: int, seed: int):
    """n seeded (size, size, 3) uint8 frames of moving gradients and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    frames = np.empty((n, size, size, 3), np.uint8)
    for i in range(n):
        base = np.stack([128 + 90 * np.sin((xx + 6 * i) / 37.0), 40 + 0.3 * yy + 2 * i,
                         128 + 80 * np.cos((xx + yy - 4 * i) / 53.0)], axis=-1)
        frames[i] = np.clip(base + rng.randn(size, size, 3) * 8, 0, 255)
    return frames


def init_weights_(torch, module, gen) -> None:
    """Seeded lecun-normal weights, zero biases, unit norm scales, in place on
    the module's device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.normal_(0.0, 1.0 / math.sqrt(p[0].numel()), generator=gen)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)


class HostNoise:
    """The default noise drawn on the CPU and moved to `device`, so a CPU and
    a CUDA run see the same numbers."""

    def __init__(self, seed: int, device):
        from controlanimate_tpu_torch.pipelines.engine import TorchNoise

        self.src, self.device = TorchNoise(seed, "cpu"), device

    def initial(self, shape):
        return self.src.initial(shape).to(self.device)

    def encode(self, shape):
        return self.src.encode(shape).to(self.device)

    def last_output(self, shape):
        return self.src.last_output(shape).to(self.device)

    def step(self, i, shape):
        return self.src.step(i, shape).to(self.device)


def build_models(torch, unet_cfg, vae_channels, clip_cfg, device, seed, vae_groups=32):
    """UNet, VAE and text stack with seeded random weights, made on `device`."""
    from controlanimate_tpu_torch.models.clip import CLIPTextModel
    from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
    from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel
    from controlanimate_tpu_torch.models.vae import AutoencoderKL
    from controlanimate_tpu_torch.pipelines.engine import EngineModels
    from controlanimate_tpu_torch.pipelines.facade import TextStack

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    with torch.device(device):
        unet = UNet3DConditionModel(unet_cfg)
        vae = AutoencoderKL(block_out_channels=vae_channels, groups=vae_groups)
        clip = CLIPTextModel(clip_cfg)
    for m in (unet, vae, clip):
        init_weights_(torch, m, gen)
    return EngineModels(unet=unet, vae=vae), TextStack(CLIPTokenizer.tiny(), clip)


def small_reference(torch, conv_kernel: bool = False, motion_kernel: bool = False) -> dict:
    """The same small pipeline (fp32, same weights and noise) on the CPU and
    on the card: uint8 frames must agree within 1 LSB. Head dims 40/80 (UNet)
    and 512 (VAE) put K1 on the card's path; with `conv_kernel` the VAE's
    levels are 128 channels wide and `use_pallas_conv` is on, which puts K2
    on it too; with `motion_kernel` both pipelines are built with
    CONTROLANIMATE_PALLAS_MOTION=1, which puts the motion modules (80 and 160
    channels, 2 heads) on K3."""
    import copy

    from controlanimate_tpu_torch.config import MotionModuleConfig, RunConfig
    from controlanimate_tpu_torch.models.clip import CLIPTextConfig
    from controlanimate_tpu_torch.models.unet3d import UNet3DConfig
    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    cfg = RunConfig(width=64, height=64, frame_count=4, overlap_length=2, use_lcm=True,
                    steps=2, strength=0.9, lcm_origin_steps=8, prompt="a (red fox)+",
                    dtype="float32", use_pallas_conv=conv_kernel)
    ucfg = UNet3DConfig(
        block_out_channels=(80, 160), layers_per_block=1,
        down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
        up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
        attention_heads=2, cross_attention_dim=32, norm_num_groups=8, time_cond_proj_dim=8,
        motion=MotionModuleConfig(num_attention_heads=2, temporal_position_encoding_max_len=8),
    )
    ccfg = CLIPTextConfig(vocab_size=514, hidden_size=32, num_layers=2, num_heads=2,
                          intermediate_size=64, eos_token_id=513)
    vae_channels = (128, 128, 128, 512) if conv_kernel else (32, 64, 64, 512)
    models, text = build_models(torch, ucfg, vae_channels, ccfg, "cpu", SEED, vae_groups=8)
    with motion_env(motion_kernel):
        cpu = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cpu")
        gpu = ControlAnimatePipeline(cfg, models=copy.deepcopy(models),
                                     text_stack=copy.deepcopy(text), device="cuda")
    frames = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(SEED))
    out_cpu = cpu.animate(frames, None, seed=SEED, noise=HostNoise(SEED, "cpu"))
    out_gpu = gpu.animate(frames, None, seed=SEED, noise=HostNoise(SEED, "cuda"))
    diff = (out_cpu.int() - out_gpu.cpu().int()).abs()
    return {"max_lsb": int(diff.max()), "mean_lsb": float(diff.float().mean())}


@contextmanager
def plain_attention(attention_module, plain):
    """Route the main path's K1 calls to the plain version (comparison only)."""
    kernel = attention_module.flash_attention
    attention_module.flash_attention = plain
    try:
        yield
    finally:
        attention_module.flash_attention = kernel


def expected_k1_launches(full_windows: int, overlap_windows: int, steps: int,
                         frames_n: int, overlap: int) -> dict:
    """K1 launches by shape that the window phase implies: the UNet's
    self-attention `steps` times a window, one VAE mid-block attention in the
    decode (all frames) and one in the encode (all frames, or only the new
    ones when the overlap latents are reused)."""
    windows = full_windows + overlap_windows
    expected = {shape: n * steps * windows for shape, n in UNET_SHAPES.items()}
    # the VAE's mid block sees 64x64 latents with one head of 512
    expected[(frames_n, 4096, 4096, 1, 512)] = windows + full_windows
    expected[(frames_n - overlap, 4096, 4096, 1, 512)] = overlap_windows
    return expected


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; this script runs only on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from controlanimate_tpu_torch import _build
    from controlanimate_tpu_torch.config import RunConfig
    from controlanimate_tpu_torch.models.clip import CLIPTextConfig
    from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
    from controlanimate_tpu_torch.models.transformer import BasicTransformerBlock
    from controlanimate_tpu_torch.models.unet3d import UNet3DConfig
    from controlanimate_tpu_torch.models.vae import VaeAttnBlock
    from controlanimate_tpu_torch.ops import attention as attention_module
    from controlanimate_tpu_torch.ops import conv_kernel as ck
    from controlanimate_tpu_torch.ops import flash_attention as fa
    from controlanimate_tpu_torch.ops import motion_kernel as mk
    from controlanimate_tpu_torch.ops import upconv_kernel as uk
    from controlanimate_tpu_torch.pipelines.facade import MOTION_ENV, ControlAnimatePipeline

    # the phases without K3 build their pipelines with the motion switch off
    os.environ[MOTION_ENV] = "0"

    t_all = time.perf_counter()
    t0 = time.perf_counter()
    kind, count, smi = torch.cuda.get_device_name(0), torch.cuda.device_count(), nvidia_smi()
    phase("device", t0, kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = _build.load_library()
    ptxas = ptxas_report(lib.log)
    phase("build", t0, nvcc_seconds=round(lib.build_seconds, 3), library=lib.path.name,
          ptxas=ptxas)
    print(json.dumps({"k2_ptxas": [r for r in ptxas if "conv3x3" in r["function"]]}), flush=True)
    print(json.dumps({"k3_ptxas": [r for r in ptxas if "motion" in r["function"]]}), flush=True)
    print(json.dumps({"k4_ptxas": [r for r in ptxas if "upconv" in r["function"]]}), flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    ref = small_reference(torch)
    ck.reset_launch_counts()
    ref_k2 = small_reference(torch, conv_kernel=True)
    k2_ref_launches = ck.conv3x3_fused.launches
    mk.reset_launch_counts()
    ref_k3 = small_reference(torch, motion_kernel=True)
    k3_ref_launches = mk.motion_module_fused.launches
    uk.reset_launch_counts()
    ref_up4 = small_upscaler_reference(torch, 4.0)
    ref_up2 = small_upscaler_reference(torch, 2.0)
    k4_ref_launches = uk.upconv3x3.launches
    phase("reference", t0, **ref, k2_max_lsb=ref_k2["max_lsb"], k2_mean_lsb=ref_k2["mean_lsb"],
          k2_launches=k2_ref_launches, k3_max_lsb=ref_k3["max_lsb"],
          k3_mean_lsb=ref_k3["mean_lsb"], k3_launches=k3_ref_launches,
          upscale4_max_lsb=ref_up4["max_lsb"], upscale4_mean_lsb=ref_up4["mean_lsb"],
          upscale2_max_lsb=ref_up2["max_lsb"], upscale2_mean_lsb=ref_up2["mean_lsb"],
          k4_launches=k4_ref_launches)
    for r in (ref, ref_k2, ref_k3):
        if r["max_lsb"] > 1:
            raise AssertionError(f"card and CPU pipelines differ by {r['max_lsb']} LSB")
    for r in (ref_up4, ref_up2):
        if r["max_lsb"] > 1:
            raise AssertionError(f"card and CPU upscalers differ by {r['max_lsb']} LSB")
    if k2_ref_launches == 0:
        raise AssertionError("the reference with use_pallas_conv launched no K2")
    if k3_ref_launches == 0:
        raise AssertionError(f"the reference with {MOTION_ENV}=1 launched no K3")
    if k4_ref_launches == 0:
        raise AssertionError("the reference upscalers launched no K4")

    # -- the main path ----------------------------------------------------
    t0 = time.perf_counter()
    size, frames_n, overlap, steps = 512, 16, 8, 4
    cfg = RunConfig(width=size, height=size, frame_count=frames_n, overlap_length=overlap,
                    use_lcm=True, steps=steps, guidance_scale=7.5, strength=0.9,
                    lcm_origin_steps=50, prompt="a cat, masterpiece", n_prompt="blurry",
                    dtype="bfloat16")
    tok = CLIPTokenizer.tiny()
    ccfg = CLIPTextConfig(vocab_size=len(tok.vocab), hidden_size=768, num_layers=12,
                          num_heads=12, intermediate_size=3072, eos_token_id=tok.eos_token_id)
    models, text = build_models(torch, UNet3DConfig(time_cond_proj_dim=256),
                                (128, 256, 512, 512), ccfg, "cuda", SEED)
    pipe = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cuda")
    n_params = sum(p.numel() for p in pipe.models.unet.parameters())
    torch.cuda.synchronize()
    phase("window_build", t0, unet_params=n_params)

    per_window = (
        sum(isinstance(m, BasicTransformerBlock) for m in pipe.models.unet.modules()) * steps
        + sum(isinstance(m, VaeAttnBlock) for m in pipe.models.vae.modules())
    )
    fgen = torch.Generator(device="cuda")
    fgen.manual_seed(SEED)

    def new_frames(n):
        return torch.randint(0, 256, (n, size, size, 3), dtype=torch.uint8, generator=fgen,
                             device="cuda")

    def check_window(out):
        if out.dtype != torch.uint8 or tuple(out.shape) != (frames_n, size, size, 3):
            raise AssertionError(f"window output {out.dtype} {tuple(out.shape)}")

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    ck.reset_launch_counts()
    epoch = 0
    frames = new_frames(frames_n)
    out = pipe.animate(frames, None, overlaps=0, seed=SEED, epoch=epoch)  # warm-up
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    check_window(out)

    # bench.py's count: whole windows without overlap, back to back
    t1 = time.perf_counter()
    for _ in range(WINDOWS):
        epoch += 1
        frames = new_frames(frames_n)
        out = pipe.animate(frames, None, overlaps=0, seed=SEED, epoch=epoch)
        check_window(out)
    torch.cuda.synchronize()
    t_full = time.perf_counter() - t1

    # the overlap-8 stream: each window keeps the last 8 frames of the one
    # before, reuses their cached latents and emits 8 new frames
    stream, cache_before = [], pipe._overlap_latent_cache
    t1 = time.perf_counter()
    for _ in range(WINDOWS):
        epoch += 1
        frames = torch.cat([frames[-overlap:], new_frames(frames_n - overlap)])
        stream.append((frames, out[-overlap:], epoch))
        out = pipe.animate(frames, out[-overlap:], overlaps=overlap, seed=SEED, epoch=epoch)
        check_window(out)
    torch.cuda.synchronize()
    t_stream = time.perf_counter() - t1
    launches, by_shape = fa.flash_attention.launches, dict(fa.flash_attention.launches_by_shape)
    peak = torch.cuda.max_memory_allocated()

    if float(out.float().std()) == 0.0:
        raise AssertionError("window output is constant")
    n_windows = 1 + 2 * WINDOWS
    if launches != n_windows * per_window:
        raise AssertionError(f"K1 launched {launches} times, expected {n_windows * per_window}")
    expected = expected_k1_launches(1 + WINDOWS, WINDOWS, steps, frames_n, overlap)
    if by_shape != expected:
        raise AssertionError(f"K1 launches by shape {by_shape}, expected {expected}")
    if ck.conv3x3_fused.launches:
        raise AssertionError("K2 launched in the window phase, where use_pallas_conv is off")
    phase("window", t0, warmup_seconds=round(t_warm, 4), windows=WINDOWS,
          full_windows_seconds=round(t_full, 4),
          seconds_per_full_window=round(t_full / WINDOWS, 4),
          frames_per_second=round(frames_n * WINDOWS / t_full, 4),
          overlap_windows_seconds=round(t_stream, 4),
          seconds_per_overlap_window=round(t_stream / WINDOWS, 4),
          new_frames_per_second=round((frames_n - overlap) * WINDOWS / t_stream, 4),
          max_memory_allocated=peak, k1_launches=launches,
          k1_launches_per_window=per_window)

    t0 = time.perf_counter()
    pipe._overlap_latent_cache = cache_before
    with plain_attention(attention_module, fa.flash_attention_plain):
        t1 = time.perf_counter()
        for frames, last, epoch in stream:
            out_plain = pipe.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t1
    diff = (out.int() - out_plain.int()).abs()
    phase("window_plain_attention", t0, overlap_windows_seconds=round(t_plain, 4),
          new_frames_per_second=round((frames_n - overlap) * WINDOWS / t_plain, 4),
          uint8_diff_mean=float(diff.float().mean()), uint8_diff_max=int(diff.max()))

    # -- this slice's path: the overlap windows with the motion modules on K3
    t0 = time.perf_counter()
    with motion_env(True):
        pipe_k3 = ControlAnimatePipeline(cfg, models=models, text_stack=text, device="cuda")
    frames, last, epoch = stream[0]
    pipe_k3._overlap_latent_cache = cache_before
    pipe_k3.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)  # warm-up
    pipe_k3._overlap_latent_cache = cache_before
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.reset_launch_counts()
    t1 = time.perf_counter()
    for frames, last, epoch in stream:
        out_k3 = pipe_k3.animate(frames, last, overlaps=overlap, seed=SEED, epoch=epoch)
        check_window(out_k3)
    torch.cuda.synchronize()
    t_k3 = time.perf_counter() - t1
    k3_by_shape = dict(mk.motion_module_fused.launches_by_shape)
    k3_peak = torch.cuda.max_memory_allocated()
    models.unet.set_motion_kernel(False)
    del pipe_k3
    k3_expected = expected_k3_launches(models.unet, size // 8, frames_n, steps, WINDOWS)
    if k3_by_shape != k3_expected:
        raise AssertionError(f"K3 launches by shape {k3_by_shape}, expected {k3_expected}")
    if float(out_k3.float().std()) == 0.0:
        raise AssertionError("window output with K3 is constant")
    diff = (out.int() - out_k3.int()).abs()
    phase("window_motion_kernel", t0, overlap_windows_seconds=round(t_k3, 4),
          seconds_per_overlap_window=round(t_k3 / WINDOWS, 4),
          new_frames_per_second=round((frames_n - overlap) * WINDOWS / t_k3, 4),
          uint8_diff_mean=float(diff.float().mean()), uint8_diff_max=int(diff.max()),
          max_memory_allocated=k3_peak, k3_launches=sum(k3_by_shape.values()),
          k3_launches_per_window=sum(k3_by_shape.values()) // WINDOWS,
          k3_launches_by_shape={str(k): n for k, n in sorted(k3_by_shape.items())})
    del diff, out_k3

    # -- the main path: the vid2vid loop with K2 on ------------------------
    import numpy as np

    from controlanimate_tpu_torch import vid2vid as v2v
    from controlanimate_tpu_torch.io.media import ArrayFrameSink, ArrayFrameSource
    from controlanimate_tpu_torch.ops.blending import blend_overlap_u8
    from controlanimate_tpu_torch.ops.color_match import match_colors_u8

    video = synthetic_video(np, frames_n + V2V_OVERLAP_WINDOWS * (frames_n - overlap), size, SEED)

    class Recording:
        """The facade, keeping the first two windows' raw frames."""

        def __init__(self, pipe):
            self.pipe, self.device, self.raw = pipe, pipe.device, []

        def animate(self, *args, **kw):
            out = self.pipe.animate(*args, **kw)
            if len(self.raw) < 2:
                self.raw.append(out.clone())
            return out

    def run_vid2vid(conv_kernel: bool, tag: str, upscaler=None):
        vcfg = cfg.replace(use_pallas_conv=conv_kernel, seed=SEED, overlap_strength=cfg.strength,
                           upscale=1.0 if upscaler is None else upscaler.scale,
                           output_video_dir=str(ROOT / "build" / "chip_smoke_vid2vid" / tag))
        rec = Recording(ControlAnimatePipeline(vcfg, models=models, text_stack=text,
                                               device="cuda"))
        sink = ArrayFrameSink()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launch_counts()
        ck.reset_launch_counts()
        uk.reset_launch_counts()
        t1 = time.perf_counter()
        summary = v2v.vid2vid(config=vcfg, pipeline=rec, frame_source=ArrayFrameSource(video),
                              frame_sink=sink, upscaler=upscaler)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
        counts = {"k1": fa.flash_attention.launches,
                  "k1_by_shape": dict(fa.flash_attention.launches_by_shape),
                  "k2": ck.conv3x3_fused.launches,
                  "k2_by_shape": dict(ck.conv3x3_fused.launches_by_shape),
                  "k4": uk.upconv3x3.launches,
                  "k4_by_shape": dict(uk.upconv3x3.launches_by_shape)}
        return summary, sink.frames, seconds, rec.raw, counts, torch.cuda.max_memory_allocated()

    t0 = time.perf_counter()
    v2v_windows = 1 + V2V_OVERLAP_WINDOWS
    summary, v2v_frames, v2v_seconds, raw, counts, v2v_peak = run_vid2vid(True, "k2")
    if summary["frames_written"] != len(video) or len(v2v_frames) != len(video):
        raise AssertionError(f"vid2vid wrote {summary['frames_written']} frames "
                             f"({len(v2v_frames)} in the sink) of {len(video)}")
    if summary["windows"] != v2v_windows:
        raise AssertionError(f"vid2vid ran {summary['windows']} windows, expected {v2v_windows}")
    if any(f.shape != (size, size, 3) or f.dtype != np.uint8 for f in v2v_frames):
        raise AssertionError("vid2vid frames are not (512, 512, 3) uint8")
    # window 2's emitted head is window 1's tail blended with window 2's frames
    # color-matched to window 1's anchor (its frame overlap - 1)
    matched = match_colors_u8(raw[1], raw[0][overlap - 1])
    color_change = float((matched.int() - raw[1].int()).abs().float().mean())
    expect = blend_overlap_u8(matched[:overlap], raw[0][-overlap:]).cpu().numpy()
    got = np.stack(v2v_frames[frames_n - overlap:frames_n])
    if color_change == 0.0 or not np.array_equal(got, expect):
        raise AssertionError(f"the stitch did not run as expected on window 2 "
                             f"(color match change {color_change}, "
                             f"max diff {np.abs(got.astype(int) - expect).max()})")
    k1_expected = expected_k1_launches(1, V2V_OVERLAP_WINDOWS, steps, frames_n, overlap)
    if counts["k1_by_shape"] != k1_expected:
        raise AssertionError(f"vid2vid K1 launches {counts['k1_by_shape']}, "
                             f"expected {k1_expected}")
    k2_expected = expected_k2_launches(models.vae, size, frames_n, overlap, 1,
                                       V2V_OVERLAP_WINDOWS)
    if counts["k2_by_shape"] != k2_expected:
        raise AssertionError(f"vid2vid K2 launches {counts['k2_by_shape']}, "
                             f"expected {k2_expected}")
    phase("vid2vid", t0, windows=summary["windows"], frames_written=summary["frames_written"],
          loop_seconds=round(v2v_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary["frames_written"] / v2v_seconds, 4),
          color_match_mean_change_window2=color_change, max_memory_allocated=v2v_peak,
          k1_launches=counts["k1"], k2_launches=counts["k2"],
          k2_launches_per_full_window=sum(
              expected_k2_launches(models.vae, size, frames_n, overlap, 1, 0).values()),
          k2_launches_per_overlap_window=sum(
              expected_k2_launches(models.vae, size, frames_n, overlap, 0, 1).values()),
          timers=summary["timers"])
    v2v_counts = counts

    t0 = time.perf_counter()
    summary_plain, plain_frames, plain_seconds, _, counts, plain_peak = run_vid2vid(False,
                                                                                     "plain")
    if counts["k2"] or counts["k4"] or summary_plain["frames_written"] != len(video):
        raise AssertionError("the plain-conv vid2vid rerun launched K2 or K4 or lost frames")
    diff = np.abs(np.stack(plain_frames).astype(np.int16) - np.stack(v2v_frames).astype(np.int16))
    phase("vid2vid_plain_conv", t0, loop_seconds=round(plain_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_plain["frames_written"] / plain_seconds, 4),
          uint8_diff_mean=float(diff.mean()), uint8_diff_max=int(diff.max()),
          max_memory_allocated=plain_peak, timers=summary_plain["timers"])
    del diff, raw, matched

    # -- this slice's path: the loop with the x4 upscaler, its tail on K4 ---
    from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler

    t0 = time.perf_counter()
    ugen = torch.Generator(device="cuda")
    ugen.manual_seed(SEED)
    with torch.device("cuda"):
        rrdb = RRDBNet()  # RealESRGAN_x4plus_anime_6B: 64 features, 6 blocks
    init_rrdbnet_(torch, rrdb, ugen, RRDB_LAST_GAIN)
    upscaler = Upscaler(4.0, model=rrdb, dtype=torch.bfloat16, device="cuda")
    # warm-up: cuDNN picks its algorithms for the body outside the timed loop
    upscaler.upscale_batch_device(torch.from_numpy(video[:1]).cuda())
    torch.cuda.synchronize()
    t_up_build = time.perf_counter() - t0
    summary_up, up_frames, up_seconds, _, counts, up_peak = run_vid2vid(False, "upscale",
                                                                        upscaler)
    up_size = 4 * size
    if summary_up["frames_written"] != len(video) or len(up_frames) != len(video):
        raise AssertionError(f"vid2vid with upscale wrote {summary_up['frames_written']} frames "
                             f"({len(up_frames)} in the sink) of {len(video)}")
    if any(f.shape != (up_size, up_size, 3) or f.dtype != np.uint8 for f in up_frames):
        raise AssertionError(f"upscaled frames are not ({up_size}, {up_size}, 3) uint8")
    emits = [frames_n - overlap] * v2v_windows + [overlap]
    k4_expected = expected_k4_launches(upscaler, emits, size)
    k4_by_shape = counts["k4_by_shape"]
    if k4_by_shape != k4_expected:
        raise AssertionError(f"vid2vid_upscale K4 launches {k4_by_shape}, expected {k4_expected}")
    if counts["k2"]:
        raise AssertionError("K2 launched in vid2vid_upscale, where use_pallas_conv is off")
    # the same upscaler on the vid2vid_plain_conv phase's frames (the loop's
    # frames before the upscale, if the pipeline repeats itself)
    diff_sum, diff_max, clipped = 0, 0, 0
    for i in range(0, len(video), frames_n - overlap):
        want = upscaler.upscale_batch_device(
            torch.from_numpy(np.stack(plain_frames[i:i + frames_n - overlap])).cuda())
        got = torch.from_numpy(np.stack(up_frames[i:i + frames_n - overlap])).cuda()
        d = (want.int() - got.int()).abs()
        diff_sum += int(d.sum())
        diff_max = max(diff_max, int(d.max()))
        clipped += int(((got == 0) | (got == 255)).sum())
        del want, got, d
    n_values = len(up_frames) * up_size * up_size * 3
    # the device time of one emit's upscale, and of the RRDB body within it
    emit_frames = torch.from_numpy(video[:frames_n - overlap]).cuda()
    emit_x = (emit_frames.float() / 255.0).to(torch.bfloat16)
    with torch.no_grad():
        upscale_ms = cuda_ms(torch, lambda: upscaler.upscale_batch_device(emit_frames), 1)
        body_ms = cuda_ms(torch, lambda: rrdb.features(emit_x), 1)
    del emit_frames, emit_x
    phase("vid2vid_upscale", t0, upscaler_build_seconds=round(t_up_build, 4),
          windows=summary_up["windows"], frames_written=summary_up["frames_written"],
          frame_shape=list(up_frames[0].shape), loop_seconds=round(up_seconds, 4),
          new_frames_per_second_first_window_included=round(
              summary_up["frames_written"] / up_seconds, 4),
          chunks_per_emit=upscaler.chunk_sizes(frames_n - overlap, size, size),
          upscale_ms_per_frame=upscale_ms / (frames_n - overlap),
          rrdb_body_ms_per_frame=body_ms / (frames_n - overlap),
          share_at_0_or_255=clipped / n_values,
          uint8_diff_vs_plain_conv_upscaled_mean=diff_sum / n_values,
          uint8_diff_vs_plain_conv_upscaled_max=diff_max,
          max_memory_allocated=up_peak, k4_launches=counts["k4"],
          k4_launches_by_shape={str(k): n for k, n in sorted(k4_by_shape.items())},
          timers=summary_up["timers"])
    del up_frames, plain_frames
    torch.cuda.empty_cache()

    # -- K1 at every shape the window phase launched it with --------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for shape in sorted(by_shape) + ODD_SHAPES:
        err_bf16 = check_kernel(torch, fa, shape, torch.bfloat16, gen)
        err_fp32 = check_kernel(torch, fa, shape, torch.float32, gen)
        B, Nq, Nk, H, D = shape
        q = torch.randn((B, Nq, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        k, v = (torch.randn((B, Nk, H, D), generator=gen, device="cuda", dtype=torch.bfloat16)
                for _ in range(2))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        iters = 10 if Nq >= 1024 else 50
        row = {
            "shape": list(shape), "launches": by_shape.get(shape, 0),
            "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
            "ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v), iters),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v), iters),
            "library_ms": cuda_ms(torch, lambda: sdpa(qt, kt, vt), iters),
        }
        row["ops_ms"], row["bytes_ms"] = attention_bound_ms(shape, 2)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        rows.append(row)
        print(json.dumps({"k1": row}), flush=True)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    by_row = {tuple(r["shape"]): r for r in rows}

    def window_sums(full, overlapped):
        """K1's per-launch times summed over one window's launches."""
        weights = expected_k1_launches(full, overlapped, steps, frames_n, overlap)
        return {key: sum(n * by_row[shape][key] for shape, n in weights.items())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    phase("kernels", t0, shapes=len(rows), per_full_window=window_sums(1, 0),
          per_overlap_window=window_sums(0, 1))

    # -- K2 at every shape the vid2vid phase launched it with -------------
    t0 = time.perf_counter()
    k2_by_shape = v2v_counts["k2_by_shape"]
    k2_rows = []
    for shape in sorted({key[:5] for key in k2_by_shape}) + K2_ODD_SHAPES:
        err_bf16 = check_k2(torch, ck, shape, torch.bfloat16, gen)
        err_fp32 = check_k2(torch, ck, shape, torch.float32, gen)
        x, w, bias, affine, res = k2_inputs(torch, shape, torch.bfloat16, gen)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        variants = sorted({key[5:] for key in k2_by_shape if key[:5] == shape}) or [(True, True)]
        B, H, W, Cin, Cout = shape
        iters = 3 if 2 * 9 * B * H * W * Cin * Cout > 2e11 else 10
        for has_affine, has_res in variants:
            kw = {"affine": affine, "act": "silu"} if has_affine else {}
            if has_res:
                kw["residual"] = res
            z = ck.activate(x, kw.get("affine"), kw.get("act")).permute(0, 3, 1, 2)
            row = {
                "shape": list(shape), "affine_silu": has_affine, "residual": has_res,
                "launches": k2_by_shape.get(shape + (has_affine, has_res), 0),
                "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
                "ms": cuda_ms(torch, lambda: ck.conv3x3_fused(x, w, bias, **kw), iters),
                "plain_ms": cuda_ms(torch, lambda: ck.conv3x3_fused_plain(x, w, bias, **kw),
                                    iters),
                "library_ms": cuda_ms(
                    torch, lambda: torch.nn.functional.conv2d(z, w_oihw, bias.to(z.dtype),
                                                              padding=1), iters),
            }
            row["ops_ms"], row["bytes_ms"] = conv_bound_ms(shape, 2, has_res)
            row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
            row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
            k2_rows.append(row)
            print(json.dumps({"k2": row}), flush=True)
            del z
        del x, w, w_oihw, bias, affine, res
        torch.cuda.empty_cache()
    k2_by_row = {tuple(r["shape"]) + (r["affine_silu"], r["residual"]): r for r in k2_rows}

    def k2_window_sums(full, overlapped):
        """K2's per-launch times summed over one window's launches."""
        weights = expected_k2_launches(models.vae, size, frames_n, overlap, full, overlapped)
        return {key: sum(n * k2_by_row[k][key] for k, n in weights.items())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms")}

    phase("kernels_k2", t0, shapes=len(k2_rows), per_full_window=k2_window_sums(1, 0),
          per_overlap_window=k2_window_sums(0, 1))

    # -- K3 at every shape the window_motion_kernel phase launched it with --
    t0 = time.perf_counter()
    k3_rows = []
    k3_shapes = [key + (True,) for key in sorted(k3_by_shape)] + K3_ODD_SHAPES
    for shape in k3_shapes:
        errs = check_k3(torch, mk, shape, gen)
        torch.cuda.empty_cache()
        mod, x = k3_inputs(torch, shape, gen)
        mod, x = mod.to(torch.bfloat16), x.bfloat16()
        p, pe = mod.fused_operands(x)
        heads = shape[4]
        packed = mk.pack_weights(p, x.dtype)
        iters = 5 if shape[2] * shape[1] * shape[3] >= 16 * 1024 * 320 else 20
        with torch.no_grad():
            row = {
                "shape": list(shape), "launches": k3_by_shape.get(shape[:5], 0), **errs,
                "ms": cuda_ms(torch, lambda: mk.motion_module_fused(
                    x, p, heads=heads, pe=pe, packed=packed), iters),
                "plain_ms": cuda_ms(torch, lambda: mk.motion_module_plain(
                    x, p, heads=heads, pe=pe), iters),
                "library_ms": cuda_ms(torch, lambda: mod(x), iters),
            }
        row["ops_ms"], row["bytes_ms"] = motion_bound_ms(shape, 2)
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        k3_rows.append(row)
        print(json.dumps({"k3": row}), flush=True)
        del mod, x, p, pe, packed
        torch.cuda.empty_cache()
    k3_by_row = {tuple(r["shape"][:5]): r for r in k3_rows if r["shape"][5]}
    per_window = {key: sum(n * k3_by_row[k][key] for k, n in k3_by_shape.items()) / WINDOWS
                  for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    phase("kernels_k3", t0, shapes=len(k3_rows), per_window=per_window)

    # -- K4 at every shape the vid2vid_upscale phase launched it with ------
    t0 = time.perf_counter()
    F = torch.nn.functional
    k4_rows = []
    launched = sorted(k4_by_shape)
    odd = [shape + (up,) for shape in K4_ODD_SHAPES for up in (True, False)]
    for key in launched + odd:
        shape, upsample = key[:5], key[5]
        err_bf16 = check_k4(torch, uk, shape, upsample, torch.bfloat16, gen)
        torch.cuda.empty_cache()
        # fp32 at batch 1 of a launched shape: the batch of 8 at 2048^2 with
        # the plain version's fp32 copies would hold about 40 GB
        err_fp32 = check_k4(torch, uk, (1,) + shape[1:], upsample, torch.float32, gen)
        torch.cuda.empty_cache()
        x, w, bias = k4_inputs(torch, shape, torch.bfloat16, gen)
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w_oihw = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        b16 = bias.to(torch.bfloat16)

        def library():
            h = F.interpolate(xc, scale_factor=2.0, mode="nearest") if upsample else xc
            return F.leaky_relu(F.conv2d(h, w_oihw, b16, padding=1), 0.2)

        B, H, W = shape[:3]
        iters = 3 if B * H * W >= 4 * 1024 * 1024 else 10
        row = {
            "shape": list(shape), "upsample": upsample, "launches": k4_by_shape.get(key, 0),
            "max_abs_err_bf16": err_bf16, "max_abs_err_fp32": err_fp32,
            "ms": cuda_ms(torch, lambda: uk.upconv3x3(x, w, bias, upsample=upsample,
                                                      act="lrelu"), iters),
            "plain_ms": cuda_ms(torch, lambda: uk.upconv3x3_plain(x, w, bias, upsample=upsample,
                                                                  act="lrelu"), iters),
            "library_ms": cuda_ms(torch, library, iters),
        }
        row["ops_ms"], row["bytes_ms"], row["folded_gflop"] = upconv_bound_ms(shape, upsample, 2)
        row["useful_gflop"] = row["ops_ms"] * PEAK_BF16_FLOPS / 1e12
        row["bound_ms"] = max(row["ops_ms"], row["bytes_ms"])
        row["bound_by"] = "operations" if row["ops_ms"] >= row["bytes_ms"] else "bytes"
        k4_rows.append(row)
        print(json.dumps({"k4": row}), flush=True)
        del x, w, bias, xc, w_oihw, b16
        torch.cuda.empty_cache()
    k4_by_row = {tuple(r["shape"]) + (r["upsample"],): r for r in k4_rows}
    per_frame = {k: sum(n * k4_by_row[key][k] for key, n in k4_by_shape.items()) / len(video)
                 for k in ("ms", "plain_ms", "library_ms", "bound_ms", "folded_gflop",
                           "useful_gflop")}
    phase("kernels_k4", t0, shapes=len(k4_rows), per_frame=per_frame)

    def path_sum(by_row, by_shape, key):
        """`key` summed over one path's launches (launches x per-launch value
        at each shape)."""
        return sum(by_row[shape][key] * n for shape, n in by_shape.items())

    def kernel_entry(name, source, replaces, by_row, by_shape, errs):
        ops, nbytes = (path_sum(by_row, by_shape, k) for k in ("ops_ms", "bytes_ms"))
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_shape.values()),
            "max_abs_err": max(errs),
            "ms": path_sum(by_row, by_shape, "ms"),
            "plain_ms": path_sum(by_row, by_shape, "plain_ms"),
            "bound_ms": path_sum(by_row, by_shape, "bound_ms"),
            "bound_by": "operations" if ops >= nbytes else "bytes",
            "library_ms": path_sum(by_row, by_shape, "library_ms"),
        }

    # launches and sums over the main path: the vid2vid phase's run
    kernels = [
        kernel_entry("flash_attention", "controlanimate_tpu_torch/csrc/flash_attention.cu",
                     "controlanimate_tpu/ops/flash_attention.py:40", by_row,
                     v2v_counts["k1_by_shape"], [r["max_abs_err_bf16"] for r in rows]),
        kernel_entry("conv3x3_fused", "controlanimate_tpu_torch/csrc/conv3x3_fused.cu",
                     "controlanimate_tpu/ops/conv_kernel.py:79", k2_by_row,
                     k2_by_shape, [r["max_abs_err_bf16"] for r in k2_rows]),
        # K3's path is the window_motion_kernel phase's run
        kernel_entry("motion_module_fused", "controlanimate_tpu_torch/csrc/motion_module.cu",
                     "controlanimate_tpu/ops/motion_kernel.py:94", k3_by_row, k3_by_shape,
                     [r["max_abs_err_bf16"] for r in k3_rows]),
        # K4's path is the vid2vid_upscale phase's run
        kernel_entry("upconv3x3", "controlanimate_tpu_torch/csrc/upconv3x3.cu",
                     "controlanimate_tpu/ops/upconv_kernel.py:67", k4_by_row, k4_by_shape,
                     [r["max_abs_err_bf16"] for r in k4_rows]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"total_seconds": round(time.perf_counter() - t_all, 3)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
