"""K4: conv3x3 [+ nearest-2x upsample] + bias [+ leaky ReLU], a hand-written
CUDA kernel for the RealESRGAN x4 tail.

Replaces the TPU kernel `controlanimate_tpu/ops/upconv_kernel.py` (`_run` ->
`_kernel`, public as `conv3x3_small` and `upsample2x_conv3x3_fine`). One
function, `upconv3x3`, in two modes, on NHWC input (B, H, W, Ci) with HWIO
weights (3, 3, Ci, Co):

- `conv3x3_lrelu`: conv3x3 with SAME zero padding, + bias, then optionally
  leaky ReLU (slope 0.2); (B, H, W, Co).
- `upsample2x_conv3x3_lrelu`: the same on nearest-2x(x), computed from x
  without the 2x tensor; (B, 2H, 2W, Co) in the fine layout.

Rounding, as the JAX kernel does: the upsample's folded weights are summed in
fp32 and rounded once to the input dtype (bf16(w1 + w2)); the products
accumulate in fp32; the bias (fp32) and the leaky ReLU run in fp32; the
result is rounded once.

The CUDA source is `csrc/upconv3x3.cu`; `_build.py` compiles it with K1-K3
in one nvcc call and loads it with ctypes. What bounds it on the H100: at
the tail's Ci = Co = 64 the useful work is 2*4*Ci*Co FLOPs a fine pixel
(upsample) or 2*9*Ci*Co (conv) against the input read and the output
written once, 64 and 144 FLOPs a bf16 byte, under the card's 295: up1 and
up2 are bound by bytes, conv_hr nearly balanced. The TPU kernel multiplies
by a dense (9 Ci, 4 Co) fold that is 5/9 zeros; the CUDA kernel runs each
output parity as its own 2x2 convolution on the coarse input. In bf16 its
blocks walk over tiles with the folded weights resident in shared memory,
stage each tile's patch once for all four parities through a cp.async ring,
read mma.sync fragments with ldmatrix and store whole fine rows in 16-byte
units; in fp32 the products are FMAs. The weights in the kernel's layout
(`kernel_weights`) may be passed in as `packed`, folded and cast once: the
upscaler keeps them per parameter version.

On a CPU tensor the wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each launch adds one to
`upconv3x3.launches` and to `upconv3x3.launches_by_shape` under its
(B, H, W, Ci, Co, upsample); `reset_launch_counts` zeroes both.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CHANNEL_MULTIPLE = 32  # input channels staged per step; output channels per half-block


def supported(H: int, W: int, Ci: int, Co: int) -> bool:
    """The shapes the CUDA kernel takes: any H and W (ragged tiles are
    masked), Ci and Co multiples of 32. The RRDB tail's 64 -> 64 convs pass."""
    return H >= 1 and W >= 1 and Ci % CHANNEL_MULTIPLE == 0 and Co % CHANNEL_MULTIPLE == 0


def fold_upsample_weights(weight: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) HWIO -> (2, 2, 2, 2, Ci, Co) fp32, indexed [p, q, a, b]:
    output pixel (2i+p, 2j+q) of conv3x3(nearest_2x(x)) is the sum over a, b
    of x[i-1+p+a, j-1+q+b] @ fold[p, q, a, b] (the tap table of
    `controlanimate_tpu/ops/upsample.py`: rows p=0 {i-1: w0, i: w1+w2}, p=1
    {i: w0+w1, i+1: w2}, columns likewise). Summed in fp32, rows first, as
    the JAX `fold_upsample_kernel_s2d` does."""
    k = weight.float()
    rows = (torch.stack([k[0], k[1] + k[2]]), torch.stack([k[0] + k[1], k[2]]))
    return torch.stack([
        torch.stack([torch.stack([r[:, 0], r[:, 1] + r[:, 2]], 1),
                     torch.stack([r[:, 0] + r[:, 1], r[:, 2]], 1)])
        for r in rows
    ])


def fold_upsample_s2d(weight: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) -> (3, 3, Ci, 4 Co) fp32: the folded weights as one 3x3
    kernel on the coarse input whose output channels are (p, q, co), the JAX
    kernel's dense (9 Ci, 4 Co) matrix; taps outside a parity's 2x2 window
    are 0."""
    fold = fold_upsample_weights(weight)
    Ci, Co = fold.shape[-2:]
    w4 = fold.new_zeros((3, 3, Ci, 2, 2, Co))
    for p in (0, 1):
        for q in (0, 1):
            w4[p:p + 2, q:q + 2, :, p, q, :] = fold[p, q]
    return w4.reshape(3, 3, Ci, 4 * Co)


def _conv_plain(x, w_hwio, bias, act):
    """lrelu(conv3x3(x, w) + bias) in fp32 from x's dtype, weights rounded to
    x's dtype, TF32 off, one rounding at the end."""
    z = x.float().permute(0, 3, 1, 2)
    w = w_hwio.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(z, w, padding=1).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = out + bias.float()
    if act == "lrelu":
        out = torch.where(out >= 0, out, out * 0.2)
    return out.to(x.dtype)


def upconv3x3_plain(x, weight, bias, *, upsample: bool, act=None):
    """The kernel's function in plain PyTorch, in the kernel's order. The
    upsample mode convolves x with the dense s2d fold (its zero taps add
    exact zeros) and interleaves the four parities."""
    if not upsample:
        return _conv_plain(x, weight, bias, act)
    B, H, W, _ = x.shape
    Co = weight.shape[-1]
    out = _conv_plain(x, fold_upsample_s2d(weight), bias.float().repeat(4), act)
    return out.reshape(B, H, W, 2, 2, Co).permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, Co)


def _check_args(x, weight, bias, act) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Ci), got shape {tuple(x.shape)}")
    Ci = x.shape[-1]
    if weight.ndim != 4 or tuple(weight.shape[:3]) != (3, 3, Ci):
        raise ValueError(f"weight must be HWIO (3, 3, {Ci}, Co), got {tuple(weight.shape)}")
    Co = weight.shape[-1]
    if tuple(bias.shape) != (Co,):
        raise ValueError(f"bias must be ({Co},), got {tuple(bias.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32 or bfloat16)")
    if act not in (None, "lrelu"):
        raise ValueError(f"act must be None or 'lrelu', got {act!r}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("all operands must be on x's device")


def check_kernel_args(x, weight) -> None:
    """What the CUDA kernel takes beyond `_check_args`: a supported shape and
    CUDA tensors."""
    _, H, W, Ci = x.shape
    Co = weight.shape[-1]
    if not supported(H, W, Ci, Co):
        raise ValueError(f"conv shape {(H, W, Ci, Co)} not supported by the kernel "
                         f"(Ci and Co multiples of {CHANNEL_MULTIPLE})")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")


def kernel_weights(weight, dtype, upsample: bool) -> torch.Tensor:
    """The kernel's (P, T, Co, Ci) layout in `dtype`, contiguous: the four
    parities' (2p + q) four folded taps (2a + b), or the conv's nine taps
    (3 dy + dx)."""
    Ci, Co = weight.shape[2], weight.shape[3]
    with torch.no_grad():
        if upsample:
            w = fold_upsample_weights(weight).to(dtype).reshape(4, 4, Ci, Co)
        else:
            w = weight.to(dtype).reshape(1, 9, Ci, Co)
        return w.transpose(2, 3).contiguous()


def _check_packed(packed, x, weight, upsample: bool) -> None:
    Ci, Co = weight.shape[2], weight.shape[3]
    want = (4, 4, Co, Ci) if upsample else (1, 9, Co, Ci)
    if (tuple(packed.shape) != want or packed.dtype != x.dtype or packed.device != x.device
            or not packed.is_contiguous()):
        raise ValueError(f"packed weights must be contiguous {want} {x.dtype} on {x.device}, "
                         f"got {tuple(packed.shape)} {packed.dtype} on {packed.device}")


def upconv3x3(x, weight, bias, *, upsample: bool, act=None, packed=None):
    """x: (B, H, W, Ci), channels contiguous (any batch / row / column
    strides); weight: (3, 3, Ci, Co) HWIO; bias: (Co,); act: None or 'lrelu';
    packed: None or `kernel_weights(weight, x.dtype, upsample)`, computed
    once by the caller (the kernel then folds nothing). Returns
    lrelu(conv3x3(nearest_2x(x) if upsample else x) + bias) in x's dtype:
    (B, 2H, 2W, Co) or (B, H, W, Co), contiguous."""
    _check_args(x, weight, bias, act)
    if packed is not None:
        _check_packed(packed, x, weight, upsample)
    if x.device.type == "cpu":
        return upconv3x3_plain(x, weight, bias, upsample=upsample, act=act)
    check_kernel_args(x, weight)
    from .._build import load_library

    lib = load_library().lib
    B, H, W, Ci = x.shape
    Co = weight.shape[-1]
    vec = 16 // x.element_size()
    if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
        x = x.contiguous()  # the kernel reads each pixel's channels as 16-byte vectors
    w = kernel_weights(weight, x.dtype, upsample) if packed is None else packed
    bias32 = bias.float().contiguous()
    scale = 2 if upsample else 1
    out = torch.empty((B, scale * H, scale * W, Co), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.upconv3x3_fwd(
            x.data_ptr(), *x.stride()[:3], w.data_ptr(), bias32.data_ptr(), out.data_ptr(),
            B, H, W, Ci, Co, int(upsample), int(act == "lrelu"), _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        msg = lib.upconv3x3_error_string(err).decode()
        raise RuntimeError(f"upconv3x3_fwd failed: {msg} ({err})")
    upconv3x3.launches += 1
    upconv3x3.launches_by_shape[(B, H, W, Ci, Co, bool(upsample))] += 1
    return out


def conv3x3_lrelu(x, weight, bias, act=None, packed=None):
    """[lrelu](conv3x3(x) + bias), stride 1, SAME zero padding: the
    counterpart of the JAX `conv3x3_small`."""
    return upconv3x3(x, weight, bias, upsample=False, act=act, packed=packed)


def upsample2x_conv3x3_lrelu(x, weight, bias, act=None, packed=None):
    """[lrelu](conv3x3(nearest_2x(x)) + bias) -> (B, 2H, 2W, Co), fine
    layout: the counterpart of the JAX `upsample2x_conv3x3_fine`."""
    return upconv3x3(x, weight, bias, upsample=True, act=act, packed=packed)


def kernel_plan(B: int, H: int, W: int, Ci: int, Co: int, upsample: bool) -> dict:
    """The bf16 kernel's launch plan for a call on the card: the block's
    shared memory, whether the weights stay resident, the grid of persistent
    blocks and the most tiles a block walks."""
    import ctypes

    from .._build import load_library

    lib = load_library().lib
    plan = (ctypes.c_int * 5)()
    err = lib.upconv3x3_bf16_plan(B, H, W, Ci, Co, int(upsample), plan)
    if err != 0:
        raise RuntimeError(f"upconv3x3_bf16_plan failed: "
                           f"{lib.upconv3x3_error_string(err).decode()} ({err})")
    return {"smem_bytes": plan[0], "resident_weights": bool(plan[1]),
            "grid": [plan[2], plan[3]], "tiles_per_block": plan[4]}


def reset_launch_counts() -> None:
    upconv3x3.launches = 0
    upconv3x3.launches_by_shape = Counter()


reset_launch_counts()
