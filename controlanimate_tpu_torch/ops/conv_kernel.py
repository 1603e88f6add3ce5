"""K2: fused GroupNorm affine -> SiLU -> conv3x3, a hand-written CUDA kernel.

Replaces the TPU kernel `controlanimate_tpu/ops/conv_kernel.py`
(`conv3x3_fused` -> `_conv_kernel`): y = conv3x3(act(x * a + b)) + bias
[+ residual] on channels-last tensors, zero padding after the activation.
The CUDA source is `csrc/conv3x3_fused.cu`; `_build.py` compiles it beside
the other kernels and loads it with ctypes.

What bounds it on the H100: 2*9*B*H*W*Cin*Cout FLOPs (989 TFLOP/s in bf16)
against (B*H*W*(Cin + Cout [+ Cout]) + 9*Cin*Cout) elements moved (3.35 TB/s):
compute-bound at every conv of the SD VAE. The kernel is an implicit GEMM
with the normalisation and activation applied while the input patch is
staged, so the activated tensor never reaches device memory (the point of the
TPU kernel too). In bf16 the products run on the tensor cores (mma.sync fed
by ldmatrix) over 16 x 16 pixel tiles, with the next 32-channel chunk's
weights and input landing by cp.async while the current one is multiplied;
in fp32 they are FMAs on the CUDA cores.

Weights come in HWIO (3, 3, Cin, Cout), the JAX tree's layout; the wrapper
re-lays them on every call to (9, Cout, Cin) in the input dtype, the layout
the kernel stages (a small copy beside the conv, not cached). The GroupNorm
before a conv is folded into (a, b) by `groupnorm_fold`, in plain PyTorch, as
the JAX fold is plain XLA outside its kernel.

On a CPU tensor the wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each launch adds one to
`conv3x3_fused.launches` and to `conv3x3_fused.launches_by_shape` under its
(B, H, W, Cin, Cout, affine, residual); `reset_launch_counts` zeroes both.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
CIN_MULTIPLE = 16  # one mma k16 step; a chunk of 32 may end on a short one
COUT_MULTIPLE = 128  # output channels per block


def supported(H: int, W: int, Cin: int, Cout: int) -> bool:
    """The shapes the CUDA kernel takes: any H and W (ragged tiles are
    masked), Cin a multiple of 16 and Cout of 128. Every resnet and upsample
    conv of the SD VAE (128/256/512 channels) passes; conv_in / conv_out
    (3 channels) do not."""
    return H >= 1 and W >= 1 and Cin % CIN_MULTIPLE == 0 and Cout % COUT_MULTIPLE == 0


def groupnorm_fold(x, scale, bias, num_groups: int = 32, eps: float = 1e-5):
    """Fold GroupNorm's statistics into per-(batch, channel) (a, b), so that
    x * a + b is the normalised x: fp32 statistics, var = E[x^2] - E[x]^2
    clamped at 0, rsqrt(var + eps), (a, b) cast to x's dtype. x: (B, ..., C).

    No fp32 or squared copy of x is made on CUDA: E[x] is a sum and E[x^2]
    the squared 2-norm of each group, both reductions reading x as it is and
    accumulating in fp32 (as the JAX fold's means with dtype=float32 do
    inside XLA's fused reductions). The norm's square root and its square
    add one fp32 rounding to E[x^2]."""
    B, C = x.shape[0], x.shape[-1]
    G = num_groups
    grouped = x.reshape(B, -1, G, C // G)
    count = grouped.shape[1] * grouped.shape[3]
    mean = torch.sum(grouped, dim=(1, 3), dtype=torch.float32) / count  # (B, G)
    mean2 = torch.linalg.vector_norm(grouped, dim=(1, 3), dtype=torch.float32).square() / count
    var = torch.clamp(mean2 - mean.square(), min=0.0)
    inv = torch.rsqrt(var + eps)
    scale_g = scale.reshape(G, C // G).float()
    bias_g = bias.reshape(G, C // G).float()
    a = (scale_g[None] * inv[:, :, None]).reshape(B, C)
    b = (bias_g[None] - (mean * inv)[:, :, None] * scale_g[None]).reshape(B, C)
    return a.to(x.dtype), b.to(x.dtype)


def activate(x, affine=None, act=None):
    """x * a + b in x's dtype, then SiLU in fp32 rounded back to x's dtype:
    the tensor the kernel convolves."""
    z = x
    if affine is not None:
        a, b = affine
        z = z * a[:, None, None, :] + b[:, None, None, :]
    if act == "silu":
        z32 = z.float()
        z = (z32 * torch.sigmoid(z32)).to(x.dtype)
    return z


def conv3x3_fused_plain(x, weight, bias, affine=None, act=None, residual=None):
    """The kernel's function in plain PyTorch, in the kernel's order: the
    activated input and the weights rounded to x's dtype, the conv in fp32
    (TF32 off), + bias in fp32, + residual in fp32, one rounding at the end.
    `F.conv2d` in bf16 would round before the bias and the residual."""
    z = activate(x, affine, act).float().permute(0, 3, 1, 2)
    w = weight.to(x.dtype).float().permute(3, 2, 0, 1)  # HWIO -> OIHW
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        out = F.conv2d(z, w, padding=1).permute(0, 2, 3, 1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    out = out + bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def _check_args(x, weight, bias, affine, act, residual) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, H, W, Cin), got shape {tuple(x.shape)}")
    B, H, W, Cin = x.shape
    if weight.ndim != 4 or tuple(weight.shape[:3]) != (3, 3, Cin):
        raise ValueError(f"weight must be HWIO (3, 3, {Cin}, Cout), got {tuple(weight.shape)}")
    Cout = weight.shape[-1]
    if tuple(bias.shape) != (Cout,):
        raise ValueError(f"bias must be ({Cout},), got {tuple(bias.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32 or bfloat16)")
    if act not in (None, "silu"):
        raise ValueError(f"act must be None or 'silu', got {act!r}")
    tensors = [weight, bias]
    if affine is not None:
        for t in affine:
            if tuple(t.shape) != (B, Cin):
                raise ValueError(f"affine terms must be ({B}, {Cin}), got {tuple(t.shape)}")
        tensors += list(affine)
    if residual is not None:
        if tuple(residual.shape) != (B, H, W, Cout):
            raise ValueError(f"residual must be {(B, H, W, Cout)}, got {tuple(residual.shape)}")
        tensors.append(residual)
    if any(t.device != x.device for t in tensors):
        raise ValueError("all operands must be on x's device")


def check_kernel_args(x, weight, affine, residual) -> None:
    """What the CUDA kernel takes beyond `_check_args`: a supported shape,
    CUDA tensors, matching dtypes."""
    B, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    if not supported(H, W, Cin, Cout):
        raise ValueError(f"conv shape {(H, W, Cin, Cout)} not supported by the kernel "
                         f"(Cin % {CIN_MULTIPLE}, Cout % {COUT_MULTIPLE})")
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    for t in list(affine or ()) + ([residual] if residual is not None else []):
        if t.dtype != x.dtype:
            raise TypeError(f"affine and residual must be {x.dtype}, got {t.dtype}")


def conv3x3_fused(x, weight, bias, affine=None, act=None, residual=None):
    """x: (B, H, W, Cin); weight: (3, 3, Cin, Cout) HWIO; bias: (Cout,);
    affine: (a, b), each (B, Cin), or None; act: None or 'silu';
    residual: (B, H, W, Cout) or None. Stride 1, SAME zero padding applied
    after the activation. Returns (B, H, W, Cout) in x's dtype."""
    _check_args(x, weight, bias, affine, act, residual)
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, weight, bias, affine, act, residual)
    check_kernel_args(x, weight, affine, residual)
    from .._build import load_library

    lib = load_library().lib
    B, H, W, Cin = x.shape
    Cout = weight.shape[-1]
    x = x.contiguous()
    w = weight.to(x.dtype).permute(0, 1, 3, 2).reshape(9, Cout, Cin).contiguous()
    bias32 = bias.float().contiguous()
    a = b = res = None
    if affine is not None:
        a, b = (t.contiguous() for t in affine)
    if residual is not None:
        res = residual.contiguous()
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    if any(t.data_ptr() % 16 for t in (x, w, a, b, res, out) if t is not None):
        raise ValueError("the kernel reads x, weights, affine and residual in 16-byte vectors: "
                         "their data must be 16-byte aligned")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.conv3x3_fused_fwd(
            x.data_ptr(), w.data_ptr(), bias32.data_ptr(),
            None if a is None else a.data_ptr(), None if b is None else b.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            B, H, W, Cin, Cout, int(act == "silu"), _DTYPE_CODES[x.dtype], stream,
        )
    if err != 0:
        msg = lib.conv3x3_fused_error_string(err).decode()
        raise RuntimeError(f"conv3x3_fused_fwd failed: {msg} ({err})")
    conv3x3_fused.launches += 1
    conv3x3_fused.launches_by_shape[
        (B, H, W, Cin, Cout, affine is not None, residual is not None)] += 1
    return out


def reset_launch_counts() -> None:
    conv3x3_fused.launches = 0
    conv3x3_fused.launches_by_shape = Counter()


reset_launch_counts()
