"""K1: flash attention, a hand-written CUDA kernel for Hopper.

Replaces the TPU kernel `controlanimate_tpu/ops/flash_attention.py`
(`flash_attention` -> `_attn_kernel`): softmax(Q K^T * scale) V with no mask,
fp32 softmax and accumulation, over (B, N, H, D) tensors. The CUDA source is
`csrc/flash_attention.cu`; `_build.py` compiles it with nvcc and loads it
with ctypes.

What bounds it on the H100: 4*B*H*Nq*Nk*D FLOPs (989 TFLOP/s in bf16) against
(Nq + 2*Nk + Nq)*B*H*D elements moved (3.35 TB/s), so it is compute-bound at
every shape of the UNet and the VAE. The bf16 kernels (the main path) run
both products on the tensor cores (mma.sync, fp32 sums) in two passes over K:
the first finds each row's exact max, the second rounds P to bf16 against it
as the JAX kernel's one-pass branch and `flash_attention_plain` do, and
multiplies it by V. At D <= 160 each warp keeps its scores and P in
registers; at D = 512 D is split over the warps. K/V tiles come through a
two-stage cp.async ring; the source's header note gives the plans. The
16-byte copies need 16-byte-aligned base pointers and (B, N, H) strides,
which `check_kernel_args` demands of bf16 inputs. The fp32 kernel does its
products as FMAs on the CUDA cores: it serves the fp32 reference runs and
their 1e-4 gates, which bf16 tensor cores cannot meet.

On a CPU tensor the wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each launch adds one to
`flash_attention.launches` and to `flash_attention.launches_by_shape` under
its (B, Nq, Nk, H, D); `reset_launch_counts` zeroes both.
"""

from __future__ import annotations

import math
from collections import Counter

import torch

SUPPORTED_HEAD_DIMS = (32, 40, 64, 80, 160, 512)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, scale: float | None = None):
    """The kernel's function in plain PyTorch, rounded where the JAX kernel
    rounds at every main-path shape (its one-pass branch,
    `controlanimate_tpu/ops/flash_attention.py` `_attn_kernel`): logits
    (q * scale) @ k^T and the softmax in fp32, P = exp(logits - row max) cast
    to the input dtype before the P @ v product (summed in fp32), the result
    divided by the fp32 row sum of the unrounded P and cast back to the input
    dtype. In fp32 the cast is the identity."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    p = torch.einsum("bqhd,bkhd->bhqk", qf * scale, kf)
    p = p.sub_(p.amax(dim=-1, keepdim=True)).exp_()  # in place: the logits' storage
    rowsum = p.sum(dim=-1).permute(0, 2, 1)[..., None]  # (B, Nq, H, 1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).float(), vf)
    return (out / rowsum).to(q.dtype)


def _check_args(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.ndim != 4:
            raise ValueError(f"{name} must be (B, N, H, D), got shape {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32 or bfloat16)")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("q, k, v must share one device and dtype")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    B, _, H, D = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(
            f"shapes do not match: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}"
        )


def check_kernel_args(q, k, v) -> None:
    """What the CUDA kernel takes beyond `_check_args`: a supported head dim,
    B*H within the grid, CUDA tensors, and in bf16 16-byte alignment: the
    bf16 kernels copy 16 bytes at a time (cp.async), so every base pointer
    and every (B, N, H) stride of a dimension longer than one must be a
    multiple of 16 bytes. A misaligned input raises, naming the tensor; no
    copy is made and nothing falls back."""
    B, _, H, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel {SUPPORTED_HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B*H = {B * H} exceeds the kernel's grid (65535)")
    if max(t.numel() for t in (q, k, v)) >= 2**31:
        raise ValueError("tensors of 2**31 elements or more overflow the kernel's int strides")
    for name, t in (("q", q), ("k", k), ("v", v)) if q.dtype == torch.bfloat16 else ():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}'s data pointer is not 16-byte aligned (the bf16 "
                             "kernel's cp.async copies need it)")
        for dim in range(3):
            if t.shape[dim] > 1 and (t.stride(dim) * t.element_size()) % 16:
                raise ValueError(f"{name}'s stride {t.stride(dim)} of dimension {dim} is not a "
                                 "multiple of 16 bytes (the bf16 kernel's cp.async copies "
                                 "need it)")
    if q.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {q.device}")


def flash_attention(q, k, v, scale: float | None = None):
    """q: (B, Nq, H, D), k/v: (B, Nk, H, D) -> (B, Nq, H, D). No mask."""
    _check_args(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    check_kernel_args(q, k, v)
    from .._build import load_library

    lib = load_library().lib
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    B, Nq, H, D = q.shape
    Nk = k.shape[1]
    o = torch.empty((B, Nq, H, D), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, H, Nq, Nk, D, *strides, float(scale), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention_fwd failed: {msg} ({err})")
    flash_attention.launches += 1
    flash_attention.launches_by_shape[(B, Nq, Nk, H, D)] += 1
    return o


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.launches_by_shape = Counter()


reset_launch_counts()
