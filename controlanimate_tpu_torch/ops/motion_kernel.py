"""K3: the fused AnimateDiff temporal transformer, a hand-written CUDA kernel.

Replaces the TPU kernel `controlanimate_tpu/ops/motion_kernel.py`
(`motion_module_fused` -> `_motion_kernel`): the whole temporal transformer of
one motion module on (B, F, N, C) activations, returning the delta (the
caller adds the outer residual in the input dtype):

    folded GroupNorm affine -> proj_in
    -> 2 x [ LayerNorm -> +PE -> frame-axis attention -> out-projection + residual ]
    -> LayerNorm -> GEGLU feed-forward -> residual
    -> proj_out

The CUDA source is `csrc/motion_module.cu`; `_build.py` compiles it with K1
and K2 in one nvcc call and loads it with ctypes.

What bounds it on the H100: 44 C^2 + 8 F C FLOPs a token (989 TFLOP/s in
bf16) against 2 C elements a token and the 22 C^2 weights moved (3.35 TB/s):
bound by its operations at every main-path shape, and the time is in the
GEMMs, not in the 16 x 16 frame attention. The TPU kernel keeps all weights
resident in VMEM; here they do not fit shared memory (4.5 MB at C = 320, 72
MB at C = 1280, against 227 KB), so the module is a chain of fourteen
launches (`STAGES`): a normalize pass before each GEMM that reads a
normalized input (the folded GroupNorm affine; LayerNorm with its fp32 row
statistics, + the PE row), seven GEMMs (bf16: mma.sync on a three-stage
cp.async ring with ldmatrix fragments, 128 x 160 or 64 x 160 output tiles)
with fused epilogues (bias, residual, the q|k / v split, the GEGLU gate), and
two frame attentions (a block per run of consecutive positions, 16-byte
copies). fp32 GEMMs run as FMAs.

`p` is the flat parameter dict of the JAX caller
(`controlanimate_tpu/models/motion_module.py` `MotionModule.__call__`), with
its keys and layouts: Dense kernels (in, out) (`win`, `wq0`, ..., `w1` (C, 8C)
as [value | gate], `w2` (4C, C), `wout`), biases, the LayerNorm scales and
biases `ls0`/`lb0`/`ls1`/`lb1`/`lsf`/`lbf`, and the folded GroupNorm terms
`gn_a`, `gn_b` (B, F, C). `pack_weights` turns it into the kernel's layouts
once; a caller that keeps the packing passes it as `packed`.

On a CPU tensor the wrapper computes the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each call that launches the chain
adds one to `motion_module_fused.launches` and to
`motion_module_fused.launches_by_shape` under its (B, F, N, C, heads);
`reset_launch_counts` zeroes both.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_FRAMES = 32
CHANNEL_MULTIPLE = 8  # 16-byte rows
GEGLU_GROUP = 80  # W1 value rows per group (then as many gate rows): half a GEMM column tile
LN_EPS = 1e-5

# the pointer table of `motion_module_fwd`, in the order of the C enum `Ptr`
_WEIGHTS = ("win", "bin", "ls0", "lb0", "wqkv0", "wo0", "ob0", "ls1", "lb1", "wqkv1", "wo1",
            "ob1", "lsf", "lbf", "w1", "b1", "w2", "b2", "wout", "bout")
_SCRATCH = ("h", "z", "qk", "v", "attn", "gg", "out")
_PTR_ORDER = ("x", "gn_a", "gn_b", "pe") + _WEIGHTS + _SCRATCH
# the chain's launches, in order (`kLaunches` of them in the source)
STAGES = ("norm_gn", "proj_in", "norm0", "qkv0", "attn0", "out0", "norm1", "qkv1", "attn1",
          "out1", "norm_ff", "w1_geglu", "w2", "proj_out")


def _layernorm(h, scale, bias, eps: float = LN_EPS):
    """LayerNorm as the kernel computes it: fp32 statistics (E[x^2] - E[x]^2
    clamped at 0), then (h * a + b) * scale + bias in h's dtype, rounding after
    each op."""
    h32 = h.float()
    mean = h32.mean(dim=-1, keepdim=True)
    mean2 = h32.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(torch.clamp(mean2 - mean.square(), min=0.0) + eps)
    a = inv.to(h.dtype)
    b = (-mean * inv).to(h.dtype)
    return (h * a + b) * scale.to(h.dtype) + bias.to(h.dtype)


def _dense32(z, kernel, bias=None, residual=None):
    """z @ kernel on operands rounded to z's dtype, in fp32 (TF32 off, the
    default), + bias (rounded to z's dtype) + residual in fp32: the fp32 value
    the kernel's epilogue rounds once."""
    y = z.float() @ kernel.to(z.dtype).float()
    if bias is not None:
        y = y + bias.to(z.dtype).float()
    if residual is not None:
        y = y + residual.float()
    return y


def motion_module_plain(x, p: dict, *, heads: int, pe=None):
    """The kernel's function in plain PyTorch, in the kernel's order and
    roundings. x: (B, F, N, C); pe: (F, C) or None. Returns the delta,
    (B, F, N, C) in x's dtype."""
    B, F_, N, C = x.shape
    dt = x.dtype
    H, D = heads, C // heads
    h = x * p["gn_a"].to(dt).reshape(B, F_, 1, C) + p["gn_b"].to(dt).reshape(B, F_, 1, C)
    h = _dense32(h, p["win"], p["bin"]).to(dt)
    pe_dt = None if pe is None else torch.as_tensor(pe, device=x.device)[:F_].to(dt)
    for i in (0, 1):
        z = _layernorm(h, p[f"ls{i}"], p[f"lb{i}"])
        if pe_dt is not None:
            z = z + pe_dt[None, :, None, :]
        q = _dense32(z, p[f"wq{i}"]).to(dt).float().reshape(B, F_, N, H, D)
        k = _dense32(z, p[f"wk{i}"]).to(dt).float().reshape(B, F_, N, H, D)
        v = _dense32(z, p[f"wv{i}"]).reshape(B, F_, N, H, D)  # fp32, as the TPU kernel
        logits = torch.einsum("bfnhd,bgnhd->bnhfg", q, k) * (D**-0.5)
        probs = torch.softmax(logits, dim=-1).to(dt).float()
        attn = torch.einsum("bnhfg,bgnhd->bfnhd", probs, v).reshape(B, F_, N, C).to(dt)
        h = _dense32(attn, p[f"wo{i}"], p[f"ob{i}"], residual=h).to(dt)
    z = _layernorm(h, p["lsf"], p["lbf"])
    g = _dense32(z, p["w1"], p["b1"]).to(dt)
    inner = g.shape[-1] // 2
    gate = F.gelu(g[..., inner:].float()).to(dt)  # exact erf, fp32
    ff = g[..., :inner] * gate
    h = _dense32(ff, p["w2"], p["b2"], residual=h).to(dt)
    return _dense32(h, p["wout"], p["bout"]).to(dt)


def _geglu_rows(w1, b1):
    """W1 (out, in) = (2 inner, C) and its bias re-laid so that each group of
    2 * GEGLU_GROUP rows is [GEGLU_GROUP value rows | their gate rows],
    zero-padded to whole groups: one GEMM output tile then holds a value
    column and its gate."""
    inner = w1.shape[0] // 2
    groups = -(-inner // GEGLU_GROUP)
    pad = groups * GEGLU_GROUP - inner

    def split(t):
        val, gate = t[:inner], t[inner:]
        if pad:
            widths = (0, 0) * (t.ndim - 1) + (0, pad)
            val, gate = F.pad(val, widths), F.pad(gate, widths)
        rest = t.shape[1:]
        return torch.stack([val.reshape(groups, GEGLU_GROUP, *rest),
                            gate.reshape(groups, GEGLU_GROUP, *rest)], dim=1).reshape(-1, *rest)

    return split(w1).contiguous(), split(b1).contiguous()


def pack_weights(p: dict, dtype) -> dict:
    """p's weights in the kernel's layouts: (out, in) contiguous in `dtype`
    (the transpose of an (in, out) view of an nn.Linear weight is that weight,
    so no copy is made for those), q, k and v concatenated to (3C, C), W1's
    rows grouped as `_geglu_rows` says; biases fp32 after a rounding to
    `dtype`; LayerNorm terms in `dtype`."""
    def weight(key):
        return p[key].to(dtype).t().contiguous()

    def bias(key):
        return p[key].to(dtype).float().contiguous()

    def vec(key):
        return p[key].to(dtype).contiguous()

    packed = {"win": weight("win"), "bin": bias("bin"), "lsf": vec("lsf"), "lbf": vec("lbf"),
              "w2": weight("w2"), "b2": bias("b2"), "wout": weight("wout"), "bout": bias("bout")}
    for i in (0, 1):
        packed[f"ls{i}"], packed[f"lb{i}"] = vec(f"ls{i}"), vec(f"lb{i}")
        packed[f"wqkv{i}"] = torch.cat([weight(f"wq{i}"), weight(f"wk{i}"), weight(f"wv{i}")])
        packed[f"wo{i}"], packed[f"ob{i}"] = weight(f"wo{i}"), bias(f"ob{i}")
    packed["w1"], packed["b1"] = _geglu_rows(weight("w1"), bias("b1"))
    return packed


def _check_args(x, p, heads, pe) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (B, F, N, C), got shape {tuple(x.shape)}")
    B, F_, N, C = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x dtype {x.dtype} not supported (float32 or bfloat16)")
    if heads <= 0 or C % heads:
        raise ValueError(f"channels {C} not divisible by heads {heads}")
    for key, shape in (("gn_a", (B, F_, C)), ("gn_b", (B, F_, C)), ("win", (C, C)),
                       ("w1", (C, 8 * C)), ("w2", (4 * C, C)), ("wout", (C, C))):
        if tuple(p[key].shape) != shape:
            raise ValueError(f"p[{key!r}] must be {shape}, got {tuple(p[key].shape)}")
    if pe is not None and (len(pe) < F_ or tuple(pe.shape[1:]) != (C,)):
        raise ValueError(f"pe must be (>= {F_}, {C}), got {tuple(pe.shape)}")
    if any(torch.is_tensor(t) and t.device != x.device for t in p.values()):
        raise ValueError("all parameters must be on x's device")


def attention_plan(frames: int, channels: int, heads: int, positions: int,
                   itemsize: int) -> tuple[int, int, int] | None:
    """The frame attention's plan as the CUDA source makes it
    (`motion_attention_plan`): (heads a block, positions a block, shared
    memory bytes), or None when one position does not fit shared memory.
    Loads the kernels' library."""
    from .._build import load_library

    out = (ctypes.c_int * 3)()
    if not load_library().lib.motion_attention_plan(frames, channels, heads, positions,
                                                    itemsize, out):
        return None
    return tuple(out)


def check_kernel_args(x, heads: int) -> None:
    """What the CUDA kernel takes beyond `_check_args`: a CUDA tensor, C a
    multiple of 8, at most 32 frames, and one position of the frame attention
    within shared memory."""
    B, F_, N, C = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"the kernel runs on CUDA tensors, got {x.device}")
    if C % CHANNEL_MULTIPLE:
        raise ValueError(f"channels {C} not supported by the kernel (C % {CHANNEL_MULTIPLE})")
    if F_ > MAX_FRAMES:
        raise ValueError(f"{F_} frames not supported by the kernel (at most {MAX_FRAMES})")
    if attention_plan(F_, C, heads, N, x.element_size()) is None:
        raise ValueError(f"{C} channels in {heads} heads with {F_} frames do not fit shared memory")


def _launch(x, p: dict, heads: int, pe, packed: dict | None, timed_reps: int = 0):
    """Launch the chain on x's stream (x passed `_check_args`); returns (out,
    stage ms or None). With `timed_reps`, the chain runs that many times with
    a CUDA event after each launch (the stream is synchronized) and each
    launch's mean ms comes back by name (`STAGES`). Each chain run counts as
    one launch."""
    check_kernel_args(x, heads)
    from .._build import load_library

    lib = load_library().lib
    B, F_, N, C = x.shape
    dt = x.dtype
    M = B * F_ * N
    if packed is None:
        packed = pack_weights(p, dt)
    tensors = dict(packed)
    tensors["x"] = x.contiguous()
    tensors["gn_a"] = p["gn_a"].to(dt).reshape(B * F_, C).contiguous()
    tensors["gn_b"] = p["gn_b"].to(dt).reshape(B * F_, C).contiguous()
    tensors["pe"] = (None if pe is None
                     else torch.as_tensor(pe, device=x.device)[:F_].to(dt).contiguous())
    for key, width, dtype in (("h", C, dt), ("z", C, dt), ("qk", 2 * C, dt),
                              ("v", C, torch.float32), ("attn", C, dt), ("gg", 4 * C, dt),
                              ("out", C, dt)):
        tensors[key] = torch.empty((M, width), dtype=dtype, device=x.device)
    for key in _PTR_ORDER:
        t = tensors[key]
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{key} is on {t.device}, not on x's device {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"the kernel reads {key} in 16-byte vectors: it must be 16-byte aligned")
    ptrs = (ctypes.c_void_p * len(_PTR_ORDER))(
        *[None if tensors[k] is None else tensors[k].data_ptr() for k in _PTR_ORDER])
    stage_ms = None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if timed_reps:
            ms = (ctypes.c_float * len(STAGES))()
            err = lib.motion_module_fwd_timed(ptrs, B, F_, N, C, heads, _DTYPE_CODES[dt], stream,
                                              ms, len(STAGES), timed_reps)
            stage_ms = dict(zip(STAGES, ms))
        else:
            err = lib.motion_module_fwd(ptrs, B, F_, N, C, heads, _DTYPE_CODES[dt], stream)
    if err != 0:
        msg = lib.motion_module_error_string(err).decode()
        raise RuntimeError(f"motion_module_fwd failed: {msg} ({err})")
    chains = timed_reps or 1
    motion_module_fused.launches += chains
    motion_module_fused.launches_by_shape[(B, F_, N, C, heads)] += chains
    return tensors["out"].reshape(B, F_, N, C), stage_ms


def motion_module_fused(x, p: dict, *, heads: int, pe=None, packed: dict | None = None):
    """x: (B, F, N, C); p: the flat parameter dict (module docstring); pe:
    (>= F, C) positional table or None; packed: `pack_weights(p, x.dtype)`,
    made here when not given. Returns the delta, (B, F, N, C) in x's dtype."""
    _check_args(x, p, heads, pe)
    if x.device.type == "cpu":
        return motion_module_plain(x, p, heads=heads, pe=pe)
    return _launch(x, p, heads, pe, packed)[0]


def motion_module_stage_ms(x, p: dict, *, heads: int, pe=None, packed: dict | None = None,
                           reps: int = 5) -> dict:
    """Each launch's mean time in ms over `reps` runs of the chain on a CUDA
    x, by CUDA events, keyed by `STAGES` (a measurement; synchronizes)."""
    _check_args(x, p, heads, pe)
    return _launch(x, p, heads, pe, packed, timed_reps=reps)[1]


def reset_launch_counts() -> None:
    motion_module_fused.launches = 0
    motion_module_fused.launches_by_shape = Counter()


reset_launch_counts()
