"""AnimateDiff temporal motion module.

Counterpart of `controlanimate_tpu/models/motion_module.py`: a temporal
transformer whose attention runs across the frames at each spatial location,
(B, F, H, W, C) -> (B, F, N, C) with attention over F, with a sinusoidal
positional encoding over the frame axis. Two paths compute it: the dense
path of PyTorch ops, and K3 (`ops/motion_kernel.py`), the whole transformer
as one fused call, taken when `MotionModule.use_motion_kernel` is set
(`UNet3DConditionModel.set_motion_kernel`) and the module has the shape K3
computes, as the JAX package's `MotionModule` dispatches. Banded attention
and ToMe are not ported yet and raise.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..ops import motion_kernel as mk
from ..ops.conv_kernel import groupnorm_fold
from .layers import FeedForward, GroupNorm, LayerNorm32, linear


def temporal_positional_encoding(max_len: int, dim: int) -> np.ndarray:
    """Standard sinusoidal PE table, (max_len, dim) float32."""
    position = np.arange(max_len)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, dim, 2).astype(np.float64) * (-math.log(10000.0) / dim))
    pe = np.zeros((max_len, dim))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class TemporalEinsumAttention(nn.Module):
    """Frame-axis multi-head attention on (B, F, N, C)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(dim, dim, bias=False)
        self.to_v = nn.Linear(dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, h):
        B, F_, N, C = h.shape
        H, D = self.heads, C // self.heads
        q = linear(h, self.to_q).reshape(B, F_, N, H, D)
        k = linear(h, self.to_k).reshape(B, F_, N, H, D)
        v = linear(h, self.to_v).reshape(B, F_, N, H, D)
        logits = torch.einsum("bfnhd,bgnhd->bnhfg", q, k) * (D**-0.5)
        probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bnhfg,bgnhd->bfnhd", probs, v).reshape(B, F_, N, C)
        return self.to_out[0](out)


class TemporalTransformerBlock(nn.Module):
    """Temporal_Self attention blocks (LayerNorm -> +PE -> frame attention ->
    residual), then LayerNorm -> GEGLU feed-forward -> residual."""

    def __init__(self, dim: int, heads: int, attention_block_types: Sequence[str],
                 max_len: int, use_pos_encoding: bool):
        super().__init__()
        for block_type in attention_block_types:
            if block_type != "Temporal_Self":
                raise NotImplementedError(f"attention block type {block_type!r}")
        n = len(attention_block_types)
        self.attention_blocks = nn.ModuleList(TemporalEinsumAttention(dim, heads) for _ in range(n))
        self.norms = nn.ModuleList(LayerNorm32(dim) for _ in range(n))
        self.ff_norm = LayerNorm32(dim)
        self.ff = FeedForward(dim)
        self.use_pos_encoding = use_pos_encoding
        pe = torch.from_numpy(temporal_positional_encoding(max_len, dim))
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x):
        F_ = x.shape[1]
        for attn, norm in zip(self.attention_blocks, self.norms):
            h = norm(x)
            if self.use_pos_encoding:
                h = h + self.pe[:F_].to(h.dtype)[None, :, None, :]
            x = x + attn(h)
        return x + self.ff(self.ff_norm(x))


class TemporalTransformer3D(nn.Module):
    def __init__(self, channels: int, heads: int, num_transformer_block: int,
                 attention_block_types: Sequence[str], max_len: int,
                 use_pos_encoding: bool, groups: int):
        super().__init__()
        self.heads = heads
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            TemporalTransformerBlock(channels, heads, attention_block_types, max_len,
                                     use_pos_encoding)
            for _ in range(num_transformer_block)
        )
        self.proj_out = nn.Linear(channels, channels)
        self._packing = None  # (parameter key, K3's packed weights)

    def forward(self, h4):
        """h4: (B, F, N, C) -> the module's delta, (B, F, N, C)."""
        B, F_, N, C = h4.shape
        h = self.norm(h4.reshape(B * F_, N, C))  # statistics per frame
        h = linear(h, self.proj_in).reshape(B, F_, N, C)
        for block in self.transformer_blocks:
            h = block(h)
        return self.proj_out(h)

    def motion_params(self) -> dict:
        """The flat parameter dict of K3 under the JAX caller's keys, without
        the GroupNorm terms (they depend on the input): Dense kernels as
        (in, out) views of the nn.Linear weights, no copy. Needs one
        transformer block of two attention blocks."""
        blk = self.transformer_blocks[0]
        p = {
            "win": self.proj_in.weight.t(), "bin": self.proj_in.bias,
            "wout": self.proj_out.weight.t(), "bout": self.proj_out.bias,
            "lsf": blk.ff_norm.weight, "lbf": blk.ff_norm.bias,
            "w1": blk.ff.net[0].proj.weight.t(), "b1": blk.ff.net[0].proj.bias,
            "w2": blk.ff.net[2].weight.t(), "b2": blk.ff.net[2].bias,
        }
        for i, (attn, norm) in enumerate(zip(blk.attention_blocks, blk.norms)):
            p[f"ls{i}"], p[f"lb{i}"] = norm.weight, norm.bias
            p[f"wq{i}"], p[f"wk{i}"] = attn.to_q.weight.t(), attn.to_k.weight.t()
            p[f"wv{i}"], p[f"wo{i}"] = attn.to_v.weight.t(), attn.to_out[0].weight.t()
            p[f"ob{i}"] = attn.to_out[0].bias
        return p

    def _packed(self, p: dict, dtype) -> dict:
        """K3's weight layouts, packed once and kept until a parameter is
        replaced, moved or changed in place."""
        key = tuple((t.data_ptr(), t._version) for t in self.parameters()) + (dtype,)
        if self._packing is None or self._packing[0] != key:
            self._packing = (key, mk.pack_weights(p, dtype))
        return self._packing[1]

    def fused_operands(self, h4) -> tuple[dict, torch.Tensor | None]:
        """K3's (p, pe) for the input h4 (B, F, N, C) in the weights' dtype:
        `motion_params` with the GroupNorm statistics folded into gn_a, gn_b
        (fp32 statistics, eps 1e-6), and the PE rows of the F frames or None."""
        B, F_, N, C = h4.shape
        a, b = groupnorm_fold(h4.reshape(B * F_, N, C), self.norm.weight, self.norm.bias,
                              self.norm.num_groups, eps=self.norm.eps)
        p = self.motion_params()
        p["gn_a"], p["gn_b"] = a.reshape(B, F_, C), b.reshape(B, F_, C)
        blk = self.transformer_blocks[0]
        return p, (blk.pe[:F_] if blk.use_pos_encoding else None)

    def forward_fused(self, h4):
        """The same delta as `forward`, through one `motion_module_fused`."""
        h4 = h4.to(self.proj_in.weight.dtype)
        p, pe = self.fused_operands(h4)
        packed = self._packed(p, h4.dtype) if h4.is_cuda else None
        return mk.motion_module_fused(h4, p, heads=self.heads, pe=pe, packed=packed)


class MotionModule(nn.Module):
    """VanillaTemporalModule: x + temporal_transformer(x) on (B, F, H, W, C)."""

    def __init__(self, channels: int, heads: int = 8, num_transformer_block: int = 1,
                 attention_block_types: Sequence[str] = ("Temporal_Self", "Temporal_Self"),
                 max_len: int = 32, use_pos_encoding: bool = True, groups: int = 32,
                 band: int = 0, tome_ratio: float = 0.0):
        super().__init__()
        if band or tome_ratio:
            raise NotImplementedError("banded temporal attention and ToMe are not ported yet")
        self.channels = channels
        self.heads = heads
        self.max_len = max_len
        self.use_pos_encoding = use_pos_encoding
        # K3 takes the module when switched on and of the shape it computes
        self.use_motion_kernel = False
        self.fusable = (num_transformer_block == 1 and len(attention_block_types) == 2
                        and channels % heads == 0)
        self.temporal_transformer = TemporalTransformer3D(
            channels, heads, num_transformer_block, attention_block_types, max_len,
            use_pos_encoding, groups,
        )

    def forward(self, x):
        B, F_, H, W, C = x.shape
        if self.use_pos_encoding and F_ > self.max_len:
            raise ValueError(
                f"window of {F_} frames exceeds the motion module's positional "
                f"table (max_len={self.max_len})"
            )
        h4 = x.reshape(B, F_, H * W, C)
        if self.use_motion_kernel and self.fusable:
            delta = self.temporal_transformer.forward_fused(h4)
        else:
            delta = self.temporal_transformer(h4)
        return x + delta.reshape(B, F_, H, W, C)
