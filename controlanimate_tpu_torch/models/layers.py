"""Shared building blocks of the SD1.5-family model stack, in PyTorch.

Counterpart of `controlanimate_tpu/models/layers.py`. Conventions kept from
the JAX package, so the tests compare like with like:
  * channels-last activations: images (N, H, W, C), video (B, F, H, W, C);
  * parameters in the run dtype; normalisation statistics in fp32, applied in
    the input dtype;
  * diffusers checkpoint key names (`to_q`, `to_out.0`, `net.0.proj`, ...),
    so a disk checkpoint loads with plain `load_state_dict`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    flip_sin_to_cos: bool = True,
    freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (SD convention), fp32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    emb = torch.exp(exponent / (half - freq_shift))
    emb = timesteps.float()[..., None] * emb
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer(x)` with x cast to the layer's dtype (flax Dense(dtype) semantics)."""
    return layer(x.to(layer.weight.dtype))


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply an NCHW-weighted conv to a channels-last (N, H, W, C) tensor.

    The permutes are views: the conv sees a channels_last-strided input and
    returns channels_last, so no layout copy is made either way."""
    y = nn.Conv2d.forward(conv, x.to(conv.weight.dtype).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1)


def conv1x1_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv on channels-last input is a linear map over C."""
    w = conv.weight
    return F.linear(x.to(w.dtype), w.reshape(w.shape[0], w.shape[1]), conv.bias)


class TimestepEmbedding(nn.Module):
    """2-layer MLP lifting the sinusoidal embedding, with the optional LCM
    guidance-embedding projection (`cond_proj`)."""

    def __init__(self, in_dim: int, embed_dim: int, cond_proj_dim: Optional[int] = None):
        super().__init__()
        if cond_proj_dim:
            self.cond_proj = nn.Linear(cond_proj_dim, in_dim, bias=False)
        self.cond_proj_dim = cond_proj_dim
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, sample, condition=None):
        sample = sample.to(self.linear_1.weight.dtype)
        if condition is not None:
            if not self.cond_proj_dim:
                raise ValueError("timestep condition passed but cond_proj_dim unset")
            sample = sample + linear(condition, self.cond_proj)
        return self.linear_2(F.silu(self.linear_1(sample)))


def group_norm_affine(x, weight, bias, num_groups: int, eps: float):
    """GroupNorm folded into a per-(sample, channel) affine (a, b) so that
    norm(x) = x * a + b: fp32 statistics over everything but the leading and
    channel axes, returned in x's dtype."""
    N, C = x.shape[0], x.shape[-1]
    G = num_groups
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    grouped = x.reshape(N, -1, G, C // G).float()
    var, mean = torch.var_mean(grouped, dim=(1, 3), correction=0)  # (N, G)
    inv = torch.rsqrt(var + eps)
    w = weight.float().reshape(1, G, C // G)
    a = (w * inv[..., None]).reshape(N, C)
    b = (bias.float().reshape(1, G, C // G) - (mean * inv)[..., None] * w).reshape(N, C)
    return a.to(x.dtype), b.to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm over the trailing channel axis of (N, ..., C); fp32
    statistics, applied in the input dtype."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-5):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        a, b = group_norm_affine(x, self.weight, self.bias, self.num_groups, self.eps)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        return x * a.reshape(shape) + b.reshape(shape)


class LayerNorm32(nn.Module):
    """LayerNorm with fp32 statistics and input-dtype output."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        var, mean = torch.var_mean(x.float(), dim=-1, keepdim=True, correction=0)
        inv = torch.rsqrt(var + self.eps)
        a = inv.to(x.dtype)
        b = (-mean * inv).to(x.dtype)
        return (x * a + b) * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class Attention(nn.Module):
    """Multi-head attention over (B, N, C) tokens; self-attention when no
    context is given. With `ip_tokens` > 0 (the IP-Adapter's dual stream,
    the cross-attention only) the context's trailing `ip_tokens` tokens are
    image tokens: `to_k_ip` / `to_v_ip` project them, and `ip_scale` times
    the attention of the queries over them is added before `to_out`."""

    def __init__(
        self,
        query_dim: int,
        heads: int = 8,
        dim_head: int = 64,
        cross_attention_dim: Optional[int] = None,
        out_bias: bool = True,
        upcast_attention: bool = False,
        ip_tokens: int = 0,
    ):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.upcast_attention = upcast_attention
        self.ip_tokens = ip_tokens
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        if ip_tokens:
            self.to_k_ip = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(cross_attention_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim, bias=out_bias)])

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.heads, self.dim_head)

    def forward(self, hidden_states, encoder_hidden_states=None, mask=None,
                ip_scale: float = 1.0):
        ctx = hidden_states if encoder_hidden_states is None else encoder_hidden_states
        ip_ctx = None
        if self.ip_tokens and encoder_hidden_states is not None:
            if ctx.shape[1] <= self.ip_tokens:
                raise ValueError(f"a context of {ctx.shape[1]} tokens holds no text before "
                                 f"its {self.ip_tokens} image tokens")
            ctx, ip_ctx = ctx[:, :-self.ip_tokens], ctx[:, -self.ip_tokens:]
        q = self._heads(linear(hidden_states, self.to_q))
        k = self._heads(linear(ctx, self.to_k))
        v = self._heads(linear(ctx, self.to_v))
        out = dot_product_attention(q, k, v, mask=mask, upcast=self.upcast_attention)
        if ip_ctx is not None:
            k_ip = self._heads(linear(ip_ctx, self.to_k_ip))
            v_ip = self._heads(linear(ip_ctx, self.to_v_ip))
            out = out + ip_scale * dot_product_attention(q, k_ip, v_ip,
                                                         upcast=self.upcast_attention)
        B, N = out.shape[:2]
        return self.to_out[0](out.reshape(B, N, self.heads * self.dim_head))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x):
        h, gate = linear(x, self.proj).chunk(2, dim=-1)
        return h * F.gelu(gate)  # exact erf, as diffusers' GEGLU


class FeedForward(nn.Module):
    """GEGLU feed-forward; `net.1` is the (inference no-op) dropout slot of
    the diffusers key layout."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Identity(), nn.Linear(dim * mult, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))
