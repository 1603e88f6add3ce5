"""Spatial transformer: per-frame attention over the H*W tokens.

Counterpart of `controlanimate_tpu/models/transformer.py`: frames fold into the
batch, the text context repeats per frame, and each block runs self-attention
(K1 through `dot_product_attention`) -> cross-attention over the text (and,
with `ip_tokens`, the IP-Adapter's image tokens at the context's tail, scaled
by `ip_scale`) -> GEGLU feed-forward. Sparse-causal cross-frame attention,
the temporal sub-layer and ToMe token merging are not in this slice and
raise.
"""

from __future__ import annotations

from torch import nn

from .layers import Attention, FeedForward, GroupNorm, LayerNorm32, conv1x1_nhwc
from .resnet3d import fold_frames, unfold_frames


def sparse_causal_kv(h, frames):
    raise NotImplementedError("sparse-causal cross-frame attention is not ported yet")


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768,
                 upcast_attention: bool = False, ip_tokens: int = 0):
        super().__init__()
        self.attn1 = Attention(dim, heads, dim_head, upcast_attention=upcast_attention)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim,
                               upcast_attention=upcast_attention, ip_tokens=ip_tokens)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, ip_scale: float = 1.0):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=context, ip_scale=ip_scale)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, residual
    (SD1.5: use_linear_projection=False)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 cross_attention_dim: int = 768, upcast_attention: bool = False,
                 groups: int = 32, cross_frame: bool = False, temporal_attention: bool = False,
                 tome_ratio: float = 0.0, ip_tokens: int = 0):
        super().__init__()
        if cross_frame:
            sparse_causal_kv(None, 0)
        if temporal_attention or tome_ratio:
            raise NotImplementedError("temporal sub-layer and ToMe are not ported yet")
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, upcast_attention,
                                  ip_tokens)
            for _ in range(depth)
        )
        self.proj_out = nn.Conv2d(inner, channels, 1)

    def forward(self, x, context, ip_scale: float = 1.0):
        """x: (B, F, H, W, C); context: (B, L, D) text (+ image) embeddings."""
        B, F_, H, W, C = x.shape
        h, f = fold_frames(x)
        h = conv1x1_nhwc(self.norm(h), self.proj_in)
        inner = h.shape[-1]
        h = h.reshape(B * F_, H * W, inner)
        ctx = context.repeat_interleave(F_, dim=0)
        for block in self.transformer_blocks:
            h = block(h, ctx, ip_scale)
        h = conv1x1_nhwc(h.reshape(B * F_, H, W, inner), self.proj_out)
        return unfold_frames(h, f) + x
