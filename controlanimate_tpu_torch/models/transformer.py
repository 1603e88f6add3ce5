"""Spatial transformer: per-frame attention over the H*W tokens.

Counterpart of `controlanimate_tpu/models/transformer.py`: frames fold into the
batch, the text context repeats per frame, and each block runs self-attention
(K1 through `dot_product_attention`) -> cross-attention over the text (and,
with `ip_tokens`, the IP-Adapter's image tokens at the context's tail, scaled
by `ip_scale`) -> GEGLU feed-forward. Two options of the inference yaml:

  * `unet_use_cross_frame_attention`: sparse-causal self-attention. Frame t's
    queries attend to the tokens of frame 0 and frame t - 1, concatenated
    (frame 0 sees itself twice, which is its plain self-attention). JAX
    gathers the token source before the k/v projections; here K and V are
    projected first and then gathered, which is equal up to rounding (the
    projection is per token) and half the projection work. The attention
    has Nk = 2 Nq, so it calls K1 directly (`Attention.forward(frames=)`;
    `dot_product_attention` sends only Nq == Nk to K1).
  * `unet_use_temporal_attention`: after the feed-forward, a self-attention
    over the frame axis at every token, (B*F, N, C) -> (B*N, F, C), under
    `norm_temp` and `attn_temp` (out projection zero at init, so a fresh
    sub-layer is the identity). Nq == Nk == F, so the router sends it to K1.

ToMe token merging is not in the port yet and raises.
"""

from __future__ import annotations

from torch import nn

from .layers import Attention, FeedForward, GroupNorm, LayerNorm32, conv1x1_nhwc
from .resnet3d import fold_frames, unfold_frames


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, cross_attention_dim: int = 768,
                 upcast_attention: bool = False, ip_tokens: int = 0,
                 cross_frame: bool = False, temporal_attention: bool = False):
        super().__init__()
        self.cross_frame = cross_frame
        self.attn1 = Attention(dim, heads, dim_head, upcast_attention=upcast_attention)
        self.attn2 = Attention(dim, heads, dim_head, cross_attention_dim=cross_attention_dim,
                               upcast_attention=upcast_attention, ip_tokens=ip_tokens)
        self.norm1 = LayerNorm32(dim)
        self.norm2 = LayerNorm32(dim)
        self.norm3 = LayerNorm32(dim)
        self.ff = FeedForward(dim)
        if temporal_attention:
            self.attn_temp = Attention(dim, heads, dim_head, upcast_attention=upcast_attention)
            self.norm_temp = LayerNorm32(dim)
            nn.init.zeros_(self.attn_temp.to_out[0].weight)
            nn.init.zeros_(self.attn_temp.to_out[0].bias)
        else:
            self.attn_temp = None

    def forward(self, x, context, ip_scale: float = 1.0, frames: int = 1):
        """x: (B*F, N, C) tokens of `frames` frames a batch entry."""
        sparse_causal = self.cross_frame and frames > 1
        x = x + self.attn1(self.norm1(x), frames=frames if sparse_causal else None)
        x = x + self.attn2(self.norm2(x), encoder_hidden_states=context, ip_scale=ip_scale)
        x = x + self.ff(self.norm3(x))
        if self.attn_temp is None:
            return x
        BF, N, C = x.shape
        t = x.reshape(BF // frames, frames, N, C).transpose(1, 2).reshape(-1, frames, C)
        t = t + self.attn_temp(self.norm_temp(t))
        return t.reshape(BF // frames, N, frames, C).transpose(1, 2).reshape(BF, N, C)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1x1 proj_in -> transformer blocks -> 1x1 proj_out, residual
    (SD1.5: use_linear_projection=False)."""

    def __init__(self, channels: int, heads: int, dim_head: int, depth: int = 1,
                 cross_attention_dim: int = 768, upcast_attention: bool = False,
                 groups: int = 32, cross_frame: bool = False, temporal_attention: bool = False,
                 tome_ratio: float = 0.0, ip_tokens: int = 0):
        super().__init__()
        if tome_ratio:
            raise NotImplementedError("ToMe token merging is not ported yet")
        inner = heads * dim_head
        self.norm = GroupNorm(groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, inner, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head, cross_attention_dim, upcast_attention,
                                  ip_tokens, cross_frame, temporal_attention)
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
            h = block(h, ctx, ip_scale, frames=F_)
        h = conv1x1_nhwc(h.reshape(B * F_, H, W, inner), self.proj_out)
        return unfold_frames(h, f) + x
