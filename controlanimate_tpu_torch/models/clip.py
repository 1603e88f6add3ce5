"""CLIP text encoder and vision tower (HF CLIP numerics) in PyTorch.

Counterpart of `controlanimate_tpu/models/clip.py`:
  * `CLIPTextModel`: pre-LN transformer with quick_gelu, causal mask,
    eos-position pooling and clip-skip (the hidden state K layers before the
    last, through the final layer norm);
  * `CLIPVisionModelWithProjection`, the IP-Adapter's image encoder: patch
    conv, class token, positions, `pre_layrnorm`, non-causal layers (their
    self-attention on K1 through `dot_product_attention`), `post_layernorm`
    on the class token and `visual_projection`. It returns `image_embeds`,
    `pooled_output` and `penultimate_hidden_states` (the input of the last
    layer).
Layer norms compute and return fp32, as the JAX model's `nn.LayerNorm(dtype=
float32)` does. Keys follow the HF checkpoints (`text_model.encoder.layers.0.
self_attn.q_proj.weight`, `vision_model.embeddings.patch_embedding.weight`,
`visual_projection.weight`, ...). Both towers apply quick_gelu whatever a
config's `hidden_act` says, as the JAX package does.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention
from .layers import conv_nhwc, linear


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    eos_token_id: int = 49407
    num_extra_embeddings: int = 0  # textual-inversion rows

    @staticmethod
    def from_json(cfg: dict, num_extra_embeddings: int = 0) -> "CLIPTextConfig":
        """From an HF text_encoder config.json (the JAX `from_json`)."""
        return CLIPTextConfig(
            vocab_size=cfg.get("vocab_size", 49408),
            hidden_size=cfg.get("hidden_size", 768),
            num_layers=cfg.get("num_hidden_layers", 12),
            num_heads=cfg.get("num_attention_heads", 12),
            intermediate_size=cfg.get("intermediate_size", 3072),
            max_position_embeddings=cfg.get("max_position_embeddings", 77),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
            eos_token_id=cfg.get("eos_token_id", 49407),
            num_extra_embeddings=num_extra_embeddings,
        )


@dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    intermediate_size: int = 5120
    image_size: int = 224
    patch_size: int = 14
    projection_dim: int = 1024
    layer_norm_eps: float = 1e-5

    @staticmethod
    def from_json(cfg: dict) -> "CLIPVisionConfig":
        """From an HF vision config (the JAX `from_json`: ViT-H/14 defaults;
        `hidden_act` is not read)."""
        return CLIPVisionConfig(
            hidden_size=cfg.get("hidden_size", 1280),
            num_layers=cfg.get("num_hidden_layers", 32),
            num_heads=cfg.get("num_attention_heads", 16),
            intermediate_size=cfg.get("intermediate_size", 5120),
            image_size=cfg.get("image_size", 224),
            patch_size=cfg.get("patch_size", 14),
            projection_dim=cfg.get("projection_dim", 1024),
            layer_norm_eps=cfg.get("layer_norm_eps", 1e-5),
        )


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm computed and returned in fp32 whatever the parameter dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps)


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, causal: bool):
        B, N, C = x.shape
        shape = (B, N, self.num_heads, C // self.num_heads)
        q = linear(x, self.q_proj).reshape(shape)
        k = linear(x, self.k_proj).reshape(shape)
        v = linear(x, self.v_proj).reshape(shape)
        mask = None
        if causal:
            mask = torch.tril(torch.ones((N, N), dtype=torch.bool, device=x.device))[None, None]
        out = dot_product_attention(q, k, v, mask=mask)
        return self.out_proj(out.reshape(B, N, C))


class CLIPMLP(nn.Module):
    def __init__(self, dim: int, intermediate_size: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, dim)

    def forward(self, x):
        return self.fc2(quick_gelu(linear(x, self.fc1)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig | CLIPVisionConfig):
        super().__init__()
        self.self_attn = CLIPAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm1 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg.hidden_size, cfg.intermediate_size)
        self.layer_norm2 = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, x, causal: bool):
        x = x + self.self_attn(self.layer_norm1(x), causal)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(
            cfg.vocab_size + cfg.num_extra_embeddings, cfg.hidden_size
        )
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig | CLIPVisionConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg.num_layers))


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor, clip_skip: int = 0) -> dict:
        """input_ids: (B, 77) integer ids. Returns last_hidden_state,
        (clip-skipped) encoder_hidden_states for the UNet, and pooled_output;
        all fp32."""
        cfg = self.config
        tm = self.text_model
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        x = tm.embeddings.token_embedding(input_ids) + tm.embeddings.position_embedding(pos)
        skipped = None
        for i, layer in enumerate(tm.encoder.layers):
            x = layer(x, causal=True)
            if clip_skip > 0 and i == cfg.num_layers - 1 - clip_skip:
                skipped = x
        last = tm.final_layer_norm(x)
        encoder_states = tm.final_layer_norm(skipped) if skipped is not None else last
        eos_pos = (input_ids == cfg.eos_token_id).int().argmax(dim=1)
        pooled = last[torch.arange(last.shape[0], device=last.device), eos_pos]
        return {
            "last_hidden_state": last,
            "encoder_hidden_states": encoder_states,
            "pooled_output": pooled,
        }


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModelWithProjection(nn.Module):
    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)

    def forward(self, pixel_values: torch.Tensor) -> dict:
        """pixel_values: (B, H, W, 3) CLIP-normalised, channels last. Returns
        image_embeds (projected, in the weights' dtype), pooled_output and
        penultimate_hidden_states (fp32)."""
        vm = self.vision_model
        emb = vm.embeddings
        patches = conv_nhwc(pixel_values, emb.patch_embedding)
        B, C = patches.shape[0], patches.shape[-1]
        cls = emb.class_embedding.to(patches.dtype).expand(B, 1, C)
        x = torch.cat([cls, patches.reshape(B, -1, C)], dim=1)
        x = x + emb.position_embedding.weight[: x.shape[1]].to(x.dtype)
        x = vm.pre_layrnorm(x)
        penultimate = None
        for i, layer in enumerate(vm.encoder.layers):
            if i == len(vm.encoder.layers) - 1:
                penultimate = x
            x = layer(x, causal=False)
        pooled = vm.post_layernorm(x[:, 0])
        return {
            "image_embeds": linear(pooled, self.visual_projection),
            "pooled_output": pooled,
            "penultimate_hidden_states": penultimate,
        }
