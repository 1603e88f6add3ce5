"""IP-Adapter: image-prompt conditioning, in PyTorch.

Counterpart of `controlanimate_tpu/pipelines/ip_adapter.py`. A CLIP vision
tower (`models/clip.py` `CLIPVisionModelWithProjection`, its self-attention
on K1) embeds the anchor frame, a projection lifts the embedding to
`num_tokens` context tokens appended to the text, and each UNet
cross-attention runs a second K/V (`to_k_ip` / `to_v_ip`) over them, scaled
by `ipa_scale` (`models/layers.py` `Attention`).

  * The projections keep the upstream key layouts: `ImageProjModel` (base,
    `proj`, `norm`), `MLPProjModel` (full, `proj.0`, `proj.2`, `proj.3`) and
    the perceiver `Resampler` (plus, `latents`, `proj_in`, `layers.i.0.*`,
    `layers.i.1.{0,1,3}`, `proj_out`, `norm_out`). Their LayerNorms are
    torch's (eps 1e-5, computed in fp32), their GELU the exact erf.
  * `build_projection` tells base, plus, full, xl and plus-xl apart by the
    `image_proj` keys and shapes, as the JAX package does.
  * `preprocess_clip_image` resizes the uint8 anchor to 224x224 with
    OpenCV's INTER_CUBIC code path (`ops/resize.py` `resize_cubic`) on the
    frame's device, then divides by 255 and normalises with CLIP's mean and
    std.
  * `embed_images` runs the tower once for all anchors; the uncond tokens
    are computed once and cached (base: the projection of zero embeds;
    plus / full: of the penultimate states of a zero image).
  * The checkpoint's `ip_adapter` weights `{2k+1}.to_{k,v}_ip.weight` go to
    the k-th cross-attention in the checkpoint's order (down, up, mid).

JAX behaviour not copied: an image-encoder folder without `config.json`
raises FileNotFoundError (JAX builds the ViT-H/14 defaults), and a
checkpoint without an attn2's `to_k_ip` / `to_v_ip` raises ValueError naming
it (JAX leaves that attention's image stream at its random init).
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.clip import CLIPVisionConfig, CLIPVisionModelWithProjection, LayerNorm
from ..models.layers import linear
from ..ops.attention import reference_attention
from ..ops.resize import resize_cubic
from ..weights import ingest
from ..weights.clip_weights import vision_state_dict_from_torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
SDXL_CROSS_ATTENTION_DIM = 2048
DEFAULT_ENCODER = "models/IP-Adapter/image_encoder"
DEFAULT_CHECKPOINT = "models/IP-Adapter/ip-adapter_sd15.bin"


class ImageProjModel(nn.Module):
    """The global image embedding -> `num_tokens` context tokens."""

    def __init__(self, cross_attention_dim: int = 768, clip_embeddings_dim: int = 1024,
                 num_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.num_tokens = num_tokens
        self.proj = nn.Linear(clip_embeddings_dim, num_tokens * cross_attention_dim)
        self.norm = LayerNorm(cross_attention_dim)

    def forward(self, image_embeds):
        x = linear(image_embeds, self.proj)
        return self.norm(x.reshape(x.shape[0], self.num_tokens, self.cross_attention_dim))


class MLPProjModel(nn.Module):
    """IP-Adapter-Full: Linear, GELU, Linear, LayerNorm over each token."""

    def __init__(self, cross_attention_dim: int = 768, clip_embeddings_dim: int = 1280):
        super().__init__()
        self.proj = nn.Sequential(
            nn.Linear(clip_embeddings_dim, clip_embeddings_dim), nn.GELU(),
            nn.Linear(clip_embeddings_dim, cross_attention_dim), LayerNorm(cross_attention_dim))

    def forward(self, image_embeds):
        h = F.gelu(linear(image_embeds, self.proj[0]))
        h = self.proj[3](linear(h, self.proj[2]))
        return h[:, None, :] if h.ndim == 2 else h


class PerceiverAttention(nn.Module):
    """Queries from the latents; keys and values over [image tokens, latents]."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 16):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head = heads, dim_head
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        x, latents = self.norm1(x), self.norm2(latents)
        B, L, _ = latents.shape
        q = linear(latents, self.to_q).reshape(B, L, self.heads, self.dim_head)
        k, v = linear(torch.cat([x, latents], dim=-2), self.to_kv).chunk(2, dim=-1)
        k = k.reshape(B, -1, self.heads, self.dim_head)
        v = v.reshape(B, -1, self.heads, self.dim_head)
        out = reference_attention(q, k, v).reshape(B, L, self.heads * self.dim_head)
        return linear(out, self.to_out)


class _FeedForward(nn.Sequential):
    def forward(self, x):
        h = F.gelu(linear(self[0](x), self[1]))
        return linear(h, self[3])


class Resampler(nn.Module):
    """IP-Adapter-Plus: learned queries attend to the penultimate states."""

    def __init__(self, dim: int = 1024, depth: int = 4, dim_head: int = 64, heads: int = 16,
                 num_queries: int = 16, embedding_dim: int = 1280, output_dim: int = 768,
                 ff_mult: int = 4):
        super().__init__()
        self.depth, self.heads, self.dim_head, self.output_dim = depth, heads, dim_head, output_dim
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = LayerNorm(output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads), _FeedForward(
                LayerNorm(dim), nn.Linear(dim, dim * ff_mult, bias=False), nn.GELU(),
                nn.Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth))

    def forward(self, x):
        latents = self.latents.float().expand(x.shape[0], -1, -1)
        x = linear(x, self.proj_in)
        for attn, ff in self.layers:
            latents = latents + attn(x, latents)
            latents = latents + ff(latents)
        return self.norm_out(linear(latents, self.proj_out))


def preprocess_clip_image(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, size, size, 3) CLIP-normalised float32, on
    the frames' device (`cv2.resize(..., INTER_CUBIC)`, / 255, mean, std)."""
    img = resize_cubic(frames, size, size).float() / 255.0
    mean = torch.from_numpy(CLIP_MEAN).to(img.device)
    std = torch.from_numpy(CLIP_STD).to(img.device)
    return (img - mean) / std


class Projection(NamedTuple):
    """What `build_projection` finds: the projection (weights loaded), its
    token count, the tower output it takes, and the checkpoint variant
    (base | plus | full | xl | plus-xl)."""

    model: nn.Module
    num_tokens: int
    embed_source: str
    variant: str


def build_projection(image_proj_sd: dict, vcfg: Optional[CLIPVisionConfig],
                     cross_attention_dim: int = 768, device="cpu",
                     dtype: torch.dtype = torch.float32) -> Projection:
    """The projection of an `image_proj` state dict (its prefix stripped),
    detected from its keys as the JAX `IPAdapter.build_projection` does:
    `latents` -> Resampler (plus, or plus-xl with a 2048-wide `proj_out`;
    64-wide heads), `proj.0.weight` -> MLPProjModel (full, one token per
    vision token: `vcfg` needed), `proj.weight` -> ImageProjModel (base, or
    xl when its rows are a multiple of 2048 and not of the cross-attention
    width). Its weights on `device` in `dtype` (KeyError for a missing one).
    ValueError for another layout or rows of neither width."""
    sd = {k: torch.as_tensor(v) for k, v in image_proj_sd.items()}

    def loaded(make) -> nn.Module:
        return ingest.build_module(make, sd, device, dtype,
                                   lambda state, keys: {k: state[k] for k in keys}).eval()

    if "latents" in sd:
        latents = sd["latents"]
        dim_head = 64
        depth = len({k.split(".")[1] for k in sd if k.startswith("layers.")})
        output_dim = int(sd["proj_out.weight"].shape[0])
        kw = dict(dim=int(latents.shape[-1]), depth=depth, dim_head=dim_head,
                  heads=int(sd["layers.0.0.to_q.weight"].shape[0]) // dim_head,
                  num_queries=int(latents.shape[1]),
                  embedding_dim=int(sd["proj_in.weight"].shape[1]), output_dim=output_dim)
        variant = "plus-xl" if output_dim == SDXL_CROSS_ATTENTION_DIM else "plus"
        return Projection(loaded(lambda: Resampler(**kw)), kw["num_queries"],
                          "penultimate", variant)
    if "proj.0.weight" in sd:
        if vcfg is None:
            raise ValueError("IP-Adapter-Full needs the vision config to determine its "
                             "token count")
        cross, clip_dim = (int(n) for n in sd["proj.2.weight"].shape)
        model = loaded(lambda: MLPProjModel(cross, clip_dim))
        return Projection(model, (vcfg.image_size // vcfg.patch_size) ** 2 + 1,
                          "penultimate", "full")
    if "proj.weight" in sd:
        rows, clip_dim = (int(n) for n in sd["proj.weight"].shape)
        cross = cross_attention_dim
        if rows % cross:
            if rows % SDXL_CROSS_ATTENTION_DIM:
                raise ValueError(
                    f"IP-Adapter proj.weight has {rows} rows, not a multiple of "
                    f"cross-attention dim {cross} (SD1.5) or {SDXL_CROSS_ATTENTION_DIM} (SDXL)")
            cross = SDXL_CROSS_ATTENTION_DIM
        variant = "xl" if cross == SDXL_CROSS_ATTENTION_DIM else "base"
        model = loaded(lambda: ImageProjModel(cross, clip_dim, rows // cross))
        return Projection(model, rows // cross, "image_embeds", variant)
    raise ValueError(f"unrecognized IP-Adapter image_proj layout: {sorted(sd)[:6]}...")


def attn2_paths_in_checkpoint_order(ucfg) -> list[str]:
    """The UNet's cross-attention blocks in the checkpoint's numbering
    (diffusers' SD1.5 module order: down blocks, up blocks, mid block)."""
    paths = [f"down_blocks.{i}.attentions.{j}"
             for i, bt in enumerate(ucfg.down_block_types) if bt.startswith("CrossAttn")
             for j in range(ucfg.layers_per_block)]
    paths += [f"up_blocks.{i}.attentions.{j}"
              for i, bt in enumerate(ucfg.up_block_types) if bt.startswith("CrossAttn")
              for j in range(ucfg.layers_per_block + 1)]
    return paths + ["mid_block.attentions.0"]


class IPAdapter:
    """The CLIP vision tower, the projection and the UNet's K/V weights."""

    def __init__(self, vision_model: Optional[CLIPVisionModelWithProjection],
                 proj_model: nn.Module, ip_sd: Optional[dict] = None, num_tokens: int = 4,
                 embed_source: str = "image_embeds", variant: str = "base"):
        self.vision_model = vision_model
        self.proj_model = proj_model
        self.ip_sd = ip_sd or {}
        self.num_tokens = num_tokens
        self.embed_source = embed_source
        self.variant = variant
        self._uncond_cache: Optional[torch.Tensor] = None

    @classmethod
    def from_config(cls, config, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> "IPAdapter":
        """From `ipadapter_ckpt_path` (its `image_proj.*` and `ip_adapter.*`
        weights) and the HF image-encoder folder `ipadapter_image_encoder_path`
        (config.json, its `vision_config` when nested, and one weights
        file set), the JAX package's default paths when unset; the tower and
        projection on `device` in `dtype`. The layout is told by SD1.5's
        768-wide cross-attention, as in JAX. FileNotFoundError for a missing
        file."""
        enc_path = config.ipadapter_image_encoder_path or DEFAULT_ENCODER
        ckpt_path = Path(config.ipadapter_ckpt_path or DEFAULT_CHECKPOINT)
        if not ckpt_path.is_file():
            raise FileNotFoundError(f"IP-Adapter checkpoint {ckpt_path} not found")
        sd = ingest.load_state_dict(ckpt_path)
        image_proj = {k[len("image_proj."):]: v for k, v in sd.items()
                      if k.startswith("image_proj.")}
        ip_sd = {k[len("ip_adapter."):]: v for k, v in sd.items() if k.startswith("ip_adapter.")}
        enc_json, enc_sd = ingest.load_hf_component(enc_path, "")
        vcfg = CLIPVisionConfig.from_json(enc_json.get("vision_config", enc_json))
        vision = ingest.build_module(lambda: CLIPVisionModelWithProjection(vcfg), enc_sd,
                                     device, dtype, vision_state_dict_from_torch)
        proj = build_projection(image_proj, vcfg, device=device, dtype=dtype)
        return cls(vision.eval(), proj.model, ip_sd, proj.num_tokens, proj.embed_source,
                   proj.variant)

    def to(self, device, dtype: torch.dtype) -> "IPAdapter":
        """The tower and projection moved to `device` in `dtype`."""
        if self.vision_model is not None:
            self.vision_model.to(device=device, dtype=dtype).eval()
        self.proj_model.to(device=device, dtype=dtype).eval()
        self._uncond_cache = None
        return self

    # -- embeds ----------------------------------------------------------------
    @torch.no_grad()
    def project(self, image_embeds: torch.Tensor) -> torch.Tensor:
        return self.proj_model(image_embeds)

    def embed_image(self, frame) -> tuple[torch.Tensor, torch.Tensor]:
        """An anchor (H, W, 3) uint8 -> (cond, uncond) tokens, each (1,
        num_tokens, width) in the adapter's dtype: `embed_images` of one
        frame."""
        return self.embed_images(torch.as_tensor(frame)[None])

    @torch.no_grad()
    def embed_images(self, frames) -> tuple[torch.Tensor, torch.Tensor]:
        """Anchors (S, H, W, 3) uint8 (numpy or tensor) -> (cond, uncond),
        each (S, num_tokens, width) in the tower's and projection's dtype
        (the facade casts them to the prompt's), from one run of the tower;
        the uncond tokens depend on no anchor and are computed once."""
        if self.vision_model is None:
            raise RuntimeError("IPAdapter built without a vision tower")
        weight = self.vision_model.visual_projection.weight
        px = preprocess_clip_image(torch.as_tensor(frames).to(weight.device)).to(weight.dtype)
        out = self.vision_model(px)
        if self.embed_source == "penultimate":
            cond = self.project(out["penultimate_hidden_states"])
            if self._uncond_cache is None:
                zero = self.vision_model(torch.zeros_like(px[:1]))
                self._uncond_cache = self.project(zero["penultimate_hidden_states"])
        else:
            cond = self.project(out["image_embeds"])
            if self._uncond_cache is None:
                self._uncond_cache = self.project(torch.zeros_like(out["image_embeds"][:1]))
        uncond = self._uncond_cache
        return cond, uncond.expand(px.shape[0], *uncond.shape[1:])

    # -- the UNet's image stream -------------------------------------------------
    def unet_weights(self, ucfg) -> dict[str, torch.Tensor]:
        """The checkpoint's `{2k+1}.to_{k,v}_ip.weight` under the UNet's
        keys of its k-th cross-attention; ValueError naming the first
        cross-attention the checkpoint has no weights for."""
        out = {}
        for idx, path in enumerate(attn2_paths_in_checkpoint_order(ucfg)):
            for name in ("to_k_ip", "to_v_ip"):
                src = f"{2 * idx + 1}.{name}.weight"
                if src not in self.ip_sd:
                    raise ValueError(f"the IP-Adapter checkpoint has no ip_adapter.{src} for "
                                     f"the cross-attention {path}")
                out[f"{path}.transformer_blocks.0.attn2.{name}.weight"] = self.ip_sd[src]
        return out

    def inject(self, unet: nn.Module) -> None:
        """Copy `unet_weights` into a built UNet whose cross-attentions take
        this adapter's tokens (ValueError otherwise)."""
        if unet.config.ip_tokens != self.num_tokens:
            raise ValueError(f"the UNet takes {unet.config.ip_tokens} image tokens, the "
                             f"IP-Adapter gives {self.num_tokens}")
        with torch.no_grad():
            for key, w in self.unet_weights(unet.config).items():
                unet.get_parameter(key).copy_(torch.as_tensor(w))
