"""DPT, the depth annotator's network with a plain ViT backbone
(Intel/dpt-large's layout), and the parts DPT-hybrid shares with it.

Counterpart of `controlanimate_tpu/models/annotators/dpt.py` (`DPTDepth`,
transformers' DPTForDepthEstimation without `is_hybrid`). It runs in fp32
without TF32, the F frames as one batch.

Backbone: a `patch` x `patch` stride-`patch` conv embeds the image; the
class token leads the patch tokens and the position table is added as it
is stored, so it must hold (H / patch) * (W / patch) + 1 rows (577 at the
annotator's 384x384). `num_layers` pre-LayerNorm ViT layers (`ViTLayer`,
eps 1e-12, exact GELU), their self-attention through
`ops/attention.py` `dot_product_attention`, so on the card K1 at head dim
hidden / heads (64 for ViT-L). The hidden states after the layers named in
`taps` (in layer order) feed the neck.

Neck (`DPTNeck`): the 'project' readout (each token beside the class
token, a Linear of 2C -> C and exact GELU) to a (C, gh, gw) map, a 1x1
projection to `neck_hidden[i]`, and a resize by `REASSEMBLE_FACTORS`: a
transposed conv of kernel = stride 4 and 2 (run as a forward conv to the k
* k phases and a pixel shuffle, `edge_nets.py` `up_by_stride`, so that a
map repeats exactly), none, and a 3x3 stride-2 conv; then a bias-free 3x3
conv to `fusion_hidden` each. Four `DPTFusionLayer`s fuse them from the
deepest up, each ending in a bilinear 2x resize with aligned corners. The
head: a 3x3 conv to fusion_hidden / 2, a bilinear 2x resize at half-pixel
centres, a 3x3 conv to 32, ReLU, a 1x1 conv to 1, ReLU. That resize copies
JAX's `jax.image.resize` (`dpt.py:165`), where transformers resizes with
aligned corners (ROADMAP §3 (au)).

Module names follow the transformers checkpoint's keys (`dpt.embeddings.*`,
`dpt.encoder.layer.{i}.*`, `neck.reassemble_stage.*`, `neck.convs.*`,
`neck.fusion_stage.layers.*`, `head.head.{0,2,4}`), so a file loads with
plain `load_state_dict`; `backbone.`-prefixed keys are read as `dpt.`, as
the JAX loader reads either (`dpt_params_from_torch`), and the keys in
`UNUSED_KEYS` are dropped by name.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.attention import dot_product_attention
from ...ops.resize import resize_cubic
from .edge_nets import up_by_stride

LAYER_NORM_EPS = 1e-12
NET_SIZE = 384  # every frame goes in at 384x384, whatever the config says (as JAX)
# the plain net's resize of each neck level (JAX `dpt.py:136-149`)
REASSEMBLE_FACTORS = (4, 2, 1, 0.5)
# keys an upstream checkpoint may hold that no module here reads: the
# pooler, and the deepest fusion layer's residual_layer1 (it has no skip)
UNUSED_KEYS = ("dpt.pooler.", "neck.fusion_stage.layers.0.residual_layer1.")


@dataclass(frozen=True)
class DPTConfig:
    """The plain net's geometry (Intel/dpt-large by default)."""

    hidden_size: int = 1024
    num_layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    patch: int = 16
    taps: tuple = (5, 11, 17, 23)
    neck_hidden: tuple = (256, 512, 1024, 1024)
    fusion_hidden: int = 256

    @classmethod
    def from_json(cls, cfg: dict) -> "DPTConfig":
        """The keys `load_flax_dpt` reads, with its defaults."""
        d = cls()
        return cls(hidden_size=cfg.get("hidden_size", d.hidden_size),
                   num_layers=cfg.get("num_hidden_layers", d.num_layers),
                   heads=cfg.get("num_attention_heads", d.heads),
                   mlp_dim=cfg.get("intermediate_size", d.mlp_dim),
                   patch=cfg.get("patch_size", d.patch),
                   taps=tuple(cfg.get("backbone_out_indices", d.taps)),
                   neck_hidden=tuple(cfg.get("neck_hidden_sizes", d.neck_hidden)),
                   fusion_hidden=cfg.get("fusion_hidden_size", d.fusion_hidden))


DPT_LARGE = DPTConfig()


class _Dense(nn.Module):
    """A Linear under the name `dense` (transformers' ViT output modules)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.dense = nn.Linear(cin, cout)

    def forward(self, x):
        return self.dense(x)


class _SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)


class _Attention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.attention = _SelfAttention(hidden)
        self.output = _Dense(hidden, hidden)


class ViTLayer(nn.Module):
    """x + attn(LN(x)), then + MLP(LN(x)) with exact GELU; (B, N, C)."""

    def __init__(self, hidden: int, heads: int, mlp_dim: int):
        super().__init__()
        self.heads = heads
        self.layernorm_before = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.attention = _Attention(hidden)
        self.layernorm_after = nn.LayerNorm(hidden, eps=LAYER_NORM_EPS)
        self.intermediate = _Dense(hidden, mlp_dim)
        self.output = _Dense(mlp_dim, hidden)

    def forward(self, x):
        B, N, C = x.shape
        h = self.layernorm_before(x)
        sa = self.attention.attention
        q, k, v = (lin(h).reshape(B, N, self.heads, C // self.heads)
                   for lin in (sa.query, sa.key, sa.value))
        x = x + self.attention.output(dot_product_attention(q, k, v).reshape(B, N, C))
        return x + self.output(F.gelu(self.intermediate(self.layernorm_after(x))))


class ViTEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.layer = nn.ModuleList(ViTLayer(cfg.hidden_size, cfg.heads, cfg.mlp_dim)
                                   for _ in range(cfg.num_layers))

    def forward(self, h, taps) -> dict:
        """The hidden states after each layer in `taps`, by layer."""
        out = {}
        for i, layer in enumerate(self.layer):
            h = layer(h)
            if i in taps:
                out[i] = h
        return out


def _align_corners_axis(x: torch.Tensor, new: int, dim: int) -> torch.Tensor:
    old = x.shape[dim]
    if old == 1:
        return x.repeat_interleave(new, dim)
    # the source position in fp32 as JAX computes it, i * (old - 1) / (new
    # - 1) rounded once (F.interpolate rounds the scale first, then its
    # product, up to 4e-6 off at unit-scale values)
    pos = (torch.arange(new, device=x.device) * (old - 1)).to(torch.float32) / (new - 1)
    lo = pos.floor().to(torch.int64)
    hi = (lo + 1).clamp_max(old - 1)
    w = (pos - lo).to(x.dtype).reshape(-1, *(1,) * (x.ndim - dim - 1))
    return x.index_select(dim, lo) * (1 - w) + x.index_select(dim, hi) * w


def resize_align_corners(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Bilinear with aligned corners over (B, C, H, W), rows then columns,
    as JAX `_resize_align_corners` computes it (a side of one pixel is
    repeated)."""
    return _align_corners_axis(_align_corners_axis(x, h, 2), w, 3)


def _jax_bilinear_weights(old: int, new: int, device) -> torch.Tensor:
    """JAX `compute_weight_mat` for the triangle kernel with antialias, in
    fp32 as it computes it: (old, new), each column the weights of one
    output pixel (half-pixel centres, the kernel widened by old / new where
    the side shrinks, the taps past an edge dropped and the rest
    renormalised)."""
    inv = 1.0 / (new / old)
    sample = (torch.arange(new, dtype=torch.float32, device=device) + 0.5) * inv - 0.5
    dist = (sample[None] - torch.arange(old, dtype=torch.float32, device=device)[:, None]).abs()
    weights = (1.0 - dist / max(inv, 1.0)).clamp_min(0.0)
    total = weights.sum(0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where((sample >= -0.5) & (sample <= old - 0.5), weights, 0.0)


def resize_half_pixel(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(x, ..., "bilinear")` over (B, C, H, W): half-pixel
    centres, the weights of taps past an edge dropped. Where no side
    shrinks that is `F.interpolate` (within 1e-6 of JAX); where one does,
    JAX antialiases, and its weight matrices are applied as it applies
    them (`F.interpolate(antialias=True)` differs by up to 2e-6 at unit
    scale)."""
    if h >= x.shape[2] and w >= x.shape[3]:
        return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
    return torch.einsum("bchw,hy,wx->bcyx", x, _jax_bilinear_weights(x.shape[2], h, x.device),
                        _jax_bilinear_weights(x.shape[3], w, x.device))


class HalfPixelUp2x(nn.Module):
    """The head's 2x resize, at half-pixel centres as JAX's head takes it."""

    def forward(self, x):
        return resize_half_pixel(x, 2 * x.shape[2], 2 * x.shape[3])


class DPTPreActResidual(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.convolution1 = nn.Conv2d(channels, channels, 3, padding=1)
        self.convolution2 = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return x + self.convolution2(F.relu(self.convolution1(F.relu(x))))


class DPTFusionLayer(nn.Module):
    """[x + residual_layer1(skip)] -> residual_layer2 -> 2x aligned-corner
    resize -> 1x1 projection. A skip of another size than x is taken to
    x's size first (`resize_half_pixel`, JAX `dpt.py:79-80`)."""

    def __init__(self, channels: int, skip: bool = True):
        super().__init__()
        self.projection = nn.Conv2d(channels, channels, 1)
        if skip:
            self.residual_layer1 = DPTPreActResidual(channels)
        self.residual_layer2 = DPTPreActResidual(channels)

    def forward(self, x, skip=None):
        if skip is not None:
            if skip.shape[2:] != x.shape[2:]:
                skip = resize_half_pixel(skip, *x.shape[2:])
            x = x + self.residual_layer1(skip)
        x = self.residual_layer2(x)
        return self.projection(resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3]))


class ReassembleLayer(nn.Module):
    """The 1x1 projection, then the resize of `factor`."""

    def __init__(self, hidden: int, channels: int, factor: float):
        super().__init__()
        self.factor = factor
        self.projection = nn.Conv2d(hidden, channels, 1)
        if factor > 1:
            self.resize = nn.ConvTranspose2d(channels, channels, int(factor), stride=int(factor))
        elif factor < 1:
            self.resize = nn.Conv2d(channels, channels, 3, stride=round(1 / factor), padding=1)

    def forward(self, x):
        x = self.projection(x)
        if self.factor > 1:
            return up_by_stride(x, self.resize)
        return self.resize(x) if self.factor < 1 else x


class ReassembleStage(nn.Module):
    """Levels from `first` on take ViT hidden states through the 'project'
    readout and a `ReassembleLayer`; the levels before it (DPT-hybrid's BiT
    maps) pass as they are."""

    def __init__(self, hidden: int, neck_hidden, factors, first: int = 0):
        super().__init__()
        self.first = first
        self.readout_projects = nn.ModuleList(
            nn.Identity() if li < first else nn.Sequential(nn.Linear(2 * hidden, hidden),
                                                           nn.GELU())
            for li in range(len(neck_hidden)))
        self.layers = nn.ModuleList(
            nn.Identity() if li < first else ReassembleLayer(hidden, neck_hidden[li], factor)
            for li, factor in enumerate(factors))

    def forward(self, states: list, grid: tuple[int, int]) -> list:
        out = []
        for li, s in enumerate(states):
            if li >= self.first:
                cls, tokens = s[:, :1], s[:, 1:]
                r = self.readout_projects[li](torch.cat([tokens, cls.expand_as(tokens)], -1))
                s = self.layers[li](r.unflatten(1, grid).permute(0, 3, 1, 2))
            out.append(s)
        return out


class _FusionStage(nn.Module):
    def __init__(self, channels: int, levels: int):
        super().__init__()
        self.layers = nn.ModuleList(DPTFusionLayer(channels, skip=j > 0) for j in range(levels))


class DPTNeck(nn.Module):
    """Reassemble, a bias-free 3x3 conv a level, and the fusion from the
    deepest level up (`fusion_stage.layers.j` is JAX's `fusion_{3 - j}`)."""

    def __init__(self, hidden: int, neck_hidden, factors, fusion_hidden: int, first: int = 0):
        super().__init__()
        self.reassemble_stage = ReassembleStage(hidden, neck_hidden, factors, first)
        self.convs = nn.ModuleList(nn.Conv2d(c, fusion_hidden, 3, padding=1, bias=False)
                                   for c in neck_hidden)
        self.fusion_stage = _FusionStage(fusion_hidden, len(neck_hidden))

    def forward(self, states: list, grid: tuple[int, int]) -> torch.Tensor:
        feats = [conv(f) for conv, f in zip(self.convs, self.reassemble_stage(states, grid))]
        fused = None
        for layer, f in zip(self.fusion_stage.layers, feats[::-1]):
            fused = layer(f) if fused is None else layer(fused, f)
        return fused


class DepthHead(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.head = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, padding=1), HalfPixelUp2x(),
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(),
            nn.Conv2d(32, 1, 1), nn.ReLU())

    def forward(self, x):
        return self.head(x)[:, 0]


class _PatchEmbeddings(nn.Module):
    def __init__(self, hidden: int, patch: int):
        super().__init__()
        self.projection = nn.Conv2d(3, hidden, patch, stride=patch)


class _Embeddings(nn.Module):
    def __init__(self, cfg: DPTConfig, positions: int):
        super().__init__()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.hidden_size))
        self.position_embeddings = nn.Parameter(torch.zeros(1, positions, cfg.hidden_size))
        self.patch_embeddings = _PatchEmbeddings(cfg.hidden_size, cfg.patch)


class _ViT(nn.Module):
    def __init__(self, cfg: DPTConfig, positions: int):
        super().__init__()
        self.embeddings = _Embeddings(cfg, positions)
        self.encoder = ViTEncoder(cfg)


def with_class_token(embeddings: nn.Module, tokens: torch.Tensor, pos: torch.Tensor):
    """[class token, tokens] + the position table."""
    cls = embeddings.cls_token.expand(tokens.shape[0], -1, -1)
    return torch.cat([cls, tokens], 1) + pos


def network_input(frames: torch.Tensor, size: int = NET_SIZE) -> torch.Tensor:
    """A DPT's input: (F, H, W, 3) uint8 -> (F, 3, size, size) float32,
    INTER_CUBIC, then (x / 255 - 0.5) / 0.5."""
    x = resize_cubic(frames, size, size).to(torch.float32)
    return ((x / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous()


class DPTDepth(nn.Module):
    """x: (B, 3, H, W) normalised RGB -> (B, H, W) relative depth, its
    position table of `positions` rows (577: a 384x384 input at patch 16)."""

    network_input = staticmethod(network_input)  # frames -> x, the annotator's

    def __init__(self, cfg: DPTConfig = DPT_LARGE, positions: int = 577):
        super().__init__()
        if len(set(cfg.taps)) != 4 or not all(0 <= t < cfg.num_layers for t in cfg.taps):
            raise ValueError(f"the plain DPT taps four distinct ViT layers of "
                             f"{cfg.num_layers}, not {cfg.taps}")
        self.cfg = cfg
        self.dpt = _ViT(cfg, positions)
        self.neck = DPTNeck(cfg.hidden_size, cfg.neck_hidden, REASSEMBLE_FACTORS,
                            cfg.fusion_hidden)
        self.head = DepthHead(cfg.fusion_hidden)

    def forward(self, x):
        emb = self.dpt.embeddings
        grid = (x.shape[2] // self.cfg.patch, x.shape[3] // self.cfg.patch)
        pos = emb.position_embeddings
        if pos.shape[1] != grid[0] * grid[1] + 1:
            raise ValueError(f"the position table holds {pos.shape[1]} rows; a {x.shape[2]}x"
                             f"{x.shape[3]} input needs {grid[0] * grid[1] + 1}")
        tokens = emb.patch_embeddings.projection(x).flatten(2).transpose(1, 2)
        taps = self.dpt.encoder(with_class_token(emb, tokens, pos), self.cfg.taps)
        return self.head(self.neck([taps[i] for i in sorted(taps)], grid))


def dpt_keys(sd: dict) -> dict:
    """A transformers DPT state dict -> this module's keys: `backbone.` read
    as `dpt.`, the `UNUSED_KEYS` dropped."""
    out = {}
    for k, v in sd.items():
        if k.startswith("backbone."):
            k = "dpt." + k.removeprefix("backbone.")
        if not k.startswith(UNUSED_KEYS):
            out[k] = v
    return out


def load_depth_model(make, sd: dict) -> nn.Module:
    """`make()` with the fp32 weights of `sd` (this module's keys) on the
    host: a missing weight raises KeyError naming it (a BatchNorm's
    `num_batches_tracked`, which no network reads, may be absent); an
    unexpected one, or a shape off the config, RuntimeError."""
    with torch.device("meta"):
        model = make()
    missing = [k for k in model.state_dict()
               if k not in sd and not k.endswith(".num_batches_tracked")]
    if missing:
        raise KeyError(f"the depth checkpoint lacks {missing[0]!r} ({len(missing)} missing)")
    model.load_state_dict({k: v.to(device="cpu", dtype=torch.float32) for k, v in sd.items()},
                          strict=True, assign=True)
    return model.eval()
