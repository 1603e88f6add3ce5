"""The depth annotator of the ControlNets: DPT, DPT-hybrid or GLPN from a
local transformers folder.

Counterpart of `controlanimate_tpu/models/annotators/depth.py` `run` and
the three `run_flax` (`dpt.py`, `dpt_hybrid.py`, `glpn.py`).
`DepthAnnotator.from_dir` reads the folder's `config.json` once and builds
the network it names: `model_type` "dpt" without `is_hybrid` the plain
ViT-L net (`dpt.py`), with it the BiT + ViT-B hybrid (`dpt_hybrid.py`),
"glpn" the MiT encoder and selective-fusion decoder (`glpn.py`); its
weights are the folder's `model.safetensors` (or another file set that
`weights/ingest.py` `load_hf_component` reads). Where the JAX package tries
the plain net, the hybrid and GLPN in turn, each passing on a missing
weight, and then a host `transformers` model, the port never falls to
another network (ROADMAP §3 (ar), (as)):
  - a `model_type` other than "dpt" or "glpn" raises ValueError naming it;
  - a missing weight raises KeyError naming it;
  - a plain net's position table that does not hold the 384x384 grid
    raises ValueError naming both sizes (JAX fails there with a broadcast
    error);
  - the keys JAX never reads must be the constants its networks assume,
    else ValueError naming the key (§3 (at), (av)): a DPT's
    `readout_type`, `hidden_act` and `layer_norm_eps` ("project", "gelu",
    1e-12); GLPN's `hidden_act` ("gelu"), `head_in_index` (-1),
    `num_channels` (3) and `num_encoder_blocks` (the number of
    `hidden_sizes`); a GLPN stage key that is not a list of one value a
    stage, or a width that its heads do not divide, raises ValueError
    naming it;
  - on the card, a GLPN stage whose head dim K1 does not take raises
    ValueError naming the stage before any weight is read (no plain
    attention on the card).
The folder is CONTROLANIMATE_DEPTH_MODEL's, default `models/annotators/
depth` from the working directory, as in JAX (not
CONTROLANIMATE_ANNOTATOR_DIR); a missing folder raises FileNotFoundError.

The call maps (F, H, W, 3) uint8 frames to (F, H, W, 3) float32 maps in
[0, 1] on the frames' device, as `run_flax` does: each frame resized by
OpenCV's INTER_CUBIC (`ops/resize.py` `resize_cubic`), for DPT to 384x384
and (x / 255 - 0.5) / 0.5, for GLPN to the sides snapped down to multiples
of 32 (at least 32) and x / 255; the network in fp32 without TF32 on the F
frames as one batch, or in batches of `CHUNK` (16, a window; the segment
path's S * F frames would not fit on the card at once), its attention on
K1's fp32 plan on the card; each map back to (H, W) by INTER_CUBIC, then
(d - min) / max(max - min, 1e-8) a frame, repeated to 3 channels
(`depth_maps`, the tail the networks share).
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import torch
from torch import nn

from ...ops.resize import resize_cubic
from ...ops.warp import fp32_convs
from ...weights import ingest
# network_input and glpn_input, the networks' input transforms, are named
# here too for the callers that make a network's input themselves
from .dpt import NET_SIZE, DPTConfig, DPTDepth, dpt_keys, load_depth_model, network_input
from .dpt_hybrid import DPTHybridConfig, DPTHybridDepth, standardize_weights_
from .glpn import GLPNConfig, check_head_dims, glpn_input, glpn_network

MODEL_ENV = "CONTROLANIMATE_DEPTH_MODEL"
DEFAULT_MODEL = "models/annotators/depth"
# frames a network call: one 16-frame window peaks near 21 GB above what is
# resident (chip_smoke.py on an H100, fp32, TF32 off), so the segment
# path's S * F frames go through a window's worth at a time
CHUNK = 16
# the config keys JAX never reads, and the values its networks assume
JAX_CONSTANTS = {"readout_type": "project", "hidden_act": "gelu", "layer_norm_eps": 1e-12}
GLPN_CONSTANTS = {"hidden_act": "gelu", "head_in_index": -1, "num_channels": 3}
# GLPN's keys of one value a stage
GLPN_STAGE_KEYS = ("hidden_sizes", "depths", "sr_ratios", "num_attention_heads", "patch_sizes",
                   "strides", "mlp_ratios")


def model_path() -> Path:
    return Path(os.environ.get(MODEL_ENV, DEFAULT_MODEL))


def _check_constants(cfg: dict, constants: dict) -> None:
    for key, value in constants.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"the depth config's {key} is {cfg[key]!r}; the networks take "
                             f"{value!r}")


def check_config(cfg: dict) -> None:
    """The network `cfg` names must be one the port builds, with the
    constants JAX's networks assume."""
    kind = cfg.get("model_type")
    if kind == "glpn":
        hidden = cfg.get("hidden_sizes", list(GLPNConfig().hidden_sizes))
        blocks = len(hidden) if isinstance(hidden, list) else 0
        for key in GLPN_STAGE_KEYS:
            value = cfg.get(key)
            if value is not None and (not isinstance(value, list) or len(value) != blocks):
                raise ValueError(f"the GLPN config's {key} is {cfg[key]!r}, not a list of one "
                                 f"value for each of its {blocks} stages")
        _check_constants(cfg, {**GLPN_CONSTANTS, "num_encoder_blocks": blocks})
        gcfg = GLPNConfig.from_json(cfg)
        for i, (c, h) in enumerate(zip(gcfg.hidden_sizes, gcfg.heads)):
            if c % h:
                raise ValueError(f"GLPN stage {i}: its width {c} is not a multiple of its "
                                 f"{h} heads")
        return
    if kind != "dpt":
        raise ValueError(f"the depth annotator reads model_type 'dpt' or 'glpn', not {kind!r}")
    _check_constants(cfg, JAX_CONSTANTS)


def depth_network(cfg: dict, sd: dict, device, size: int = NET_SIZE) -> nn.Module:
    """The fp32 network of a checked `config.json` and its transformers-keyed
    state dict for `size` x `size` inputs (a DPT's; GLPN takes any multiple
    of 32), built (a hybrid's weights standardised, GLPN's BatchNorms
    folded) on the host, then moved to `device`."""
    if cfg.get("model_type") == "glpn":
        return glpn_network(GLPNConfig.from_json(cfg), sd).to(device)
    sd = dpt_keys(sd)
    table = sd.get("dpt.embeddings.position_embeddings")
    if table is None:
        raise KeyError("the depth checkpoint lacks 'dpt.embeddings.position_embeddings'")
    positions = table.shape[1]
    if cfg.get("is_hybrid", False):
        hcfg = DPTHybridConfig.from_json(cfg)
        net = standardize_weights_(load_depth_model(lambda: DPTHybridDepth(hcfg, positions), sd))
        return net.to(device)
    dcfg = DPTConfig.from_json(cfg)
    grid = size // dcfg.patch
    if positions != grid * grid + 1:
        raise ValueError(f"the plain DPT's position table holds {positions} rows; its "
                         f"{size}x{size} input at patch {dcfg.patch} needs {grid * grid + 1}")
    return load_depth_model(lambda: DPTDepth(dcfg, positions), sd).to(device)


def depth_maps(model: nn.Module, x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The network's (F, 3, h, w) input -> (F, H, W, 3) float32 min-max maps
    (module docstring), the network on CHUNK frames at a time (each frame's
    map is its own: nothing in the networks mixes frames)."""
    with fp32_convs():
        d = torch.cat([model(x[i:i + CHUNK]) for i in range(0, len(x), CHUNK)])
    d = resize_cubic(d[..., None].contiguous(), H, W)[..., 0]
    lo = d.amin((1, 2), keepdim=True)
    d = (d - lo) / (d.amax((1, 2), keepdim=True) - lo).clamp_min(1e-8)
    return d[..., None].expand(len(x), H, W, 3).contiguous()


class DepthAnnotator:
    """The `depth` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 depth maps in [0, 1] on the frames' device; the network's own
    `network_input` makes its input from the frames."""

    def __init__(self, model: nn.Module):
        self.model = model.float().eval()

    @classmethod
    def from_dir(cls, path, device="cuda") -> "DepthAnnotator":
        path = Path(path)
        if not (path / "config.json").is_file():
            raise FileNotFoundError(f"the depth annotator needs a local DPT or GLPN folder "
                                    f"(config.json and weights) at {path}")
        cfg = json.loads((path / "config.json").read_text())
        check_config(cfg)  # before any weight is read
        if cfg["model_type"] == "glpn" and torch.device(device).type == "cuda":
            check_head_dims(GLPNConfig.from_json(cfg))
        sd = {}
        for f in ingest.component_weight_files(path):
            sd.update(ingest.load_state_dict(f))
        return cls(depth_network(cfg, sd, device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        return depth_maps(self.model, self.model.network_input(frames), *frames.shape[1:3])
