"""The depth annotator of the ControlNets: DPT or DPT-hybrid from a local
transformers folder.

Counterpart of `controlanimate_tpu/models/annotators/depth.py` `run` and
the two `run_flax` (`dpt.py`, `dpt_hybrid.py`). `DepthAnnotator.from_dir`
reads the folder's `config.json` once and builds the network it names:
`model_type` "dpt" without `is_hybrid` the plain ViT-L net (`dpt.py`),
with it the BiT + ViT-B hybrid (`dpt_hybrid.py`); its weights are the
folder's `model.safetensors` (or another file set that
`weights/ingest.py` `load_hf_component` reads). Where the JAX package tries
the plain net, the hybrid and GLPN in turn, each passing on a missing
weight, and then a host `transformers` model, the port never falls to
another network (ROADMAP §3 (ar), (as)):
  - `model_type` "glpn" raises NotImplementedError (M13c-4), any other
    ValueError naming it;
  - a missing weight raises KeyError naming it;
  - a plain net's position table that does not hold the 384x384 grid
    raises ValueError naming both sizes (JAX fails there with a broadcast
    error);
  - `readout_type`, `hidden_act` and `layer_norm_eps`, which JAX never
    reads, must be the constants JAX uses ("project", "gelu", 1e-12), else
    ValueError naming the key (§3 (at)).
The folder is CONTROLANIMATE_DEPTH_MODEL's, default `models/annotators/
depth` from the working directory, as in JAX (not
CONTROLANIMATE_ANNOTATOR_DIR); a missing folder raises FileNotFoundError.

The call maps (F, H, W, 3) uint8 frames to (F, H, W, 3) float32 maps in
[0, 1] on the frames' device, as `run_flax` does: each frame to 384x384 by
OpenCV's INTER_CUBIC (`ops/resize.py` `resize_cubic`), (x / 255 - 0.5) /
0.5, the network in fp32 without TF32 on the F frames as one batch, or in
batches of `CHUNK` (16, a window; the segment path's S * F frames would
not fit on the card at once), its attention on K1's fp32 plan on the card,
each map back to (H, W) by
INTER_CUBIC, then (d - min) / max(max - min, 1e-8) a frame, repeated to 3
channels.
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
from .dpt import DPTConfig, DPTDepth, dpt_keys, load_depth_model
from .dpt_hybrid import DPTHybridConfig, DPTHybridDepth, standardize_weights_

MODEL_ENV = "CONTROLANIMATE_DEPTH_MODEL"
DEFAULT_MODEL = "models/annotators/depth"
NET_SIZE = 384  # every frame goes in at 384x384, whatever the config says (as JAX)
# frames a network call: one 16-frame window peaks near 21 GB above what is
# resident (chip_smoke.py on an H100, fp32, TF32 off), so the segment
# path's S * F frames go through a window's worth at a time
CHUNK = 16
# the config keys JAX never reads, and the values its networks assume
JAX_CONSTANTS = {"readout_type": "project", "hidden_act": "gelu", "layer_norm_eps": 1e-12}


def model_path() -> Path:
    return Path(os.environ.get(MODEL_ENV, DEFAULT_MODEL))


def check_config(cfg: dict) -> None:
    """The network `cfg` names must be one the port builds, with the
    constants JAX's networks assume."""
    kind = cfg.get("model_type")
    if kind == "glpn":
        raise NotImplementedError("a GLPN depth folder needs the GLPN annotator, which is not "
                                  "ported yet (M13c-4)")
    if kind != "dpt":
        raise ValueError(f"the depth annotator reads model_type 'dpt', not {kind!r}")
    for key, value in JAX_CONSTANTS.items():
        if cfg.get(key, value) != value:
            raise ValueError(f"the depth config's {key} is {cfg[key]!r}; the networks take "
                             f"{value!r}")


def depth_network(cfg: dict, sd: dict, device, size: int = NET_SIZE) -> nn.Module:
    """The fp32 network of a checked `config.json` and its transformers-keyed
    state dict for `size` x `size` inputs, built (and a hybrid's weights
    standardised) on the host, then moved to `device`."""
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


def network_input(frames: torch.Tensor, size: int = NET_SIZE) -> torch.Tensor:
    """(F, H, W, 3) uint8 -> (F, 3, size, size) float32: INTER_CUBIC, then
    (x / 255 - 0.5) / 0.5."""
    x = resize_cubic(frames, size, size).to(torch.float32)
    return ((x / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2).contiguous()


def depth_maps(model: nn.Module, frames: torch.Tensor) -> torch.Tensor:
    """(F, H, W, 3) uint8 -> (F, H, W, 3) float32 min-max maps (module
    docstring), the network on CHUNK frames at a time (each frame's map is
    its own: nothing in the networks mixes frames)."""
    F_, H, W, _ = frames.shape
    x = network_input(frames)
    with fp32_convs():
        d = torch.cat([model(x[i:i + CHUNK]) for i in range(0, F_, CHUNK)])
    d = resize_cubic(d[..., None].contiguous(), H, W)[..., 0]
    lo = d.amin((1, 2), keepdim=True)
    d = (d - lo) / (d.amax((1, 2), keepdim=True) - lo).clamp_min(1e-8)
    return d[..., None].expand(F_, H, W, 3).contiguous()


class DepthAnnotator:
    """The `depth` annotator: (F, H, W, 3) uint8 frames -> (F, H, W, 3)
    float32 depth maps in [0, 1] on the frames' device."""

    def __init__(self, model: nn.Module):
        self.model = model.float().eval()

    @classmethod
    def from_dir(cls, path, device="cuda") -> "DepthAnnotator":
        path = Path(path)
        if not (path / "config.json").is_file():
            raise FileNotFoundError(f"the depth annotator needs a local DPT folder (config.json "
                                    f"and weights) at {path}")
        cfg = json.loads((path / "config.json").read_text())
        check_config(cfg)  # before any weight is read
        sd = {}
        for f in ingest.component_weight_files(path):
            sd.update(ingest.load_state_dict(f))
        return cls(depth_network(cfg, sd, device))

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        return depth_maps(self.model, frames)
