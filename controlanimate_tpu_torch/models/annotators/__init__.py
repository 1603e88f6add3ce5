"""Condition-map annotators for the ControlNets, on the frames' device.

Counterpart of `controlanimate_tpu/models/annotators/__init__.py`: the
ControlNet's model name picks its annotator by substring, in the JAX
package's order (`ANNOTATOR_ORDER`). An annotator maps (F, H, W, 3) uint8
frames to (F, H, W, 3) float32 condition maps in [0, 1] on the same device.
Ported: `canny` (`ops/canny.py`, bit for bit as OpenCV), `hed` and
`lineart` (`edge_nets.py`), `mlsd` (`mlsd.py`), `openpose` with hands and
face (`openpose.py`), `softedge` (PidiNet, `pidinet.py`) and
`lineart_anime` (`lineart_anime.py`), the networks read from `WEIGHT_FILES`
in CONTROLANIMATE_ANNOTATOR_DIR (default `models/annotators`), `normalbae`
(`normalbae.py`), read from the file that CONTROLANIMATE_NORMALBAE_MODEL
names (default `models/annotators/normalbae/scannet.pt`), and `depth` (DPT,
DPT-hybrid or GLPN, `depth.py`), read from the transformers folder that
CONTROLANIMATE_DEPTH_MODEL names (default `models/annotators/depth`), as in
JAX. A missing file or folder raises FileNotFoundError (where the JAX
package falls back to `cv2.HoughLinesP` for MLSD, to HED for softedge, to
depth or luminance normals for normalbae, to a host `transformers` model
for depth, and skips OpenPose's hands or faces). A name that matches no
annotator raises KeyError, as in JAX (there at the first window, here at
the build).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable

import torch

from ...ops.canny import canny
from .depth import DepthAnnotator
from .depth import model_path as depth_path
from .edge_nets import HEDAnnotator, LineartAnnotator
from .lineart_anime import LineartAnimeAnnotator
from .mlsd import MLSDAnnotator
from .normalbae import NormalBaeAnnotator
from .normalbae import model_path as normalbae_path
from .openpose import WEIGHT_NAMES, OpenPoseAnnotator
from .pidinet import PidiNetAnnotator

# (substring of the lower-cased model name, annotator), first match wins
ANNOTATOR_ORDER = (
    ("canny", "canny"),
    ("mlsd", "mlsd"),
    ("openpose", "openpose"),
    ("hed", "hed"),
    ("lineart_anime", "lineart_anime"),
    ("anime", "lineart_anime"),
    ("lineart", "lineart"),
    ("normalbae", "normalbae"),
    ("softedge", "softedge"),
    ("pidi", "softedge"),
    ("depth", "depth"),
    ("scribble", "hed"),
)
# the networks' checkpoints (controlnet_aux's names) and the annotators'
# constructors from their paths
WEIGHT_FILES = {"hed": (("ControlNetHED.pth",), HEDAnnotator.from_file),
                "lineart": (("sk_model.pth",), LineartAnnotator.from_file),
                "mlsd": (("mlsd_large_512_fp32.pth",), MLSDAnnotator.from_file),
                "openpose": (WEIGHT_NAMES, OpenPoseAnnotator.from_files),
                "softedge": (("table5_pidinet.pth",), PidiNetAnnotator.from_file),
                "lineart_anime": (("netG.pth",), LineartAnimeAnnotator.from_file)}
ANNOTATOR_ENV = "CONTROLANIMATE_ANNOTATOR_DIR"

Annotator = Callable[[torch.Tensor], torch.Tensor]


def annotator_name(controlnet_name: str) -> str:
    """The annotator a ControlNet's name selects (every one of the JAX
    package's is ported, `depth` with DPT, DPT-hybrid and GLPN); KeyError
    for a name that selects none."""
    n = controlnet_name.lower()
    for sub, key in ANNOTATOR_ORDER:
        if sub in n:
            return key
    raise KeyError(f"no annotator for ControlNet {controlnet_name!r}; "
                   f"names: {sorted({k for _, k in ANNOTATOR_ORDER})}")


def resolve_annotator(controlnet_name: str, device="cuda") -> Annotator:
    """The annotator for a ControlNet (the JAX `resolve_annotator`), its
    weights (if any) read now and placed on `device`."""
    name = annotator_name(controlnet_name)
    if name == "canny":
        return canny
    if name == "normalbae":
        return NormalBaeAnnotator.from_file(normalbae_path(), device=device)
    if name == "depth":
        return DepthAnnotator.from_dir(depth_path(), device=device)
    fnames, make = WEIGHT_FILES[name]
    folder = Path(os.environ.get(ANNOTATOR_ENV, "models/annotators"))
    return make(*(folder / f for f in fnames), device=device)


def annotate_frames(controlnet_name: str, frames) -> torch.Tensor:
    """(F, H, W, 3) uint8 frames -> (F, H, W, 3) float32 maps in [0, 1], on
    the frames' device (the JAX `annotate_frames`)."""
    frames = torch.as_tensor(frames)
    return resolve_annotator(controlnet_name, frames.device)(frames)
