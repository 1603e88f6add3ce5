"""OpenPose's face network, its face boxes and the face dots, on the frames'
device.

Counterpart of `controlanimate_tpu/models/annotators/openpose_face.py`: a
VGG trunk (3x3 convs and three 2x2 max pools to 128 channels), stage 1
(1x1 convs to 512 and 71 heat maps) and five refinement stages on [heat,
trunk], ReLU after every conv but each stage's last. Module names are
`facenet.pth`'s keys, which have no prefix (`conv1_1`, `conv6_2_CPM`,
`Mconv7_stage6`); a `model.` prefix in the file is dropped when it is read.
`face_regions_from_body` is the JAX package's box rule; the heat maps go
through `crop_peaks` as the hands' do, and each of the 70 parts found
(smoothed maximum >= 0.1) is a white dot of radius 3.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .openpose_hand_face import (PART_THR, peak_values, refine, refine_specs, run_trunk,
                                 stage_convs, trunk)

FACE_TRUNK = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool1", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool2", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool3", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv5_1", 512, 3), ("conv5_2", 512, 3), ("conv5_3_CPM", 128, 3),
)
FACE_PARTS = 70
FACE_COLOUR = (255, 255, 255)


class FaceNet(nn.Module):
    """The OpenPose face CPM: (B, 3, H, W) BGR in [-0.5, 0.5] -> (B, 71,
    H / 8, W / 8) heat maps. Its convs hang off the module itself, as the
    checkpoint's keys name them."""

    def __init__(self):
        super().__init__()
        body = trunk(FACE_TRUNK)
        for name, conv in body.named_children():
            setattr(self, name, conv)
        stage_convs(self, ["conv6_1_CPM", "conv6_2_CPM"], [(512, 1), (71, 1)], 128)
        for s in range(2, 7):
            stage_convs(self, self.stage_names(s), refine_specs(71), 199)

    @staticmethod
    def stage_names(s: int) -> list:
        return [f"Mconv{i}_stage{s}" for i in range(1, 8)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = run_trunk(self, FACE_TRUNK, x)
        out = refine(self, ["conv6_1_CPM", "conv6_2_CPM"], feat)
        for s in range(2, 7):
            out = refine(self, self.stage_names(s), torch.cat([out, feat], 1))
        return out


def face_state_dict_from_torch(sd: dict) -> dict:
    """`facenet.pth`'s keys with a `model.` prefix dropped (the JAX
    `face_params_from_torch`)."""
    return {k.replace("model.", ""): v for k, v in sd.items()
            if k.endswith(".weight") or k.endswith(".bias")}


def face_regions_from_body(candidate, subset, H: int, W: int) -> list:
    """Square face boxes (x0, y0, width): 3x the largest distance from the
    nose to an eye or ear, clipped to the frame (the JAX rule verbatim)."""
    regions = []
    for person in subset:
        if person[0] < 0:
            continue
        nx, ny = candidate[int(person[0])][:2]
        dists = []
        for idx in (14, 15, 16, 17):
            if person[idx] >= 0:
                px, py = candidate[int(person[idx])][:2]
                dists.append(np.hypot(px - nx, py - ny))
        if not dists:
            continue
        width = 3.0 * max(dists)
        x0, y0 = int(max(nx - width / 2, 0)), int(max(ny - width / 2, 0))
        width = int(min(width, W - x0, H - y0))
        if width > 20:
            regions.append((x0, y0, width))
    return regions


def face_shapes(peaks: np.ndarray, box) -> list:
    """The dots of one face: (70, 3) `crop_peaks` rows of its box (x0, y0,
    w) -> a white dot of radius 3 on each part found."""
    x0, y0, _ = box
    keep = peak_values(peaks[:, 2]) >= np.float32(PART_THR)
    return [("disc", (x0 + x, y0 + y), 3, FACE_COLOUR) for x, y, _ in peaks[keep].tolist()]
