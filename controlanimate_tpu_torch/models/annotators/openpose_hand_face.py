"""OpenPose's hand network, its hand boxes and the hand drawing, on the
frames' device.

Counterpart of `controlanimate_tpu/models/annotators/openpose_hand_face.py`
(pytorch-openpose's handpose CPM): a VGG trunk (`model1_0`, 3x3 convs and
2x2 max pools to 128 channels at stride 8), stage 1 (`model1_1`, 1x1 convs
to 512 and 22 heat maps) and five refinement stages (`model2` ..
`model6`, five 7x7 convs and two 1x1 convs on [heat, trunk]), ReLU after
every conv but each stage's last. Module names follow
`hand_pose_model.pth`'s keys (`model1_0.conv1_1`, `model1_1.conv6_1_CPM`,
`model2.Mconv1_stage2`), so it loads with plain `load_state_dict`.

`hand_regions_from_body` is the JAX package's box rule on the host, in
float64. `crop_peaks` (shared with the face network, `openpose_face.py`)
runs on the device, all of a window's boxes at once: each box's crop of
the frame (mirrored for a left hand) INTER_CUBIC to 368x368, BGR / 256 -
0.5, batched network calls (`crop_heat`); then each crop's heat maps
INTER_CUBIC to the box's width, the Gaussian filter (sigma 3), and each
part's first maximum with its smoothed value (`heat_peaks`). Its tables go
up in one copy that does not wait for the device (`ops/host.py`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.gaussian import gaussian_filter_sizes
from ...ops.host import upload
from ...ops.resize import resize_cubic_boxes
from ...ops.warp import fp32_convs

CROP_SIZE = 368
NET_BATCH = 8  # crops a network call
PART_THR = 0.1

# (name, out channels, kernel) of the trunk; a kernel of 0 is a 2x2 max pool
HAND_TRUNK = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool1", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool2", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool3", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3), ("conv4_3", 512, 3),
    ("conv4_4", 512, 3), ("conv5_1", 512, 3), ("conv5_2", 512, 3),
    ("conv5_3_CPM", 128, 3),
)
HAND_EDGES = (
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8), (0, 9),
    (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15), (15, 16),
    (0, 17), (17, 18), (18, 19), (19, 20),
)
HAND_COLOUR = (0, 0, 255)
HAND_PARTS = 21


def trunk(spec, in_channels: int = 3) -> nn.Module:
    """A module holding the trunk's convs under their names."""
    m = nn.Module()
    for name, out, k in spec:
        if k:
            setattr(m, name, nn.Conv2d(in_channels, out, k, padding=k // 2))
            in_channels = out
    return m


def run_trunk(m: nn.Module, spec, x: torch.Tensor) -> torch.Tensor:
    for name, _, k in spec:
        x = F.max_pool2d(x, 2, 2) if not k else F.relu(getattr(m, name)(x))
    return x


def refine(m: nn.Module, names: list, x: torch.Tensor) -> torch.Tensor:
    """Convs `names` of `m` in turn, ReLU after all but the last."""
    for name in names[:-1]:
        x = F.relu(getattr(m, name)(x))
    return getattr(m, names[-1])(x)


def stage_convs(m: nn.Module, names: list, specs: list, in_channels: int) -> None:
    """Adds to `m` the convs `names` of (out channels, kernel) `specs`."""
    for name, (out, k) in zip(names, specs):
        setattr(m, name, nn.Conv2d(in_channels, out, k, padding=k // 2))
        in_channels = out


def refine_specs(out: int):
    return [(128, 7)] * 5 + [(128, 1), (out, 1)]


class HandPoseNet(nn.Module):
    """pytorch-openpose's handpose_model: (B, 3, H, W) BGR in [-0.5, 0.5] ->
    (B, 22, H / 8, W / 8) heat maps."""

    def __init__(self):
        super().__init__()
        self.model1_0 = trunk(HAND_TRUNK)
        self.model1_1 = nn.Module()
        stage_convs(self.model1_1, ["conv6_1_CPM", "conv6_2_CPM"], [(512, 1), (22, 1)], 128)
        for s in range(2, 7):
            m = nn.Module()
            stage_convs(m, self.stage_names(s), refine_specs(22), 150)
            setattr(self, f"model{s}", m)

    @staticmethod
    def stage_names(s: int) -> list:
        return [f"Mconv{i}_stage{s}" for i in range(1, 8)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = run_trunk(self.model1_0, HAND_TRUNK, x)
        out = refine(self.model1_1, ["conv6_1_CPM", "conv6_2_CPM"], feat)
        for s in range(2, 7):
            out = refine(getattr(self, f"model{s}"), self.stage_names(s),
                         torch.cat([out, feat], 1))
        return out


def hand_regions_from_body(candidate, subset, H: int, W: int) -> list:
    """Hand boxes (x0, y0, width, is_left) from each person's shoulder,
    elbow and wrist (left hand first), the JAX package's rule verbatim."""
    regions = []
    for person in subset:
        for (s_i, e_i, w_i, is_left) in ((5, 6, 7, True), (2, 3, 4, False)):
            if person[s_i] < 0 or person[e_i] < 0 or person[w_i] < 0:
                continue
            x1, y1 = candidate[int(person[s_i])][:2]
            x2, y2 = candidate[int(person[e_i])][:2]
            x3, y3 = candidate[int(person[w_i])][:2]
            cx = x3 + 0.33 * (x3 - x2)
            cy = y3 + 0.33 * (y3 - y2)
            width = 1.5 * max(np.hypot(x3 - x2, y3 - y2), 0.9 * np.hypot(x2 - x1, y2 - y1))
            x0, y0 = cx - width / 2, cy - width / 2
            width = min(width, W - x0, H - y0, x0 + width, y0 + width)
            if width > 20:
                regions.append((int(max(x0, 0)), int(max(y0, 0)), int(width), is_left))
    return regions


def net_input(crops: torch.Tensor) -> torch.Tensor:
    """(B, h, w, 3) uint8 RGB -> the CPM networks' (B, 3, h, w) BGR input,
    / 256 - 0.5 in float32."""
    return crops.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 256.0 - 0.5


def crop_boxes(frames_shape, boxes: list) -> tuple[list, np.ndarray]:
    """The boxes (frame, x0, y0, w, mirrored) whose crop frame[y0:y0 + w,
    x0:x0 + w] (numpy's clipping at the frame's edge) is not empty, and
    their (n, y0, x0, h, w, mirrored) rows for `resize_cubic_boxes`."""
    _, H, W, _ = frames_shape
    live, rows = [], []
    for i, (f, x0, y0, w, mirrored) in enumerate(boxes):
        h, wc = min(y0 + w, H) - y0, min(x0 + w, W) - x0
        if h > 0 and wc > 0:
            live.append(i)
            rows.append((f, y0, x0, h, wc, int(mirrored)))
    return live, np.array(rows, np.int64).reshape(-1, 6)


@torch.no_grad()
def crop_heat(net: nn.Module, frames: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """The network's (B, C, CROP_SIZE / 8, CROP_SIZE / 8) heat maps of the
    `crop_boxes` rows of the (F, H, W, 3) uint8 `frames`, each crop
    INTER_CUBIC to CROP_SIZE (all at once), NET_BATCH crops a call."""
    crops = resize_cubic_boxes(frames, rows, np.full((len(rows), 2), CROP_SIZE))
    with fp32_convs():
        return torch.cat([net(net_input(crops[i:i + NET_BATCH]))
                          for i in range(0, len(crops), NET_BATCH)])


def heat_peaks(heats: torch.Tensor, widths: np.ndarray, parts: int) -> torch.Tensor:
    """Each crop's heat maps INTER_CUBIC to (w, w), smoothed, and each of
    the first `parts` maps' first maximum in row-major order, all crops at
    once: (B, parts, 3) int64 (x, y, the float32 value's bits)."""
    B, C, h, w = heats.shape
    rows = np.stack([np.arange(B), np.zeros(B), np.zeros(B), np.full(B, h), np.full(B, w),
                     np.zeros(B)], -1).astype(np.int64)
    m = resize_cubic_boxes(heats.permute(0, 2, 3, 1), rows, np.stack([widths, widths], -1))
    m = gaussian_filter_sizes(m[..., :parts].permute(0, 3, 1, 2).contiguous(), widths)
    S = m.shape[-1]
    (side,) = upload([widths], heats.device)
    inside = torch.arange(S, device=heats.device) < side[:, None]  # (B, S)
    m = torch.where(inside[:, None, :, None] & inside[:, None, None, :], m, -torch.inf)
    flat = m.reshape(B, parts, -1)
    best = flat.argmax(-1)
    value = flat.gather(-1, best[..., None])[..., 0]
    return torch.stack([best % S, best // S, value.view(torch.int32).to(torch.int64)], -1)


def crop_peaks(net: nn.Module, frames: torch.Tensor, boxes: list, parts: int) -> torch.Tensor:
    """For each box (frame, x0, y0, w, mirrored) of the (F, H, W, 3) uint8
    `frames`: the network's heat maps of its crop (`crop_heat`), decoded by
    `heat_peaks`, on the frames' device; an empty crop's values are -inf."""
    out = torch.zeros(len(boxes), parts, 3, dtype=torch.int64, device=frames.device)
    out[..., 2] = _NEG_INF_BITS
    live, rows = crop_boxes(frames.shape, boxes)
    if live:
        widths = np.array([boxes[i][3] for i in live], np.int64)  # the heat's side: w
        found = heat_peaks(crop_heat(net, frames, rows), widths, parts)
        if len(live) == len(boxes):
            return found
        (at,) = upload([np.array(live)], frames.device)
        out[at] = found
    return out


_NEG_INF_BITS = int(np.array(-np.inf, np.float32).view(np.int32))


def peak_values(bits: np.ndarray) -> np.ndarray:
    """The float32 values `crop_peaks` returns as bits."""
    return bits.astype(np.int32).view(np.float32)


def hand_shapes(peaks: np.ndarray, box) -> list:
    """The drawing of one hand: (21, 3) `crop_peaks` rows of its box (x0,
    y0, w, is_left) -> shapes (thickness-2 lines between the found parts,
    then a dot of radius 3 on each), the JAX package's order."""
    x0, y0, w, is_left = box
    pts = []
    for x, y, bits in peaks.tolist():
        if peak_values(np.array([bits]))[0] < np.float32(PART_THR):
            pts.append(None)
            continue
        px = (w - 1 - x) if is_left else x
        pts.append((x0 + px, y0 + y))
    shapes = [("line", pts[a], pts[b], HAND_COLOUR) for a, b in HAND_EDGES
              if pts[a] is not None and pts[b] is not None]
    return shapes + [("disc", p, 3, HAND_COLOUR) for p in pts if p is not None]
