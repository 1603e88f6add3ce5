"""OpenPose, the pose annotator (body, hands and face), on the frames'
device.

Counterpart of `controlanimate_tpu/models/annotators/openpose.py` with its
hand and face networks (`openpose_hand_face.py`, `openpose_face.py`); the
JAX package skips hands or faces without a word when their weights are
absent, the port raises FileNotFoundError naming the file.

`BodyPoseNet` (pytorch-openpose's bodypose_model): the VGG trunk `model0`
(`BLOCK0`, to 128 channels at stride 8), stage 1 in two branches
(`model1_1`: PAF, 38 maps; `model1_2`: heat, 19) and five 7x7 refinement
stages (`model{2..6}_{1,2}`) on [PAF, heat, trunk]. Module names follow
`body_pose_model.pth`'s keys, so it loads with plain `load_state_dict`.
All three networks run in fp32 without TF32.

`__call__` for a window of frames, with a few host syncs a window, not one
a person or limb:

- on the device: each frame INTER_CUBIC to the body input (scale 0.5 *
  368 / H, sides rounded up to multiples of 8; `ops/resize.py`), BGR /
  256 - 0.5, the network; the 19 heat maps INTER_CUBIC to (H, W), parts
  0..17 smoothed (`ops/gaussian.py`, sigma 3); a peak is a smoothed value
  >= its four neighbours (0 outside the map) and > 0.1, listed in
  row-major order with its unsmoothed value (`peak_lists`; sync 1);
- on the host: every candidate pair of each limb takes 10 samples along
  it (`np.linspace`, rounded half to even); the PAF values there are the
  INTER_CUBIC resize at those pixels only (`resize_cubic_at`; sync 2);
  the scores, priors, the stable descending sort and the greedy matching
  in float64 as the JAX package computes them (`limb_connections`), and
  the person assembly (`assemble_people`, JAX's verbatim, `elif k < 17`
  included);
- the hand and face boxes on the host, their crops through the networks
  on the device (`crop_peaks`; sync 3);
- the drawing: limbs as `cv2.ellipse2Poly` + `cv2.fillConvexPoly`, joints
  as discs of radius 4, then each hand's lines and dots and each face's
  dots, in the JAX package's order; the shapes' runs are made on the host
  and painted on the device (`ops/draw.py`), a later shape over an
  earlier one. A frame where no person is found is black.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from ...ops import draw
from ...ops.gaussian import gaussian_filter
from ...ops.host import upload
from ...ops.resize import resize_cubic, resize_cubic_at
from ...ops.warp import fp32_convs
from .edge_nets import load_fp32
from .openpose_face import FACE_PARTS, FaceNet, face_regions_from_body, face_shapes
from .openpose_face import face_state_dict_from_torch
from .openpose_hand_face import (HAND_PARTS, HandPoseNet, crop_peaks, hand_regions_from_body,
                                 hand_shapes, net_input, refine, refine_specs, run_trunk,
                                 stage_convs, trunk)

# (name, out channels, kernel) of the trunk; a kernel of 0 is a 2x2 max pool
BLOCK0 = (
    ("conv1_1", 64, 3), ("conv1_2", 64, 3), ("pool1", 0, 0),
    ("conv2_1", 128, 3), ("conv2_2", 128, 3), ("pool2", 0, 0),
    ("conv3_1", 256, 3), ("conv3_2", 256, 3), ("conv3_3", 256, 3),
    ("conv3_4", 256, 3), ("pool3", 0, 0),
    ("conv4_1", 512, 3), ("conv4_2", 512, 3),
    ("conv4_3_CPM", 256, 3), ("conv4_4_CPM", 128, 3),
)
LIMB_SEQ = (
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18), (3, 17), (6, 18),
)
MAP_IDX = (
    (31, 32), (39, 40), (33, 34), (35, 36), (41, 42), (43, 44), (19, 20),
    (21, 22), (23, 24), (25, 26), (27, 28), (29, 30), (47, 48), (49, 50),
    (53, 54), (51, 52), (55, 56), (37, 38), (45, 46),
)
COLORS = (
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0), (170, 255, 0),
    (85, 255, 0), (0, 255, 0), (0, 255, 85), (0, 255, 170), (0, 255, 255),
    (0, 170, 255), (0, 85, 255), (0, 0, 255), (85, 0, 255), (170, 0, 255),
    (255, 0, 255), (255, 0, 170), (255, 0, 85),
)
BODY_PARTS = 18
PEAK_THR = 0.1
MID_NUM = 10  # PAF samples a candidate limb
STICK_WIDTH = 4
GAUSS_FRAMES = 4  # frames a smoothing call (its float64 sums are 8 bytes a pixel and map)
WEIGHT_NAMES = ("body_pose_model.pth", "hand_pose_model.pth", "facenet.pth")


def stage1_names(branch: int) -> list:
    return [f"conv5_{i}_CPM_L{branch}" for i in range(1, 6)]


def refine_names(stage: int, branch: int) -> list:
    return [f"Mconv{i}_stage{stage}_L{branch}" for i in range(1, 8)]


class BodyPoseNet(nn.Module):
    """pytorch-openpose's bodypose_model: (B, 3, H, W) BGR in [-0.5, 0.5] ->
    (PAF (B, 38, H / 8, W / 8), heat (B, 19, H / 8, W / 8))."""

    def __init__(self):
        super().__init__()
        self.model0 = trunk(BLOCK0)
        for branch, out in ((1, 38), (2, 19)):
            m = nn.Module()
            stage_convs(m, stage1_names(branch), [(128, 3)] * 3 + [(512, 1), (out, 1)], 128)
            setattr(self, f"model1_{branch}", m)
            for s in range(2, 7):
                m = nn.Module()
                stage_convs(m, refine_names(s, branch), refine_specs(out), 185)
                setattr(self, f"model{s}_{branch}", m)

    def forward(self, x: torch.Tensor):
        feat = run_trunk(self.model0, BLOCK0, x)
        paf = refine(self.model1_1, stage1_names(1), feat)
        heat = refine(self.model1_2, stage1_names(2), feat)
        for s in range(2, 7):
            h = torch.cat([paf, heat, feat], 1)
            paf = refine(getattr(self, f"model{s}_1"), refine_names(s, 1), h)
            heat = refine(getattr(self, f"model{s}_2"), refine_names(s, 2), h)
        return paf, heat


def body_input_size(H: int, W: int) -> tuple[int, int]:
    """(h8, w8): the frame scaled by 0.5 * 368 / H, sides rounded up to
    multiples of 8 (the JAX package's float64 arithmetic)."""
    scale = 0.5 * 368.0 / H
    return int(np.ceil(H * scale / 8) * 8), int(np.ceil(W * scale / 8) * 8)


# -- the body decode ----------------------------------------------------------
class HostClock:
    """The host's seconds since it was made, less those spent in `wait`:
    enqueueing device work (which stalls once the launch queue is full)
    and waiting for its results."""

    def __init__(self):
        self.start, self.waiting = time.perf_counter(), 0.0

    def wait(self, fn):
        t0 = time.perf_counter()
        out = fn()
        self.waiting += time.perf_counter() - t0
        return out

    def seconds(self) -> float:
        return time.perf_counter() - self.start - self.waiting


def _peak_table(heat8: torch.Tensor, H: int, W: int) -> np.ndarray:
    """The device part of `peak_lists`: (P, 5) int64 frame, part, y, x and
    the unsmoothed value's bits of each peak, in row-major order."""
    heat = resize_cubic(heat8, H, W)  # (F, H, W, 19)
    masks = []
    for s in range(0, heat8.shape[0], GAUSS_FRAMES):
        m = gaussian_filter(heat[s:s + GAUSS_FRAMES, ..., :BODY_PARTS].permute(0, 3, 1, 2)
                            .contiguous())
        z = torch.zeros_like(m[..., :1, :])
        up = torch.cat([z, m[..., :-1, :]], -2)
        down = torch.cat([m[..., 1:, :], z], -2)
        z = torch.zeros_like(m[..., :1])
        left = torch.cat([z, m[..., :-1]], -1)
        right = torch.cat([m[..., 1:], z], -1)
        # a Python float against float32 maps compares in float32, as numpy's
        masks.append((m >= up) & (m >= down) & (m >= left) & (m >= right) & (m > PEAK_THR))
    idx = torch.cat(masks).nonzero()
    vals = heat[idx[:, 0], idx[:, 2], idx[:, 3], idx[:, 1]]
    return torch.cat([idx, vals.view(torch.int32).to(torch.int64)[:, None]], 1).cpu().numpy()


def peak_lists(heat8: torch.Tensor, H: int, W: int, clock: HostClock | None = None) -> list:
    """(F, h8, w8, 19) stride-8 heat maps -> for each frame the JAX
    `_find_peaks` list: 18 lists of (x, y, value, id), the ids running on
    across parts, in row-major order within a part."""
    F_ = heat8.shape[0]
    both = (clock or HostClock()).wait(lambda: _peak_table(heat8, H, W))
    idx, vals = both[:, :4], both[:, 4].astype(np.int32).view(np.float32)
    out = []
    for f in range(F_):
        rows = idx[:, 0] == f
        fi, fv = idx[rows], vals[rows]
        peaks, counter = [], 0
        for part in range(BODY_PARTS):
            sel = fi[:, 1] == part
            ys, xs, vs = fi[sel, 2], fi[sel, 3], fv[sel]
            peaks.append([(x, y, v, counter + i) for i, (x, y, v) in enumerate(zip(xs, ys, vs))])
            counter += len(ys)
        out.append(peaks)
    return out


def _linspace(start: np.ndarray, stop: np.ndarray, num: int) -> np.ndarray:
    """`np.linspace(a, b, num)` for each pair of the float64 arrays: (P,
    num), each row as the scalar call computes it."""
    div = num - 1
    delta = stop - start
    step = delta / div
    k = np.arange(num, dtype=np.float64)
    y = np.where((step == 0)[:, None], (k / div) * delta[:, None], k * step[:, None])
    y = y + start[:, None]
    y[:, -1] = stop
    return y


def _pairs(all_peaks):
    """Every candidate pair (limb k, i, j) of a frame and its 10 sample
    pixels: (limb, i, j) and (P, MID_NUM) rows and columns."""
    keys, ys, xs = [], [], []
    for k in range(len(MAP_IDX)):
        candA = all_peaks[LIMB_SEQ[k][0] - 1]
        candB = all_peaks[LIMB_SEQ[k][1] - 1]
        if not candA or not candB:
            continue
        a = np.array([p[:2] for p in candA], np.float64)
        b = np.array([p[:2] for p in candB], np.float64)
        a = np.repeat(a, len(candB), 0)
        b = np.tile(b, (len(candA), 1))
        xs.append(np.rint(_linspace(a[:, 0], b[:, 0], MID_NUM)).astype(np.int64))
        ys.append(np.rint(_linspace(a[:, 1], b[:, 1], MID_NUM)).astype(np.int64))
        keys.append(k)
    return keys, ys, xs


def limb_connections(paf8: torch.Tensor, peaks: list, H: int, W: int,
                     clock: HostClock | None = None) -> list:
    """For each frame's peaks, the JAX `_match_limbs` (connection_all,
    special_k), the PAF sampled at the limbs' pixels of the INTER_CUBIC
    resize of the (F, h8, w8, 38) stride-8 maps to (H, W) in one gather."""
    per_frame = [_pairs(p) for p in peaks]
    n, ys, xs = [], [], []
    for f, (_, fy, fx) in enumerate(per_frame):
        for y, x in zip(fy, fx):
            n.append(np.full(y.size, f))
            ys.append(y.reshape(-1))
            xs.append(x.reshape(-1))
    samples = None
    if n:
        samples = (clock or HostClock()).wait(lambda: resize_cubic_at(
            paf8, *upload([np.concatenate(a) for a in (n, ys, xs)], paf8.device), H,
            W).cpu().numpy())
    out, at = [], 0
    for f, (keys, fy, _) in enumerate(per_frame):
        connection_all, special_k = [], []
        by_limb = {}
        for k, y in zip(keys, fy):
            by_limb[k] = samples[at:at + y.size].reshape(*y.shape, -1)
            at += y.size
        for k, (a, b) in enumerate(MAP_IDX):
            candA = peaks[f][LIMB_SEQ[k][0] - 1]
            candB = peaks[f][LIMB_SEQ[k][1] - 1]
            if k not in by_limb:
                special_k.append(k)
                connection_all.append([])
                continue
            s = by_limb[k][..., [a - 19, b - 19]]  # (nA * nB, MID_NUM, 2) float32
            connection_all.append(_connect(candA, candB, s, H))
        out.append((connection_all, special_k))
    return out


def _connect(candA, candB, s: np.ndarray, H: int) -> list:
    """One limb's greedy matching from its pairs' PAF samples, in float64
    as the JAX `_match_limbs` computes it."""
    nB = len(candB)
    a = np.array([p[:2] for p in candA], np.int64)
    b = np.array([p[:2] for p in candB], np.int64)
    vec = (np.tile(b, (len(candA), 1)) - np.repeat(a, nB, 0)).astype(np.float64)
    norm = np.maximum(np.sqrt(vec[:, 0] * vec[:, 0] + vec[:, 1] * vec[:, 1]), 1e-8)
    vecn = vec / norm[:, None]
    s = s.astype(np.float64)
    scores = s[..., 0] * vecn[:, 0, None] + s[..., 1] * vecn[:, 1, None]
    prior = scores.mean(axis=1) + np.minimum(0.5 * H / norm - 1, 0)
    ok = ((scores > 0.05).sum(1) > 0.8 * MID_NUM) & (prior > 0)
    candidates = [(int(p) // nB, int(p) % nB, prior[p]) for p in np.flatnonzero(ok)]
    candidates.sort(key=lambda c: c[2], reverse=True)
    connection = []
    usedA, usedB = set(), set()
    for i, j, sc in candidates:
        if i not in usedA and j not in usedB:
            connection.append([candA[i][3], candB[j][3], sc, i, j])
            usedA.add(i)
            usedB.add(j)
    return connection


def assemble_people(all_peaks, connection_all, special_k):
    """The JAX `_assemble_people`, verbatim: (candidate (N, 4) float64,
    subset (people, 20))."""
    candidate = np.array([p for peaks in all_peaks for p in peaks], dtype=np.float64)
    subset = -1 * np.ones((0, 20))
    for k in range(len(MAP_IDX)):
        if k in special_k or not connection_all[k]:
            continue
        partAs = [c[0] for c in connection_all[k]]
        partBs = [c[1] for c in connection_all[k]]
        indexA, indexB = np.array(LIMB_SEQ[k]) - 1
        for i, conn in enumerate(connection_all[k]):
            found = []
            for j in range(len(subset)):
                if subset[j][indexA] == partAs[i] or subset[j][indexB] == partBs[i]:
                    found.append(j)
            if len(found) == 1:
                j = found[0]
                if subset[j][indexB] != partBs[i]:
                    subset[j][indexB] = partBs[i]
                    subset[j][-1] += 1
                    subset[j][-2] += candidate[int(partBs[i]), 2] + conn[2]
            elif len(found) == 2:
                j1, j2 = found
                membership = ((subset[j1] >= 0).astype(int) + (subset[j2] >= 0).astype(int))[:-2]
                if (membership == 2).sum() == 0:
                    subset[j1][:-2] += subset[j2][:-2] + 1
                    subset[j1][-2:] += subset[j2][-2:]
                    subset[j1][-2] += conn[2]
                    subset = np.delete(subset, j2, 0)
                else:
                    subset[j1][indexB] = partBs[i]
                    subset[j1][-1] += 1
                    subset[j1][-2] += candidate[int(partBs[i]), 2] + conn[2]
            elif k < 17:
                row = -1 * np.ones(20)
                row[indexA] = partAs[i]
                row[indexB] = partBs[i]
                row[-1] = 2
                row[-2] = candidate[int(partAs[i]), 2] + candidate[int(partBs[i]), 2] + conn[2]
                subset = np.vstack([subset, row])
    keep = [i for i in range(len(subset))
            if subset[i][-1] >= 4 and subset[i][-2] / subset[i][-1] >= 0.4]
    return candidate, subset[keep]


def body_shapes(candidate: np.ndarray, subset: np.ndarray) -> list:
    """The JAX `draw_bodypose` as shapes in its order: each limb of each
    person an ellipse polygon, then each joint a disc of radius 4."""
    shapes = []
    for i in range(17):
        for person in subset:
            idx = person[np.array(LIMB_SEQ[i]) - 1]
            if -1 in idx:
                continue
            ys = candidate[idx.astype(int), 1]
            xs = candidate[idx.astype(int), 0]
            mx, my = xs.mean(), ys.mean()
            length = np.hypot(xs[0] - xs[1], ys[0] - ys[1])
            angle = np.degrees(np.arctan2(ys[0] - ys[1], xs[0] - xs[1]))
            poly = draw.ellipse_poly((int(mx), int(my)), (int(length / 2), STICK_WIDTH),
                                     int(angle))
            shapes.append(("poly", poly, COLORS[i]))
    for i in range(18):
        for person in subset:
            idx = int(person[i])
            if idx == -1:
                continue
            x, y = candidate[idx][0:2]
            shapes.append(("disc", (int(x), int(y)), 4, COLORS[i]))
    return shapes


def paint_shapes(shapes: list, H: int, W: int, device,
                 clock: HostClock | None = None) -> torch.Tensor:
    """(F, H, W, 3) uint8 canvases of each frame's shapes in order: ("poly",
    vertices, colour) filled convex polygons, ("disc", centre, r, colour)
    filled circles, ("line", a, b, colour) thickness-2 lines."""
    colours, runs, canvas_of, prim_of = [], [], [], []
    polys, discs, lines = [], {}, []
    for f, frame_shapes in enumerate(shapes):
        for shape in frame_shapes:
            p = len(colours)
            colours.append(shape[-1])
            if shape[0] == "poly":
                polys.append((shape[1], f, p))
            elif shape[0] == "disc":
                discs.setdefault(shape[2], []).append((shape[1], f, p))
            else:
                lines.append((shape[1], shape[2], f, p))

    def add(r, owner, fs, ps):
        runs.append(r)
        canvas_of.append(np.asarray(fs, np.int64)[owner])
        prim_of.append(np.asarray(ps, np.int64)[owner])

    if polys:
        add(*draw.convex_poly_runs([v for v, _, _ in polys], H, W),
            [f for _, f, _ in polys], [p for _, _, p in polys])
    for r, items in discs.items():
        add(*draw.disc_runs(np.array([c for c, _, _ in items], np.int64), r, H, W),
            [f for _, f, _ in items], [p for _, _, p in items])
    if lines:
        add(*draw.thick_line_runs(np.array([a for a, _, _, _ in lines], np.int64),
                                  np.array([b for _, b, _, _ in lines], np.int64), H, W),
            [f for _, _, f, _ in lines], [p for _, _, _, p in lines])
    cat = lambda a: np.concatenate(a) if a else np.zeros((0,), np.int64)  # noqa: E731
    args = (np.concatenate(runs) if runs else draw.NO_RUNS, cat(canvas_of), cat(prim_of),
            colours or np.zeros((0, 3), np.uint8), len(shapes), H, W, device)
    return (clock or HostClock()).wait(lambda: draw.paint_runs(*args))


class OpenPoseAnnotator:
    """The `openpose` annotator with hands and face: (F, H, W, 3) uint8
    frames -> (F, H, W, 3) float32 maps in [0, 1] on the frames' device.
    `stats` holds the last call's people, hands and faces drawn and the
    seconds its decode spent on the host (`HostClock`)."""

    def __init__(self, body: BodyPoseNet, hand: HandPoseNet, face: FaceNet):
        self.body, self.hand, self.face = body.float().eval(), hand.float().eval(), \
            face.float().eval()
        self.stats: dict = {}

    @classmethod
    def from_files(cls, body_path, hand_path, face_path, device="cuda") -> "OpenPoseAnnotator":
        """The three networks from their files; FileNotFoundError naming the
        first one missing, before any is read."""
        for what, path in zip(("body", "hand", "face"), (body_path, hand_path, face_path)):
            if not Path(path).is_file():
                raise FileNotFoundError(f"the openpose annotator needs its {what} weights at "
                                        f"{path}")
        return cls(load_fp32(BodyPoseNet, body_path, "openpose body", device),
                   load_fp32(HandPoseNet, hand_path, "openpose hand", device),
                   load_fp32(FaceNet, face_path, "openpose face", device,
                             face_state_dict_from_torch))

    @torch.no_grad()
    def body_maps(self, frames: torch.Tensor):
        """(F, H, W, 3) uint8 -> the body network's stride-8 (PAF, heat),
        channels last: (F, h8, w8, 38), (F, h8, w8, 19)."""
        x = resize_cubic(frames, *body_input_size(*frames.shape[1:3]))
        with fp32_convs():
            paf, heat = self.body(net_input(x))
        return paf.permute(0, 2, 3, 1).contiguous(), heat.permute(0, 2, 3, 1).contiguous()

    @torch.no_grad()
    def draw(self, frames: torch.Tensor, paf8: torch.Tensor, heat8: torch.Tensor):
        """The decode and drawing of the stride-8 maps of `frames`: (F, H, W,
        3) uint8 canvases."""
        F_, H, W, _ = frames.shape
        clock = HostClock()
        peaks = peak_lists(heat8, H, W, clock)
        conns = limb_connections(paf8, peaks, H, W, clock)
        shapes, hand_boxes, face_boxes, people = [], [], [], 0
        for f in range(F_):
            candidate, subset = assemble_people(peaks[f], *conns[f])
            shapes.append(body_shapes(candidate, subset) if len(candidate) else [])
            if len(candidate):
                people += len(subset)
                hand_boxes += [(f, b) for b in hand_regions_from_body(candidate, subset, H, W)]
                face_boxes += [(f, b) for b in face_regions_from_body(candidate, subset, H, W)]
        hands, faces = clock.wait(lambda: [crop_peaks(net, frames, boxes, parts).cpu().numpy()
                                           for net, boxes, parts in (
            (self.hand, [(f, *b) for f, b in hand_boxes], HAND_PARTS),
            (self.face, [(f, *b, False) for f, b in face_boxes], FACE_PARTS))])
        extra = [[] for _ in range(F_)]
        n_hands = n_faces = 0
        for (f, box), pk in zip(hand_boxes, hands):
            s = hand_shapes(pk, box)
            n_hands += bool(s)
            extra[f] += s
        for (f, box), pk in zip(face_boxes, faces):
            s = face_shapes(pk, box)
            n_faces += bool(s)
            extra[f] += s
        canvas = paint_shapes([a + b for a, b in zip(shapes, extra)], H, W, frames.device,
                              clock)
        self.stats = {"people": people, "hands": n_hands, "faces": n_faces,
                      "host_seconds": clock.seconds()}
        return canvas

    @torch.no_grad()
    def __call__(self, frames: torch.Tensor) -> torch.Tensor:
        paf8, heat8 = self.body_maps(frames)
        return self.draw(frames, paf8, heat8).to(torch.float32) / 255.0
