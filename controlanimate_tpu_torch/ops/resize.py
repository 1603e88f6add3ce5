"""Resizes of uint8 frames as OpenCV's `cv2.resize` computes them for 8-bit
images, in plain PyTorch on the frames' device: Lanczos4, area and nearest.

Lanczos4 (`resize_lanczos4`). The JAX package resizes the upscaler's x4
output to the configured scale with `cv2.resize(..., INTER_LANCZOS4)`
(`controlanimate_tpu/models/upscaler.py` `_post_resize`,
`scripts/vid2vid.py` `_upscale_frames`). OpenCV's 8-bit path
(`resizeGeneric_` with `HResizeLanczos4` / `VResizeLanczos4`):

- source coordinate of output column dx: fx = float((dx + 0.5) / inv_scale -
  0.5), sx = floor(fx), fx -= sx; taps sx - 3 .. sx + 4, clamped to the image
  (OpenCV's border rule here: the edge pixel repeats);
- 8 Lanczos (a = 4) weights of fx, normalised to sum 1, then to fixed point:
  round(w * 2048) as int16;
- a horizontal pass to int32 rows (u8 * int16, no rounding), then a vertical
  pass: (sum_k beta_k * row_k + 2^21) >> 22, saturated to 0..255.

The weight tables are computed on the host in OpenCV's precisions (fx in
float32, the sines in float64, the weights in float32); the two passes run on
the device in integer arithmetic.

Area (`resize_area`, INTER_AREA) and nearest (`resize_nearest`,
INTER_NEAREST) serve the MLSD annotator (`controlanimate_tpu/models/
annotators/mlsd_net.py` `run`: frames to 512x512 by area, the line map back
by nearest). OpenCV's INTER_AREA has three branches, by the scales
s = src / dst of the two axes (inv_scale = dst / src in float64, s = 1 /
inv_scale):

- both s integers (`resizeAreaFast_`): each output is the sum of its s_x x
  s_y block; a 2x2 block of a 1-, 3- or 4-channel frame rounds as
  (sum + 2) >> 2 (the vector path, which then takes every pixel), any other
  block as round-half-even(float32(sum) * float32(1 / area));
- both s >= 1 otherwise (`resizeArea_`, float32): each output column takes
  the source columns its cell [dx * s, (dx + 1) * s) covers, weighted by the
  covered share (`computeResizeAreaTab`: a share under 1e-3 is dropped), the
  products summed in order from 0; then the rows the same way; the float32
  result rounded half to even;
- an axis scaled up (`resizeGeneric_` with linear taps in fixed point):
  sx = floor(dx * s), fx = float32((dx + 1) - (sx + 1) * inv_scale), taken
  to 0 if not positive, else its fraction; weights round((1 - fx) * 2048)
  and round(fx * 2048) on columns sx, sx + 1 (the last column alone, times
  2048, from the first dx whose sx + 1 leaves the image); rows alike,
  clamped. The vertical pass is OpenCV's vector one at every output:
  ((sat16(r0 >> 4) * b0) >> 16) + ((sat16(r1 >> 4) * b1) >> 16), then
  (v + 2) >> 2, saturated to 0..255.

Equal sizes copy. Nearest takes source column min(floor(dx * (1 / inv_scale)),
src - 1), the product in float64, and rows alike. Every table is built on
the host in OpenCV's precisions; the passes run on the device.

Cubic (`resize_cubic`, INTER_CUBIC) serves the OpenPose annotator
(`controlanimate_tpu/models/annotators/openpose*.py`: uint8 frames and
crops to the networks' inputs, float32 heat and PAF maps back up). OpenCV's
`resizeGeneric_`: the Lanczos4 coordinates with four taps sx - 1 .. sx + 2,
clamped, and the weights of `interpolateCubic` (A = -0.75, float32). Rows
of the image are (width * channels) elements long, and the vertical pass
runs OpenCV's 4-lane vector loop (SSE) over the first elements of each row
and its scalar loop over the rest:

- float32: a horizontal pass ((s0 w0 + s1 w1) + s2 w2) + s3 w3, then a
  vertical one, s0 b0 + (s1 b1 + (s2 b2 + s3 b3)) over the first
  4 * floor(n / 4) elements of a row and ((s0 b0 + s1 b1) + s2 b2) + s3 b3
  over the rest, each product and sum rounded to float32 (no fused
  multiply-add);
- uint8: the weights to fixed point (round(w * 2048), half to even), an
  exact int32 horizontal pass, then over the first 8 * floor(n / 8)
  elements the vector loop in float32 (the sums times b / 2^22, summed as
  above, rounded half to even) and over the rest the exact
  (sum + 2^21) >> 22; saturated to 0..255.

This is OpenCV's own code path. A build with Intel IPP (the pip wheels)
hands 1-, 3- and 4-channel 8-bit images (and 1-, 3- and 4-channel float32
ones) to IPP's resize instead, which differs from it by 1 on a few per cent
of the pixels (`cv2.setUseOptimized(False)` turns IPP off);
`resize_cubic_at` is the float32 resize at chosen pixels only.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .host import upload

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS  # 2048
_S45 = 0.70710678118654752440084436210485
_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1),
       (-_S45, _S45))


def _lanczos4_weights(fx: np.float32) -> np.ndarray:
    """OpenCV's `interpolateLanczos4`: 8 float32 weights of the fraction fx."""
    if fx < np.finfo(np.float32).eps:
        w = np.zeros(8, np.float32)
        w[3] = 1.0
        return w
    x3 = np.float32(fx + np.float32(3))  # OpenCV sums x + 3 (- i) in float
    y0 = -float(x3) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    w = np.empty(8, np.float32)
    total = np.float32(0.0)
    for i in range(8):
        y = -float(np.float32(x3 - np.float32(i))) * math.pi * 0.25
        w[i] = np.float32((_CS[i][0] * s0 + _CS[i][1] * c0) / (y * y))
        total = np.float32(total + w[i])
    return (w * np.float32(np.float32(1.0) / total)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def lanczos4_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices (dst, 8) int64 clamped to [0, src), weights (dst, 8) int64 in
    fixed point) for one axis of a resize from `src` to `dst` pixels; cached,
    so both are read-only."""
    scale = 1.0 / (dst / src)  # OpenCV: scale_x = 1. / inv_scale_x
    idx = np.empty((dst, 8), np.int64)
    coef = np.empty((dst, 8), np.int64)
    for d in range(dst):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(fx)
        fx = np.float32(fx - np.float32(sx))
        idx[d] = np.clip(np.arange(sx - 3, sx + 5), 0, src - 1)
        # saturate_cast<short>(w * 2048): round half to even, as cvRound
        coef[d] = np.rint(_lanczos4_weights(fx) * np.float32(COEF_SCALE)).astype(np.int64)
    idx.setflags(write=False)
    coef.setflags(write=False)
    return idx, coef


def _check_frames(frames: torch.Tensor) -> None:
    if frames.dtype != torch.uint8 or frames.ndim != 4:
        raise ValueError(f"frames must be (F, H, W, C) uint8, got {frames.dtype} "
                         f"{tuple(frames.shape)}")


def resize_lanczos4(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(F, H, W, C) uint8 -> (F, height, width, C) uint8 on the frames' device."""
    _check_frames(frames)
    _, H, W, _ = frames.shape
    dev = frames.device
    xi, xc = (torch.tensor(t, device=dev) for t in lanczos4_table(W, width))
    yi, yc = (torch.tensor(t, device=dev) for t in lanczos4_table(H, height))
    src = frames.to(torch.int32)
    # horizontal: int32 rows, exact (|sum| < 255 * 2048 * 2)
    rows = torch.zeros(frames.shape[0], H, width, frames.shape[3], dtype=torch.int32, device=dev)
    for k in range(8):
        rows += src[:, :, xi[:, k], :] * xc[:, k].to(torch.int32)[None, None, :, None]
    # vertical: int64 sums, then the rounding shift and saturation
    acc = torch.zeros(frames.shape[0], height, width, frames.shape[3], dtype=torch.int64,
                      device=dev)
    for k in range(8):
        acc += rows[:, yi[:, k]].to(torch.int64) * yc[:, k][None, :, None, None]
    out = (acc + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)
    return out.clamp_(0, 255).to(torch.uint8)


def _scales(src: int, dst: int) -> tuple[float, float]:
    """OpenCV's (inv_scale, scale) of one axis, in float64."""
    inv = dst / src
    return inv, 1.0 / inv


@functools.lru_cache(maxsize=16)
def area_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's `computeResizeAreaTab` for one axis (s >= 1) as (indices
    (dst, K) int64, weights (dst, K) float32), each output's entries in
    OpenCV's order, padded with weight 0 on index 0; cached, read-only."""
    scale = _scales(src, dst)[1]
    rows = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, (s1 - fs1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            row.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        rows.append(row)
    k = max(len(r) for r in rows)
    idx = np.zeros((dst, k), np.int64)
    alpha = np.zeros((dst, k), np.float32)
    for d, row in enumerate(rows):
        for j, (s, a) in enumerate(row):
            idx[d, j], alpha[d, j] = s, np.float32(a)
    idx.setflags(write=False)
    alpha.setflags(write=False)
    return idx, alpha


@functools.lru_cache(maxsize=16)
def area_linear_table(src: int, dst: int, columns: bool) -> tuple[np.ndarray, np.ndarray]:
    """The linear taps of INTER_AREA with an axis scaled up, for the columns
    or the rows: (indices (dst, 2) int64 clamped to the image, weights
    (dst, 2) int64 in fixed point, 2048 = 1); cached, read-only. Only the
    columns have OpenCV's edge rule (`xmax`); the rows clamp their taps."""
    inv, scale = _scales(src, dst)
    idx = np.empty((dst, 2), np.int64)
    coef = np.empty((dst, 2), np.int64)
    edge = False
    for d in range(dst):
        s = math.floor(d * scale)
        f = np.float32((d + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else np.float32(f - np.float32(math.floor(f)))
        if columns and s + 1 >= src:
            edge, f, s = True, np.float32(0.0), min(s, src - 1)
        w = np.float32([np.float32(1.0) - f, f]) * np.float32(COEF_SCALE)
        if edge:  # from OpenCV's xmax on: the one column, times 2048
            idx[d], coef[d] = (s, s), (COEF_SCALE, 0)
        else:
            idx[d], coef[d] = (min(s, src - 1), min(s + 1, src - 1)), np.rint(w).astype(np.int64)
    idx.setflags(write=False)
    coef.setflags(write=False)
    return idx, coef


def _area_pass(x: torch.Tensor, dim: int, table) -> torch.Tensor:
    """One axis of `resizeArea_`: the weighted source lines of each output
    line summed in OpenCV's order in float32 (no fused multiply-add)."""
    idx, alpha = (torch.tensor(t, device=x.device) for t in table)
    shape = [1] * x.ndim
    shape[dim] = idx.shape[0]
    out = None
    for k in range(idx.shape[1]):
        term = x.index_select(dim, idx[:, k]) * alpha[:, k].reshape(shape)
        out = term if out is None else out + term
    return out


def resize_area(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(F, H, W, C) uint8 -> (F, height, width, C) uint8 as
    `cv2.resize(frame, (width, height), interpolation=cv2.INTER_AREA)`."""
    _check_frames(frames)
    F_, H, W, C = frames.shape
    if (H, W) == (height, width):
        return frames.clone()
    sx, sy = _scales(W, width)[1], _scales(H, height)[1]
    dev = frames.device
    if sx >= 1 and sy >= 1:
        kx, ky = round(sx), round(sy)
        if abs(sx - kx) < 2.220446049250313e-16 and abs(sy - ky) < 2.220446049250313e-16:
            s = frames.to(torch.int32).reshape(F_, height, ky, width, kx, C).sum((2, 4))
            if kx == ky == 2 and C != 2:
                return ((s + 2) >> 2).to(torch.uint8)
            out = torch.round(s.to(torch.float32) * np.float32(1.0 / (kx * ky)))
            return out.clamp_(0, 255).to(torch.uint8)
        rows = _area_pass(frames.to(torch.float32), 2, area_table(W, width))
        out = _area_pass(rows, 1, area_table(H, height))
        return torch.round(out).clamp_(0, 255).to(torch.uint8)
    xi, xc = (torch.tensor(t, device=dev) for t in area_linear_table(W, width, True))
    yi, yc = (torch.tensor(t, device=dev) for t in area_linear_table(H, height, False))
    src = frames.to(torch.int32)
    xc = xc.to(torch.int32)[None, None, :, :, None]
    rows = src[:, :, xi[:, 0]] * xc[..., 0, :] + src[:, :, xi[:, 1]] * xc[..., 1, :]
    yc = yc.to(torch.int32)
    acc = None
    for k in range(2):
        r = (rows[:, yi[:, k]] >> 4).clamp_(-32768, 32767)
        term = (r * yc[:, k][None, :, None, None]) >> 16
        acc = term if acc is None else acc + term
    out = (acc.clamp_(-32768, 32767) + 2) >> 2
    return out.clamp_(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=16)
def nearest_table(src: int, dst: int) -> np.ndarray:
    """INTER_NEAREST's source index of each output along one axis; cached."""
    step = _scales(src, dst)[1]
    idx = np.array([min(math.floor(d * step), src - 1) for d in range(dst)], np.int64)
    idx.setflags(write=False)
    return idx


def resize_nearest(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(F, H, W, C) uint8 -> (F, height, width, C) uint8 as
    `cv2.resize(frame, (width, height), interpolation=cv2.INTER_NEAREST)`."""
    _check_frames(frames)
    _, H, W, _ = frames.shape
    yi = torch.tensor(nearest_table(H, height), device=frames.device)
    xi = torch.tensor(nearest_table(W, width), device=frames.device)
    return frames[:, yi][:, :, xi]


def _cubic_weights(fx: np.float32) -> np.ndarray:
    """OpenCV's `interpolateCubic` (A = -0.75) in float32."""
    A, one = np.float32(-0.75), np.float32(1.0)
    x1 = fx + one
    c0 = ((A * x1 - np.float32(5) * A) * x1 + np.float32(8) * A) * x1 - np.float32(4) * A
    c1 = ((A + np.float32(2)) * fx - (A + np.float32(3))) * fx * fx + one
    r = one - fx
    c2 = ((A + np.float32(2)) * r - (A + np.float32(3))) * r * r + one
    return np.array([c0, c1, c2, one - c0 - c1 - c2], np.float32)


@functools.lru_cache(maxsize=64)
def cubic_table(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """(indices (dst, 4) int64 clamped to [0, src), weights (dst, 4)
    float32) of one axis of an INTER_CUBIC resize; cached, read-only."""
    scale = 1.0 / (dst / src)
    idx = np.empty((dst, 4), np.int64)
    w = np.empty((dst, 4), np.float32)
    for d in range(dst):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = math.floor(fx)
        fx = np.float32(fx - np.float32(sx))
        idx[d] = np.clip(np.arange(sx - 1, sx + 3), 0, src - 1)
        w[d] = _cubic_weights(fx)
    idx.setflags(write=False)
    w.setflags(write=False)
    return idx, w


def _sum4(t: list, vector: torch.Tensor) -> torch.Tensor:
    """Four float32 products summed as OpenCV's vertical pass sums them:
    t0 + (t1 + (t2 + t3)) where `vector`, ((t0 + t1) + t2) + t3 elsewhere."""
    return torch.where(vector, t[0] + (t[1] + (t[2] + t[3])), ((t[0] + t[1]) + t[2]) + t[3])


def resize_cubic(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(N, H, W, C) uint8 or float32 -> (N, height, width, C), as
    `cv2.resize(image, (width, height), interpolation=cv2.INTER_CUBIC)` on
    each image (OpenCV's own code path; see the module's note on IPP)."""
    if x.ndim != 4 or x.dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"x must be (N, H, W, C) uint8 or float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    N, H, W, _ = x.shape
    if (H, W) == (height, width):
        return x.clone()
    boxes = np.stack([np.arange(N), np.zeros(N), np.zeros(N), np.full(N, H), np.full(N, W),
                      np.zeros(N)], -1).astype(np.int64)
    return resize_cubic_boxes(x, boxes, np.tile([height, width], (N, 1)))


def cubic_box_tables(boxes: np.ndarray, out_hw: np.ndarray, uint8: bool) -> list:
    """Host tables of `resize_cubic_boxes`: for each box (n, y0, x0, h, w,
    mirrored) the source rows (B, h_max) clamped to the box, the columns'
    absolute taps (B, W_out, 4) and weights, the rows' taps within the box
    (B, H_out, 4) and weights, each padded with weight 0."""
    B = len(boxes)
    h_max = int(boxes[:, 3].max())
    Ho, Wo = (int(v) for v in out_hw.max(0))
    wdt = np.int32 if uint8 else np.float32
    srow = boxes[:, 1, None] + np.minimum(np.arange(h_max), boxes[:, 3, None] - 1)
    cidx, cw = np.zeros((B, Wo, 4), np.int64), np.zeros((B, Wo, 4), wdt)
    ridx, rw = np.zeros((B, Ho, 4), np.int64), np.zeros((B, Ho, 4), wdt)
    for b, ((_, _, x0, h, w, mirrored), (oh, ow)) in enumerate(zip(boxes, out_hw)):
        ti, tw = cubic_table(int(w), int(ow))
        cidx[b, :ow] = x0 + ((w - 1 - ti) if mirrored else ti)
        cw[b, :ow] = np.rint(tw * np.float32(COEF_SCALE)) if uint8 else tw
        ti, tw = cubic_table(int(h), int(oh))
        ridx[b, :oh] = ti
        rw[b, :oh] = np.rint(tw * np.float32(COEF_SCALE)) if uint8 else tw
    return [srow, cidx, cw, ridx, rw]


def resize_cubic_boxes(x: torch.Tensor, boxes: np.ndarray, out_hw: np.ndarray) -> torch.Tensor:
    """Each box of (N, H, W, C) uint8 or float32 `x` INTER_CUBIC to its own
    size, all at once: `boxes` (B, 6) int64 host rows (n, y0, x0, h, w,
    mirrored) take x[n, y0:y0 + h, x0:x0 + w] (mirrored left to right when
    `mirrored` is 1, inside the image) to `out_hw` (B, 2) (height, width).
    Returns (B, H_out, W_out, C), each box's output in its top-left
    corner, as `cv2.resize` of the box alone (OpenCV copies a box of its
    output size; the cubic weights of a zero fraction, (0, 1, 0, 0), copy
    it too)."""
    uint8 = x.dtype == torch.uint8
    C = x.shape[3]
    srow, cidx, cw, ridx, rw, n, ow = upload(
        cubic_box_tables(boxes, out_hw, uint8) + [boxes[:, 0], out_hw[:, 1]], x.device)
    src = x.to(torch.int32) if uint8 else x
    # horizontal: (B, h_max, W_out, C), summed from tap 0 (exact for uint8)
    rows = None
    for k in range(4):
        t = src[n[:, None, None], srow[:, :, None], cidx[:, None, :, k]] * cw[:, None, :, k, None]
        rows = t if rows is None else rows + t
    # vertical: OpenCV's vector loop over the first lanes * floor(n / lanes)
    # of each output row's n = W_out * C elements, its scalar loop after
    lanes = 8 if uint8 else 4
    e = torch.arange(int(out_hw[:, 1].max()) * C, device=x.device).reshape(-1, C)
    vector = (e < (ow * C // lanes * lanes)[:, None, None])[:, None]  # (B, 1, W_out, C)
    b = torch.arange(len(boxes), device=x.device)[:, None]
    taps = [rows[b, ridx[:, :, k]] for k in range(4)]  # (B, H_out, W_out, C)
    if not uint8:
        return _sum4([t * rw[:, :, k, None, None] for k, t in enumerate(taps)], vector)
    exact = sum(t.to(torch.int64) * rw[:, :, k, None, None].to(torch.int64)
                for k, t in enumerate(taps))
    exact = (exact + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS)
    scale = np.float32(1.0 / (1 << 2 * COEF_BITS))  # the vector loop's float32 weights
    fast = _sum4([t.to(torch.float32) * (rw[:, :, k, None, None].to(torch.float32) * scale)
                  for k, t in enumerate(taps)], vector)
    fast = torch.round(fast).clamp_(-32768, 32767).to(torch.int64)
    return torch.where(vector, fast, exact).clamp_(0, 255).to(torch.uint8)


def resize_cubic_at(x: torch.Tensor, n: torch.Tensor, y: torch.Tensor, xs: torch.Tensor,
                    height: int, width: int) -> torch.Tensor:
    """`resize_cubic(x, height, width)[n, y, xs]` for (N, H, W, C) float32 x
    and (P,) int64 image, row and column indices, without the whole map:
    (P, C) float32."""
    N, H, W, C = x.shape
    if (H, W) == (height, width):
        return x[n, y, xs]
    xi, xw, yi, yw = upload([*cubic_table(W, width), *cubic_table(H, height)], x.device)
    cols, a = xi[xs], xw[xs][..., None]  # (P, 4), (P, 4, 1)
    t = []
    for k in range(4):
        src = x[n[:, None], yi[y, k][:, None], cols]  # (P, 4, C)
        row = src[:, 0] * a[:, 0]
        for j in range(1, 4):
            row = row + src[:, j] * a[:, j]
        t.append(row * yw[y, k][:, None])
    e = xs[:, None] * C + torch.arange(C, device=x.device)
    return _sum4(t, e < (width * C) // 4 * 4)
