"""Drawing on the frames' device, bit for bit as OpenCV draws.

`lines` is `cv2.line(canvas, p1, p2, 255, 1)` (thickness 1, LINE_8) for all
of a batch's segments at once, as the MLSD annotator draws its segments
(`controlanimate_tpu/models/annotators/mlsd_net.py` `run`). OpenCV's path,
in int64:

- `clipLine` against the canvas [0, W - 1] x [0, H - 1]: outcodes (bit 1
  x < 0, 2 x > right, 4 y < 0, 8 y > bottom); a segment with both ends on
  one side is dropped; otherwise an end outside in y moves to the edge row
  (x += trunc(float64(a - y) * (x2 - x1) / (y2 - y1)), the second end from
  the first's new place), then an end outside in x to the edge column
  alike; the segment is drawn only if both outcodes end at 0;
- `LineIterator(..., 8, leftToRight=true)`: the ends swap when x2 < x1;
  along the major axis (y when |dy| > |dx|) each of the max(|dx|, |dy|) + 1
  pixels steps by one, and the minor coordinate steps on the error rule
  err = L - 2m, err -= 2m each step, += 2L when it was negative (L, m the
  major and minor lengths). After k steps the minor axis has moved
  ceil((2 m k - L) / (2 L)) times, which is what `line_pixels` computes for
  every pixel of every segment at once.

The OpenPose annotator's filled shapes (`controlanimate_tpu/models/
annotators/openpose*.py`) are OpenCV's too, LINE_8, shift 0:

- `ellipse_poly`: `cv2.ellipse2Poly(center, axes, angle, 0, 360, 1)`. The
  sines come from OpenCV's table of whole degrees (`SIN_TABLE`, the sines
  rounded to 7 decimals, in float32); the 361 vertices are summed in
  float64, rounded half to even and repeated points dropped.
- `convex_poly_runs`: `cv2.fillConvexPoly(canvas, poly, colour)` and the
  quadrilateral of a thick line (`FillConvexPoly` with 16 fraction bits):
  the outline (thickness-1 lines for shift 0, OpenCV's fixed-point `Line2`
  for shift 16) and the scanline walk down the polygon's two chains from its
  top vertex, each chain's x in 16.16 fixed point stepping by
  ((xe - xs) * 2 + dy) / (2 dy) (C division) a row.
- `disc_runs`: `cv2.circle(canvas, c, r, colour, -1)`, the midpoint circle's
  spans, clipped to the canvas.
- `thick_line_runs`: `cv2.line(canvas, a, b, colour, 2)`: a quadrilateral
  of half-width 1 in 16.16 fixed point (its offset rounded half to even)
  and discs of radius 1 on both ends.

These give a primitive's pixels as horizontal runs (y, x0, x1) on the host,
where the primitives are made; `paint_runs` paints every run of a batch of
canvases on the device at once, each pixel taking the highest primitive id
that covers it, so that a later shape overwrites an earlier one as in
OpenCV's order of calls.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .host import upload

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
# OpenCV's SinTable: sin of 0..450 degrees, rounded to 7 decimals, float32
SIN_TABLE = np.array([round(math.sin(math.radians(d)), 7) for d in range(451)], np.float32)
# the table's sines and cosines of 0..360 degrees, widened to float64
_SIN64 = SIN_TABLE[:361].astype(np.float64)
_COS64 = SIN_TABLE[450 - np.arange(361)].astype(np.float64)


def _outcode(x, y, right: int, bottom: int):
    return (x < 0).long() | (x > right).long() << 1 | (y < 0).long() << 2 | (y > bottom).long() << 3


def _trunc_step(num, factor, den):
    """OpenCV's (int64)((double)num * factor / den), den 0 taken as 1 (the
    lanes where it is 0 are not used)."""
    den = torch.where(den == 0, torch.ones_like(den), den)
    return (num.double() * factor.double() / den.double()).to(torch.int64)


def clip_segments(p1: torch.Tensor, p2: torch.Tensor, height: int, width: int):
    """OpenCV's `clipLine` for (..., 2) int64 (x, y) ends: the clipped ends
    and whether anything of each segment is left on the canvas."""
    right, bottom = width - 1, height - 1
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    c1, c2 = _outcode(x1, y1, right, bottom), _outcode(x2, y2, right, bottom)
    clip = ((c1 & c2) == 0) & ((c1 | c2) != 0)
    # an end outside in y moves to the edge row
    m = clip & ((c1 & 12) != 0)
    a = torch.where(c1 < 8, 0, bottom)
    x1 = torch.where(m, x1 + _trunc_step(a - y1, x2 - x1, y2 - y1), x1)
    y1 = torch.where(m, a, y1)
    c1 = torch.where(m, (x1 < 0).long() | (x1 > right).long() << 1, c1)
    m = clip & ((c2 & 12) != 0)
    a = torch.where(c2 < 8, 0, bottom)
    x2 = torch.where(m, x2 + _trunc_step(a - y2, x2 - x1, y2 - y1), x2)
    y2 = torch.where(m, a, y2)
    c2 = torch.where(m, (x2 < 0).long() | (x2 > right).long() << 1, c2)
    # then an end outside in x to the edge column
    clip = clip & ((c1 & c2) == 0) & ((c1 | c2) != 0)
    m = clip & (c1 != 0)
    a = torch.where(c1 == 1, 0, right)
    y1 = torch.where(m, y1 + _trunc_step(a - x1, y2 - y1, x2 - x1), y1)
    x1 = torch.where(m, a, x1)
    c1 = torch.where(m, 0, c1)
    m = clip & (c2 != 0)
    a = torch.where(c2 == 1, 0, right)
    y2 = torch.where(m, y2 + _trunc_step(a - x2, y2 - y1, x2 - x1), y2)
    x2 = torch.where(m, a, x2)
    c2 = torch.where(m, 0, c2)
    return torch.stack([x1, y1], -1), torch.stack([x2, y2], -1), (c1 | c2) == 0


def line_pixels(p1: torch.Tensor, p2: torch.Tensor, keep: torch.Tensor, height: int,
                width: int, steps: int | None = None):
    """The pixels `cv2.line(canvas, p1, p2, colour, 1)` sets for (..., 2)
    int64 (x, y) ends: (x, y, on), each (..., steps) with `steps` (default
    max(height, width)) positions along each segment and `on` marking those
    drawn (`keep` and on the clipped segment)."""
    p1, p2, visible = clip_segments(p1, p2, height, width)
    keep = keep & visible
    # leftToRight: the ends swap when x2 < x1
    swap = (p2[..., 0] < p1[..., 0])[..., None]
    p1, p2 = torch.where(swap, p2, p1), torch.where(swap, p1, p2)
    dx = p2[..., 0] - p1[..., 0]
    dy = p2[..., 1] - p1[..., 1]
    sy = torch.where(dy < 0, -1, 1)
    ady = dy.abs()
    vert = ady > dx
    major = torch.maximum(dx, ady)
    minor = torch.minimum(dx, ady)
    k = torch.arange(max(height, width) if steps is None else steps, device=p1.device)
    L, mm = major[..., None], minor[..., None]
    moved = torch.div(2 * mm * k + L - 1, torch.clamp(2 * L, min=1), rounding_mode="floor")
    moved = torch.where(L == 0, 0, moved)
    vx = vert[..., None]
    x = p1[..., 0, None] + torch.where(vx, moved, k)
    y = p1[..., 1, None] + sy[..., None] * torch.where(vx, k, moved)
    return x, y, keep[..., None] & (k <= L)


def lines(p1: torch.Tensor, p2: torch.Tensor, keep: torch.Tensor, height: int,
          width: int) -> torch.Tensor:
    """(N, S, 2) int64 (x, y) ends and an (N, S) bool mask of the segments to
    draw -> (N, height, width) uint8 canvases with 255 on every pixel that
    `cv2.line(canvas, p1, p2, 255, 1)` sets, for each segment of each canvas
    in turn, and 0 elsewhere."""
    n = p1.shape[0]
    dev = p1.device
    x, y, on = line_pixels(p1, p2, keep, height, width)
    # every pixel not drawn goes to one spare slot past the canvases
    flat = torch.arange(n, device=dev)[:, None, None] * (height * width) + y * width + x
    flat = torch.where(on, flat, n * height * width)
    canvas = torch.zeros(n * height * width + 1, dtype=torch.uint8, device=dev)
    canvas.index_fill_(0, flat.reshape(-1), 255)
    return canvas[:-1].reshape(n, height, width)


# -- OpenPose's filled shapes, as runs (y, x0, x1) made on the host -------------
NO_RUNS = np.zeros((0, 3), np.int64)


def _cdiv(a, b):
    """C's integer division (toward zero), elementwise on int64 arrays."""
    q = np.abs(a) // np.abs(b)
    return np.where((a >= 0) == (b >= 0), q, -q)


def ellipse_poly(center, axes, angle: int) -> np.ndarray:
    """`cv2.ellipse2Poly(center, axes, angle, 0, 360, 1)` as (n, 2) int64."""
    while angle < 0:
        angle += 360
    while angle > 360:
        angle -= 360
    cos, sin = _COS64[angle], _SIN64[angle]
    x = float(axes[0]) * _COS64
    y = float(axes[1]) * _SIN64
    pts = np.stack([np.rint(center[0] + x * cos - y * sin),
                    np.rint(center[1] + x * sin + y * cos)], -1).astype(np.int64)
    new = np.ones(len(pts), bool)
    new[1:] = (pts[1:] != pts[:-1]).any(1)
    pts = pts[new]
    if len(pts) == 1:
        pts = np.array([center, center], np.int64)
    return pts


def _pixels(x, y, on, owner):
    """Single pixels (x, y) where `on`, as runs, with the owner of each."""
    y, x, owner = y[on], x[on], np.broadcast_to(owner, on.shape)[on]
    return np.stack([y, x, x], -1), owner


def _line_runs(p1: np.ndarray, p2: np.ndarray, owner: np.ndarray, height: int, width: int):
    """The thickness-1 lines between the (S, 2) ends, as runs and owners."""
    steps = int(np.abs(p2 - p1).max()) + 1
    x, y, on = line_pixels(torch.from_numpy(p1), torch.from_numpy(p2),
                           torch.ones(len(p1), dtype=torch.bool), height, width, steps)
    return _pixels(x.numpy(), y.numpy(), on.numpy(), owner[:, None])


def _line2_runs(p1: np.ndarray, p2: np.ndarray, owner: np.ndarray, height: int, width: int):
    """OpenCV's `Line2` (LINE_8 between 16.16 fixed-point ends) for each of
    the (S, 2) pairs, as runs and owners: clipped to the canvas scaled by
    2^16, then stepped along the major axis from the end with the smaller
    major coordinate, the minor one by (d << 16) / (major length | 1) (C
    division) a pixel, plus the far end; pixels off the canvas dropped."""
    q1, q2, visible = clip_segments(torch.from_numpy(p1), torch.from_numpy(p2),
                                    height << XY_SHIFT, width << XY_SHIFT)
    q1, q2, visible = q1.numpy(), q2.numpy(), visible.numpy()
    half = XY_ONE >> 1
    d = q2 - q1
    xmajor = np.abs(d[:, 0]) > np.abs(d[:, 1])
    swap = np.where(xmajor, d[:, 0] < 0, d[:, 1] < 0)[:, None]
    a, b = np.where(swap, q2, q1), np.where(swap, q1, q2)
    d = b - a
    major = np.where(xmajor, 0, 1)[:, None]
    minor = 1 - major
    span = np.take_along_axis(d, major, 1)[:, 0]
    step = _cdiv(np.take_along_axis(d, minor, 1)[:, 0] << XY_SHIFT, np.abs(span) | 1)
    k = np.arange(int((span >> XY_SHIFT).max(initial=0)) + 1)
    start_major = (np.take_along_axis(a, major, 1) + half) >> XY_SHIFT
    along = start_major + k
    across = (np.take_along_axis(a, minor, 1) + half + k * step[:, None]) >> XY_SHIFT
    x = np.where(xmajor[:, None], along, across)
    y = np.where(xmajor[:, None], across, along)
    on = visible[:, None] & (k <= (span >> XY_SHIFT)[:, None])
    far = (b + half) >> XY_SHIFT
    x = np.concatenate([x, far[:, :1]], 1)
    y = np.concatenate([y, far[:, 1:]], 1)
    on = np.concatenate([on, visible[:, None]], 1)
    on &= (x >= 0) & (x < width) & (y >= 0) & (y < height)
    return _pixels(x, y, on, owner[:, None])


def _chains(v: list, height: int, shift: int, chunks: list, owner: int) -> None:
    """`FillConvexPoly`'s scanline walk of one polygon: down its two chains
    from the first top vertex, each chain's x in 16.16 fixed point stepping
    by ((xe - xs) * 2 + dy) / (2 dy) (C division) a row. Appends a chunk
    (first row, end row, x and step of both chains, owner) for each run of
    rows that takes no new edge."""
    npts = len(v)
    up = XY_SHIFT - shift
    delta = (1 << shift) >> 1
    vx, vy = [p[0] for p in v], [p[1] for p in v]
    ymin, ymax = (min(vy) + delta) >> shift, (max(vy) + delta) >> shift
    ymax = min(ymax, height - 1)
    imin = vy.index(min(vy))
    idx, di, ye = [imin, imin], [1, npts - 1], [ymin, ymin]
    x, dx = [-XY_ONE, -XY_ONE], [0, 0]
    edges, y = npts, ymin
    while True:
        for i in range(2):
            if y < ye[i]:
                continue
            idx0 = idx[i]
            j = (idx0 + di[i]) % npts
            while edges > 0:
                edges -= 1
                ty = (vy[j] + delta) >> shift
                if ty > y:
                    ye[i], idx[i] = ty, j
                    x[i] = vx[idx0] << up
                    num, den = ((vx[j] - vx[idx0]) << up) * 2 + (ty - y), 2 * (ty - y)
                    q = abs(num) // den
                    dx[i] = q if num >= 0 else -q
                    break
                idx0, j = j, (j + di[i]) % npts
            else:
                edges -= 1
        if edges < 0:
            return
        stop = min(ye[0], ye[1], ymax + 1)
        chunks.append((y, stop, x[0], dx[0], x[1], dx[1], owner))
        x = [x[0] + dx[0] * (stop - y), x[1] + dx[1] * (stop - y)]
        y = stop
        if y > ymax:
            return


def convex_poly_runs(polys: list, height: int, width: int, shift: int = 0):
    """OpenCV's `FillConvexPoly` (LINE_8) of each (n, 2) int64 polygon with
    `shift` fraction bits (0, or 16 for a thick line's quadrilateral): its
    outline (thickness-1 lines for shift 0, `Line2` for 16) and its
    scanline spans, clipped to the canvas. Returns (R, 3) runs and the
    (R,) index of the polygon of each."""
    if not polys:
        return NO_RUNS, np.zeros(0, np.int64)
    sizes = np.array([len(v) for v in polys])
    first = np.cumsum(sizes) - sizes
    verts = np.concatenate(polys)
    prev = np.arange(len(verts)) - 1
    prev[first] = first + sizes - 1  # each polygon's outline starts from its last vertex
    edge_of = np.repeat(np.arange(len(polys)), sizes)
    up = XY_SHIFT - shift
    if shift == 0:
        runs, owner = _line_runs(verts[prev], verts, edge_of, height, width)
    else:
        runs, owner = _line2_runs(verts[prev] << up, verts << up, edge_of, height, width)
    out, owners, chunks = [runs], [owner], []
    delta = (1 << shift) >> 1
    lo = (np.minimum.reduceat(verts, first) + delta) >> shift
    hi = (np.maximum.reduceat(verts, first) + delta) >> shift
    fill = ((sizes >= 3) & (hi[:, 0] >= 0) & (hi[:, 1] >= 0) & (lo[:, 0] < width)
            & (lo[:, 1] < height))
    for n in np.flatnonzero(fill).tolist():
        _chains(polys[n].tolist(), height, shift, chunks, n)
    if chunks:
        c = np.array(chunks, np.int64)
        rows_n = c[:, 1] - c[:, 0]
        c = np.repeat(c, rows_n, 0)
        k = np.arange(len(c)) - np.repeat(np.cumsum(rows_n) - rows_n, rows_n)
        xa, xb = c[:, 2] + c[:, 3] * k, c[:, 4] + c[:, 5] * k
        half = XY_ONE >> 1
        rows = c[:, 0] + k
        x1 = (np.minimum(xa, xb) + half) >> XY_SHIFT
        x2 = (np.maximum(xa, xb) + half) >> XY_SHIFT
        ok = (rows >= 0) & (x2 >= 0) & (x1 < width)
        out.append(np.stack([rows[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok], width - 1)],
                            -1))
        owners.append(c[ok, 6])
    return np.concatenate(out), np.concatenate(owners)


def _disc_offsets(r: int) -> np.ndarray:
    """OpenCV's filled `Circle` of radius r about 0: (2r + 1, 3) runs."""
    half = {}
    err, dx, dy, plus, minus = 0, r, 0, 1, (r << 1) - 1
    while dx >= dy:
        for row, w in ((dy, dx), (-dy, dx), (dx, dy), (-dx, dy)):
            half[row] = max(half.get(row, -1), w)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2
    rows = np.array(sorted(half))
    w = np.array([half[k] for k in rows])
    return np.stack([rows, -w, w], -1)


def disc_runs(centers: np.ndarray, r: int, height: int, width: int):
    """`cv2.circle(canvas, c, r, colour, -1)` (LINE_8) for each of the (n, 2)
    int64 centres: runs and the index of the disc of each."""
    off = _disc_offsets(r)
    c = np.asarray(centers, np.int64).reshape(-1, 1, 2)
    y = off[:, 0] + c[..., 1]
    x0, x1 = off[:, 1] + c[..., 0], off[:, 2] + c[..., 0]
    ok = (y >= 0) & (y < height) & (x1 >= 0) & (x0 < width)
    owner = np.broadcast_to(np.arange(len(c))[:, None], ok.shape)
    return (np.stack([y[ok], np.maximum(x0[ok], 0), np.minimum(x1[ok], width - 1)], -1),
            owner[ok])


THICK = 2  # the hands' line thickness


def thick_line_runs(p0: np.ndarray, p1: np.ndarray, height: int, width: int):
    """`cv2.line(canvas, a, b, colour, 2)` (LINE_8) for each pair of (n, 2)
    int64 ends: runs and the index of the line of each. Each segment is
    first clipped (`clipLine`) to the canvas grown by the thickness on each
    side and dropped if nothing is left; then a quadrilateral of half-width
    1 about it in 16.16 fixed point (its offset rounded half to even) and
    discs of radius 1 on both ends."""
    q0, q1, visible = clip_segments(torch.from_numpy(p0 + THICK), torch.from_numpy(p1 + THICK),
                                    height + 2 * THICK, width + 2 * THICK)
    keep = np.flatnonzero(visible.numpy())
    p0 = (q0.numpy()[keep] - THICK) << XY_SHIFT
    p1 = (q1.numpy()[keep] - THICK) << XY_SHIFT
    dx = (p0[:, 0] - p1[:, 0]) / XY_ONE
    dy = (p1[:, 1] - p0[:, 1]) / XY_ONE
    r2 = dx * dx + dy * dy
    wide = r2 > np.finfo(np.float64).eps
    r = XY_ONE / np.sqrt(np.where(wide, r2, 1.0))  # thickness 2: half-width 1
    dp = np.stack([np.rint(dy * r), np.rint(dx * r)], -1).astype(np.int64)
    quads = [np.stack([a + d, a - d, b - d, b + d]) for a, b, d, w in zip(p0, p1, dp, wide) if w]
    runs, owner = convex_poly_runs(quads, height, width, XY_SHIFT)
    half = XY_ONE >> 1
    ends = (np.concatenate([p0, p1]) + half) >> XY_SHIFT
    druns, downer = disc_runs(ends, (XY_ONE + half) >> XY_SHIFT, height, width)
    return (np.concatenate([runs, druns]),
            np.concatenate([keep[np.flatnonzero(wide)][owner], np.tile(keep, 2)[downer]]))


def paint_runs(runs: np.ndarray, canvas_of: np.ndarray, prim_of: np.ndarray, colours,
               n: int, height: int, width: int, device) -> torch.Tensor:
    """(n, height, width, 3) uint8 canvases on `device`, black but for the
    runs: (R, 3) int64 (y, x0, x1), the canvas and the primitive of each,
    and the (P, 3) uint8 colour of each primitive. A pixel several
    primitives cover takes the colour of the highest-numbered one."""
    lengths = runs[:, 2] - runs[:, 1] + 1
    colours, table, lengths_d = upload([
        np.asarray(colours, np.uint8).reshape(-1, 3),
        np.stack([runs[:, 0], runs[:, 1], canvas_of, prim_of, np.cumsum(lengths) - lengths], -1),
        lengths], device)
    ids = torch.full((n * height * width,), -1, dtype=torch.int64, device=device)
    if len(runs):
        total = int(lengths.sum())
        run = torch.repeat_interleave(torch.arange(len(runs), device=device), lengths_d,
                                      output_size=total)
        y, x0, c, prim, start = table[run].unbind(-1)
        x = x0 + torch.arange(total, device=device) - start
        ids.scatter_reduce_(0, (c * height + y) * width + x, prim, "amax")
    black = torch.zeros(1, 3, dtype=torch.uint8, device=device)
    return torch.cat([colours, black])[ids].reshape(n, height, width, 3)
