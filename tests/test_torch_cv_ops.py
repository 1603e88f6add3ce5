"""The OpenPose annotator's OpenCV and scipy operations, rebuilt in the port,
against OpenCV and scipy on the CPU, bit for bit:

  * `ops/resize.py` `resize_cubic` (INTER_CUBIC) for float32 maps of 1, 3,
    19, 22, 38 and 71 channels and uint8 images of 1 and 3, down, up, equal
    and mixed sizes (the 23x16 stride-8 maps of a 768x512 frame to full
    size, odd crops to 368x368), and `resize_cubic_at` at chosen pixels.
    The reference is OpenCV's own code path: a build with Intel IPP (this
    one) hands 1-, 3- and 4-channel images to IPP, which differs from it
    by 1 on a few per cent of the pixels; the tests turn IPP off
    (`cv2.setUseOptimized(False)`) where they hold such images, and state
    IPP's difference from the port where it is on;
  * `ops/gaussian.py` `gaussian_filter` against
    `scipy.ndimage.gaussian_filter(m, sigma=3)` on random and plateau maps,
    at sizes below the filter's radius too;
  * `ops/draw.py`: `cv2.ellipse2Poly` for every whole angle and the axis
    lengths a 768x512 frame allows, `cv2.fillConvexPoly` of those polygons,
    `cv2.circle` (radius 1, 3, 4, filled) and `cv2.line` of thickness 2,
    over random, edge-clipped and zero-length cases, each shape on its own
    canvas; and `paint_runs`' order: a later shape over an earlier one."""

import cv2
import numpy as np
import pytest
import scipy.ndimage
import torch

from controlanimate_tpu_torch.ops import draw
from controlanimate_tpu_torch.ops.gaussian import gaussian_filter
from controlanimate_tpu_torch.ops.resize import resize_cubic, resize_cubic_at


@pytest.fixture
def opencv_path():
    """OpenCV's own code path (IPP off) for the duration of a test."""
    cv2.setUseOptimized(False)
    yield
    cv2.setUseOptimized(True)


def _cv_cubic(images, hw):
    return np.stack([cv2.resize(f, hw[::-1], interpolation=cv2.INTER_CUBIC).reshape(
        hw[0], hw[1], -1) for f in images])


@pytest.mark.parametrize("channels,src,dst", [
    (19, (23, 16), (768, 512)), (38, (23, 16), (768, 512)), (38, (23, 35), (184, 283)),
    (22, (46, 46), (97, 97)), (22, (46, 46), (30, 30)), (71, (46, 46), (58, 58)),
    (71, (46, 46), (400, 400)), (19, (21, 17), (35, 52)), (22, (16, 23), (17, 16)),
    (38, (10, 10), (10, 10))])
def test_resize_cubic_float_is_opencv(src, dst, channels):
    """Many-channel float32 maps (never IPP's): the heat and PAF maps up to
    the frame, the hand and face heat to a box's width; down, equal and
    mixed."""
    maps = np.random.RandomState(channels + sum(dst)).randn(2, *src, channels).astype(np.float32)
    got = resize_cubic(torch.from_numpy(maps), *dst).numpy()
    np.testing.assert_array_equal(got, _cv_cubic(maps, dst))


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_cubic_float_few_channels_is_opencv(channels, opencv_path):
    maps = np.random.RandomState(channels).randn(2, 40, 30, channels).astype(np.float32)
    for dst in ((17, 13), (80, 61), (40, 9)):
        got = resize_cubic(torch.from_numpy(maps), *dst).numpy()
        np.testing.assert_array_equal(got, _cv_cubic(maps, dst))


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", [((768, 512), (184, 128)), ((57, 43), (368, 368)),
                                     ((66, 66), (368, 368)), ((400, 381), (368, 368)),
                                     ((37, 23), (300, 13)), ((368, 368), (368, 368))])
def test_resize_cubic_uint8_is_opencv(src, dst, channels, opencv_path):
    """uint8 frames and crops: the body input of a 768x512 frame, hand and
    face crops up and down to 368x368, and a tall narrow one whose rows
    end in OpenCV's scalar loop (13 x 3 = 39 elements)."""
    frames = np.random.RandomState(sum(src) + channels).randint(
        0, 256, (2, *src, channels), dtype=np.uint8)
    got = resize_cubic(torch.from_numpy(frames), *dst).numpy()
    np.testing.assert_array_equal(got, _cv_cubic(frames, dst))


def test_resize_cubic_uint8_against_ipp():
    """With IPP on (the build's default), OpenCV's 8-bit 3-channel cubic
    resize differs from its own code path, and so from the port, by at most
    1 on under 5% of the pixels of the 768x512 frame's body input."""
    frames = np.random.RandomState(3).randint(0, 256, (2, 768, 512, 3), dtype=np.uint8)
    got = resize_cubic(torch.from_numpy(frames), 184, 128).numpy().astype(int)
    diff = np.abs(got - _cv_cubic(frames, (184, 128)).astype(int))
    assert diff.max() <= 1 and 0 < diff.mean() < 0.05, (diff.max(), diff.mean())


def test_resize_cubic_at_is_the_resize():
    rng = np.random.RandomState(4)
    maps = torch.from_numpy(rng.randn(3, 23, 16, 38).astype(np.float32))
    full = resize_cubic(maps, 768, 512)
    n, y, x = (torch.from_numpy(rng.randint(0, hi, 500)) for hi in (3, 768, 512))
    assert torch.equal(resize_cubic_at(maps, n, y, x, 768, 512), full[n, y, x])


@pytest.mark.parametrize("shape", [(368, 368), (768, 512), (66, 71), (9, 30), (1, 5)])
def test_gaussian_filter_is_scipy(shape):
    """Random maps, plateaus (values in steps of 1/4, so that sums tie) and
    a map shorter than the radius 12 on one side."""
    rng = np.random.RandomState(sum(shape))
    maps = [rng.rand(*shape).astype(np.float32), (np.round(rng.rand(*shape) * 4) / 4)
            .astype(np.float32), np.zeros(shape, np.float32)]
    maps[2][shape[0] // 2:, shape[1] // 3:] = 0.75
    got = gaussian_filter(torch.from_numpy(np.stack(maps))).numpy()
    for g, m in zip(got, maps):
        np.testing.assert_array_equal(g, scipy.ndimage.gaussian_filter(m, sigma=3))


def _canvases(runs, owner, n, h, w):
    c = np.zeros((n, h, w), np.uint8)
    for (y, x0, x1), o in zip(runs, owner):
        c[o, y, x0:x1 + 1] = 255
    return c


def test_ellipse_poly_is_opencv():
    """Every whole angle from -360 to 720 at the axis lengths of limbs up to
    a 768x512 frame's diagonal, centres in and off the frame."""
    rng = np.random.RandomState(5)
    for angle in range(-360, 721):
        for axis in (0, 1, 2, 3, 4, int(rng.randint(5, 462))):
            c = (int(rng.randint(-40, 552)), int(rng.randint(-40, 808)))
            want = cv2.ellipse2Poly(c, (axis, 4), angle, 0, 360, 1)
            np.testing.assert_array_equal(draw.ellipse_poly(c, (axis, 4), angle), want)


@pytest.mark.parametrize("case", ["inside", "clipped", "thin"])
def test_fill_convex_poly_is_opencv(case):
    """The body's limb polygons filled, one a canvas."""
    rng = np.random.RandomState(len(case))
    h, w = 96, 128
    n = 300
    lo, hi = {"inside": (10, 80), "clipped": (-80, 200), "thin": (0, 96)}[case]
    polys = []
    for _ in range(n):
        c = (int(rng.randint(lo, hi)), int(rng.randint(lo, hi)))
        axis = int(rng.choice([0, 1, 2])) if case == "thin" else int(rng.randint(0, 150))
        polys.append(draw.ellipse_poly(c, (axis, 4), int(rng.randint(0, 360))))
    want = np.zeros((n, h, w), np.uint8)
    for canvas, p in zip(want, polys):
        cv2.fillConvexPoly(canvas, p, 255)
    np.testing.assert_array_equal(_canvases(*draw.convex_poly_runs(polys, h, w), n, h, w), want)


@pytest.mark.parametrize("r", [1, 3, 4])
def test_disc_is_opencv(r):
    rng = np.random.RandomState(r)
    h, w = 40, 50
    centres = np.stack([rng.randint(-6, w + 6, 400), rng.randint(-6, h + 6, 400)], -1)
    want = np.zeros((len(centres), h, w), np.uint8)
    for canvas, c in zip(want, centres):
        cv2.circle(canvas, (int(c[0]), int(c[1])), r, 255, -1)
    got = _canvases(*draw.disc_runs(centres, r, h, w), len(centres), h, w)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["random", "short", "clipped"])
def test_thick_line_is_opencv(case):
    """`cv2.line(canvas, a, b, 255, 2)`: long and short segments, points,
    and ends far off the canvas (OpenCV clips a thick line to the canvas
    grown by its thickness first)."""
    rng = np.random.RandomState(7 + len(case))
    h, w = 96, 128
    n = 500
    a = np.stack([rng.randint(-20, w + 20, n), rng.randint(-20, h + 20, n)], -1)
    d = {"random": lambda: rng.randint(-90, 90, (n, 2)),
         "short": lambda: rng.randint(-2, 3, (n, 2)),
         "clipped": lambda: rng.randint(-400, 400, (n, 2))}[case]()
    b = a + d
    want = np.zeros((n, h, w), np.uint8)
    for canvas, p, q in zip(want, a, b):
        cv2.line(canvas, (int(p[0]), int(p[1])), (int(q[0]), int(q[1])), 255, 2)
    np.testing.assert_array_equal(_canvases(*draw.thick_line_runs(a, b, h, w), n, h, w), want)


def test_paint_runs_later_shapes_win():
    """Shapes in OpenCV's call order on two canvases: each pixel takes the
    colour of the last shape drawn over it."""
    h, w = 40, 60
    calls = [(0, "poly", draw.ellipse_poly((30, 20), (20, 4), 30), (255, 0, 0)),
             (0, "disc", (30, 20), (0, 255, 0)), (1, "line", ((0, 0), (59, 39)), (0, 0, 255)),
             (0, "line", ((5, 35), (55, 5)), (9, 9, 9)), (1, "disc", (10, 7), (1, 2, 3))]
    want = np.zeros((2, h, w, 3), np.uint8)
    runs, canvas_of, prim_of = [], [], []
    for p, (f, kind, shape, colour) in enumerate(calls):
        if kind == "poly":
            cv2.fillConvexPoly(want[f], shape, colour)
            r, _ = draw.convex_poly_runs([shape], h, w)
        elif kind == "disc":
            cv2.circle(want[f], shape, 4, colour, -1)
            r, _ = draw.disc_runs(np.array([shape]), 4, h, w)
        else:
            cv2.line(want[f], *shape, colour, 2)
            r, _ = draw.thick_line_runs(np.array([shape[0]]), np.array([shape[1]]), h, w)
        runs.append(r)
        canvas_of.append(np.full(len(r), f))
        prim_of.append(np.full(len(r), p))
    got = draw.paint_runs(np.concatenate(runs), np.concatenate(canvas_of),
                          np.concatenate(prim_of), [c[-1] for c in calls], 2, h, w, "cpu")
    np.testing.assert_array_equal(got.numpy(), want)
