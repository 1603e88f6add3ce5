"""The port's `FaceEnhancer` (`models/gfpgan.py`) and the `Upscaler` with
the face step against the JAX package's, end to end on uint8 frames, on the
CPU: a tiny GFPGAN (out 32, style 16, narrow 1/16; the JAX decoder's noise
fed to the port), the real-architecture RetinaFace file and a 64-feature
RealESRGAN, each written as a checkpoint that both packages read. The
landmarks are given (`detect_landmarks` replaced in both packages, as the
JAX face tests do): a random detector finds no face at 0.97. The detector's
filters (eye distance, `only_center_face`) run on rows given to both.

Gate: uint8 within 1 LSB of JAX with at most 1% of values differing, for a
restored crop, an enhanced frame, and the Upscaler's frames in both
`upscale_first` orders at scales 2 and 4 (seen: the crop and the frames
at 1x and 2x equal, 0.003% of values off by 1 at 4x, at most 0.07% through
the Upscaler). Also the two JAX behaviours the port does not copy: a
missing GFPGAN file (JAX upscales only) and a missing RetinaFace file (JAX
falls back to a Haar cascade) raise FileNotFoundError."""

import cv2
import numpy as np
import pytest
import torch

from controlanimate_tpu.models import gfpgan as jg
from controlanimate_tpu.models.upscaler import Upscaler as JaxUpscaler
from controlanimate_tpu_torch.models import gfpgan as tg
from controlanimate_tpu_torch.models.upscaler import Upscaler
from controlanimate_tpu_torch.weights import from_jax
from test_retinaface import synth_retinaface_sd
from test_torch_common import seeded_rrdbnet
from test_torch_face_align import landmarks
from test_torch_gfpgan import KW, SIZE, JaxFaceNoise, gfpgan_pair

FACE_KW = dict(face_size=SIZE, model_kwargs=KW[0])


def write_face_checkpoints(directory, seed: int = 0) -> tuple[str, str]:
    """(GFPGAN path, RetinaFace path): the tiny GFPGAN of
    tests/test_torch_gfpgan.py in the GFPGANv1.3 layout (`params_ema`, with
    a style MLP the loaders drop) and a synthetic detection_Resnet50_Final."""
    _, params, _ = gfpgan_pair(KW[0], seed=seed)
    sd = from_jax.gfpgan_state_dict(params, SIZE)
    sd["stylegan_decoder.style_mlp.1.weight"] = torch.zeros(16, 16)
    gfp, det = directory / "GFPGANv1.3.pth", directory / "detection_Resnet50_Final.pth"
    torch.save({"params_ema": sd}, gfp)
    torch.save({k: torch.from_numpy(v) for k, v in synth_retinaface_sd(seed).items()}, det)
    return str(gfp), str(det)


def face_landmarks(frame, **_):
    """Two faces a frame, placed by the frame's size."""
    h, w = frame.shape[:2]
    return [landmarks(h, w, 0.6, 0.2, (-0.1 * w, 0.05 * h)),
            landmarks(h, w, 0.35, -0.4, (0.25 * w, -0.2 * h))]


@pytest.fixture
def given_landmarks(monkeypatch):
    """Both packages' enhancers find `face_landmarks` in every frame."""
    monkeypatch.setattr(jg.FaceEnhancer, "detect_landmarks",
                        lambda self, frame, **kw: face_landmarks(frame))
    monkeypatch.setattr(tg.FaceEnhancer, "detect_landmarks",
                        lambda self, frame, **kw: face_landmarks(frame))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    directory = tmp_path_factory.mktemp("faces")
    gfp, det = write_face_checkpoints(directory)
    rrdb = directory / "RealESRGAN.pth"
    torch.save({"params_ema": seeded_rrdbnet(num_feat=64, num_block=1, seed=3).state_dict()},
               rrdb)
    return gfp, det, str(rrdb)


@pytest.fixture(scope="module")
def enhancers(checkpoints):
    gfp, det, _ = checkpoints
    return (jg.FaceEnhancer(gfp, detector_path=det, **FACE_KW),
            tg.FaceEnhancer(gfp, detector_path=det, noise=JaxFaceNoise(), device="cpu",
                            **FACE_KW))


def _frames(n, h, w, seed):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([120 + 80 * np.sin(xx / 6.0), 70 + 2.0 * yy,
                     130 + 70 * np.cos((xx + yy) / 9.0)], -1)
    return np.clip(base[None] + rs.randn(n, h, w, 3) * 8, 0, 255).astype(np.uint8)


def _assert_u8_close(got, want, share=0.01):
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= share, (diff.max(), (diff > 0).mean())


def test_restore_aligned_matches_jax(enhancers):
    jfe, tfe = enhancers
    crop = _frames(1, SIZE, SIZE, 1)[0]
    want = jfe.restore_aligned(crop)
    got = tfe.restore_aligned(torch.from_numpy(crop))
    assert got.dtype == torch.uint8 and got.shape == (SIZE, SIZE, 3)
    assert np.abs(want.astype(int) - crop.astype(int)).mean() > 5  # GFPGAN moved the crop
    _assert_u8_close(got.numpy(), want)


@pytest.mark.parametrize("upscale,background", [(1.0, False), (2.0, False), (2.0, True),
                                                (4.0, True)])
def test_enhance_matches_jax(enhancers, given_landmarks, upscale, background):
    """Two faces pasted into the frame itself (1x), into its Lanczos4 resize
    (2x) and into a given background (2x, 4x)."""
    jfe, tfe = enhancers
    frame = _frames(1, 40, 48, 2)[0]
    bg = _frames(1, int(40 * upscale), int(48 * upscale), 3)[0] if background else None
    want = jfe.enhance(frame, background=bg, upscale=upscale)
    got = tfe.enhance(torch.from_numpy(frame),
                      background=None if bg is None else torch.from_numpy(bg), upscale=upscale)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    if bg is None:
        bg = frame if upscale == 1.0 else cv2.resize(
            frame, (int(48 * upscale), int(40 * upscale)), interpolation=cv2.INTER_LANCZOS4)
    assert (want != bg).mean() > 0.05  # the faces were pasted
    _assert_u8_close(got.numpy(), want)


ROWS = np.array([  # detect_faces rows: box, score, 5 landmarks
    [30, 30, 70, 80, 0.99, 40, 50, 60, 50, 50, 60, 42, 70, 58, 70],
    [100, 10, 104, 14, 0.98, 101, 12, 103, 12, 102, 13, 101, 14, 103, 14],  # eyes 2 px apart
    [5, 60, 45, 110, 0.985, 15, 80, 35, 80, 25, 90, 17, 100, 33, 100],
], np.float32)


@pytest.mark.parametrize("only_center_face", [False, True])
def test_detect_landmarks_filters_match_jax(enhancers, monkeypatch, only_center_face):
    jfe, tfe = enhancers
    monkeypatch.setattr(jfe._retina, "detect_faces", lambda frame, **kw: ROWS)
    monkeypatch.setattr(tfe.detector, "detect_faces", lambda frame, **kw: ROWS)
    frame = np.zeros((120, 110, 3), np.uint8)
    want = jfe.detect_landmarks(frame, only_center_face=only_center_face)
    before = tfe.faces_found
    got = tfe.detect_landmarks(torch.from_numpy(frame), only_center_face=only_center_face)
    assert len(got) == len(want) == (1 if only_center_face else 2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert tfe.faces_found - before == len(want)


def face_upscaler_pair(checkpoints, scale: float, upscale_first: bool):
    """(JAX Upscaler, port Upscaler) with the face enhancer, fp32 on the CPU,
    on the same files."""
    gfp, det, rrdb = checkpoints
    common = dict(use_face_enhancer=True, upscale_first=upscale_first, model_path=rrdb,
                  face_enhancer_model_path=gfp, face_detector_model_path=det, num_block=1)
    jup = JaxUpscaler(scale, face_enhancer_kwargs=FACE_KW, **common)
    tup = Upscaler(scale, dtype=torch.float32, device="cpu",
                   face_enhancer_kwargs={**FACE_KW, "noise": JaxFaceNoise()}, **common)
    return jup, tup


@pytest.mark.parametrize("scale", [2.0, 4.0])
@pytest.mark.parametrize("upscale_first", [True, False])
def test_upscaler_with_faces_matches_jax(checkpoints, given_landmarks, scale, upscale_first):
    """`process_batch` of both packages, and the port's device entry (what
    the loop calls), on two 24x20 frames."""
    jup, tup = face_upscaler_pair(checkpoints, scale, upscale_first)
    assert tup.face_enhancer is not None and tup.upscale_first == upscale_first
    frames = _frames(2, 24, 20, 4)
    want = jup.process_batch(frames)
    got = tup.process_batch(frames)
    assert got.shape == want.shape == (2, int(24 * scale), int(20 * scale), 3)
    np.testing.assert_array_equal(tup.upscale_batch_device(torch.from_numpy(frames)).numpy(), got)
    assert not np.array_equal(want, jup.upscale_batch(frames))  # faces were restored
    _assert_u8_close(got, want)


def test_missing_gfpgan_file_raises(checkpoints, tmp_path):
    """Fault (i): the JAX Upscaler swallows a missing GFPGAN file and
    upscales only; the port raises."""
    gfp, det, rrdb = checkpoints
    kw = dict(use_face_enhancer=True, model_path=rrdb, num_block=1,
              face_enhancer_model_path=str(tmp_path / "absent.pth"), face_detector_model_path=det)
    assert JaxUpscaler(4.0, **kw).face_enhancer is None
    with pytest.raises(FileNotFoundError, match="GFPGAN"):
        Upscaler(4.0, dtype=torch.float32, device="cpu", **kw)


def test_missing_retinaface_file_raises(checkpoints, tmp_path):
    """Fault (j): without the RetinaFace file the JAX enhancer falls back to
    OpenCV's Haar cascade (or to no detector); the port raises."""
    gfp, _, _ = checkpoints
    absent = str(tmp_path / "absent.pth")
    assert jg.FaceEnhancer(gfp, detector_path=absent, **FACE_KW).detector_kind in ("haar", "none")
    with pytest.raises(FileNotFoundError, match="RetinaFace"):
        tg.FaceEnhancer(gfp, detector_path=absent, device="cpu", **FACE_KW)
