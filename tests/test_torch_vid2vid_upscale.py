"""The port's vid2vid loop against the JAX package's on the CPU, the emit
through each package's RealESRGAN `Upscaler` on the same weights, with and
without the face enhancer. Both loops are fed the same stub pipeline
(`torch_loop_helpers.StubPipeline`); gates as in `test_torch_vid2vid.py`."""

import numpy as np
import pytest
import torch

from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.upscaler import Upscaler
from test_torch_common import seeded_rrdbnet, upscaler_pair
from torch_loop_helpers import BASE, SIZE, StubPipeline, _assert_same, _pair, _video


# -- the upscaler on the emit ----------------------------------------------------
def _upscalers(tmp_path, scale):
    """The JAX and the port Upscaler on the same seeded 16-feature weights."""
    return upscaler_pair(tmp_path / "realesrgan.pth", scale=scale, seed=11)


@pytest.mark.parametrize("scale", [4.0, 2.0])
def test_upscaled_stream_matches_jax(tmp_path, scale):
    """24 frames: one whole window, one overlap-8 window, then the tail
    flush (the last 8 frames), every emit upscaled. At 4 the JAX loop
    upscales on the device; at 2 it takes its host path (the x4 network,
    then cv2's Lanczos4) and the port resizes on the device."""
    j, t = _pair(tmp_path, _video(9, 24), upscalers=_upscalers(tmp_path, scale), upscale=scale)
    _assert_same(j, t)
    side = int(SIZE * scale)
    assert len(t[1]) == 24 and all(f.shape == (side, side, 3) for f in t[1])
    assert "upscale" in t[0]["timers"]


def test_upscaled_tail_flush_matches_jax(tmp_path):
    """An interrupted run without checkpoints flushes its tail overlap
    through the upscaler too: 8 emitted + 8 flushed frames, all 256x256."""
    j, t = _pair(tmp_path, _video(10, 40), run_kw=dict(max_windows=1),
                 upscalers=_upscalers(tmp_path, 4.0), upscale=4.0, checkpoint_interval=0)
    _assert_same(j, t)
    assert t[0]["frames_written"] == 16 and all(f.shape == (256, 256, 3) for f in t[1])


def test_yuv420p_sink_gets_upscaled_i420(tmp_path):
    """A yuv420p sink at upscale 4: each emit is upscaled and packed to I420
    on the device before its readback, the tail flush too, in both loops."""
    j, t = _pair(tmp_path, _video(12, 24), run_kw=dict(pix_fmt="yuv420p"),
                 upscalers=_upscalers(tmp_path, 4.0), upscale=4.0)
    _assert_same(j, t)
    assert len(t[1]) == 24 and all(f.shape == (256 * 256 * 3 // 2,) for f in t[1])


def test_resume_with_upscale_matches_jax(tmp_path):
    """Checkpoint and resume are unchanged by the upscaler: the state holds
    window-size frames, and the two segments together upscale all 40."""
    frames = _video(13, 40)
    ups = _upscalers(tmp_path, 4.0)
    first = _pair(tmp_path, frames, run_kw=dict(max_windows=2), upscalers=ups, upscale=4.0)
    _assert_same(*first)
    assert first[1][0]["frames_written"] == 16
    z = np.load(tmp_path / "torch" / tv2v.STATE_FILE)
    assert z["overlap_frames"].shape == (8, SIZE, SIZE, 3)
    second = _pair(tmp_path, frames, upscalers=ups, upscale=4.0, resume=True)
    _assert_same(*second)
    assert len(first[1][1]) + len(second[1][1]) == 40
    assert all(f.shape == (256, 256, 3) for f in first[1][1] + second[1][1])


@pytest.mark.parametrize("scale,pix_fmt", [(1.0, "yuv420p"), (4.0, "yuv420p"), (2.0, "rgb24")])
def test_ffmpeg_sink_opens_at_the_upscaled_size(tmp_path, monkeypatch, scale, pix_fmt):
    """Where ffmpeg exists the loop opens its sink at int(W * scale) x
    int(H * scale), yuv420p only at scale 1 or 4 (the JAX loop's rule), and
    writes frames of that size in that format."""
    opened = []

    class RecordingSink(tmedia.ArrayFrameSink):
        def __init__(self, path, width, height, fps, crf=23, ffmpeg_path="ffmpeg",
                     pix_fmt="rgb24"):
            super().__init__()
            self.pix_fmt = pix_fmt
            opened.append((width, height, pix_fmt, self))

        def close(self):
            pass

    monkeypatch.setattr(tmedia, "ffmpeg_available", lambda path="ffmpeg": True)
    monkeypatch.setattr(tmedia, "FFMPEGFrameSink", RecordingSink)
    monkeypatch.setattr(tmedia, "video_to_high_fps", lambda *a, **k: None)
    up = None if scale == 1.0 else Upscaler(scale, model=seeded_rrdbnet(), dtype=torch.float32,
                                            device="cpu")
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path), "upscale": scale,
                       "frame_count": 8, "overlap_length": 0})
    tv2v.vid2vid(config=cfg, pipeline=StubPipeline(8),
                 frame_source=tmedia.ArrayFrameSource(_video(14, 8)), upscaler=up)
    (width, height, fmt, sink), = opened
    side = int(SIZE * scale)
    assert (width, height, fmt) == (side, side, pix_fmt)
    size = side * side * 3 // 2 if fmt == "yuv420p" else side * side * 3
    assert len(sink.frames) == 8 and all(f.size == size for f in sink.frames)


def test_loop_builds_the_upscaler_from_its_weights_file(tmp_path):
    """Without an `upscaler` the loop reads `upscaler_model_path` (the
    six-block anime_6B geometry) in the run dtype; a missing file raises
    FileNotFoundError (the JAX loop drops the upscaler and writes 64x64
    frames into a sink opened at 256x256)."""
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path / "out"), "upscale": 4.0,
                       "frame_count": 2, "overlap_length": 0, "dtype": "float32",
                       "upscaler_model_path": str(tmp_path / "absent.pth")})
    frames = _video(15, 2)
    with pytest.raises(FileNotFoundError, match="RealESRGAN"):
        tv2v.vid2vid(config=cfg, pipeline=StubPipeline(2),
                     frame_source=tmedia.ArrayFrameSource(frames), frame_sink=tmedia.ArrayFrameSink())
    net = seeded_rrdbnet(num_feat=64, num_block=6, seed=16)
    torch.save({"params_ema": net.state_dict()}, tmp_path / "x4.pth")
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg.replace(upscaler_model_path=str(tmp_path / "x4.pth")),
                 pipeline=StubPipeline(2), frame_source=tmedia.ArrayFrameSource(frames),
                 frame_sink=sink)
    window = StubPipeline(2)._window(frames, None, 0, cfg.strength, cfg.seed, 0)
    want = Upscaler(4.0, model=net, dtype=torch.float32, device="cpu").upscale_batch(window)
    np.testing.assert_array_equal(np.stack(sink.frames), want)


def test_face_enhanced_stream_matches_jax(tmp_path, monkeypatch):
    """`upscale: 2`, the face enhancer, `upscale_first: 1`, as
    SampleConfigLCM.yaml sets them: 24 frames through both loops, each with
    its package's Upscaler on the same RealESRGAN, GFPGAN and RetinaFace
    files (tests/test_torch_face_enhance.py, which also runs the other
    order), two faces given a frame."""
    from test_torch_face_enhance import face_landmarks, face_upscaler_pair, write_face_checkpoints

    from controlanimate_tpu.models import gfpgan as jg
    from controlanimate_tpu_torch.models import gfpgan as tg

    for cls in (jg.FaceEnhancer, tg.FaceEnhancer):
        monkeypatch.setattr(cls, "detect_landmarks", lambda self, frame, **kw: face_landmarks(frame))
    rrdb = tmp_path / "realesrgan.pth"
    torch.save({"params_ema": seeded_rrdbnet(num_feat=64, num_block=1, seed=17).state_dict()}, rrdb)
    ups = face_upscaler_pair((*write_face_checkpoints(tmp_path), str(rrdb)), 2.0, True)
    j, t = _pair(tmp_path, _video(18, 24), upscalers=ups, upscale=2.0, use_face_enhancer=True,
                 upscale_first=True)
    _assert_same(j, t)
    assert len(t[1]) == 24 and all(f.shape == (128, 128, 3) for f in t[1])
    assert "faces" in t[0]  # the detector's counts (its search is replaced here)


def test_loop_builds_the_face_enhancer_from_its_files(tmp_path):
    """With `use_face_enhancer` the loop's Upscaler reads
    `face_enhancer_model_path` and `face_detector_model_path`: a missing
    file raises FileNotFoundError (the JAX loop upscales only, or falls
    back to a Haar cascade)."""
    from test_retinaface import synth_retinaface_sd

    torch.save({"params_ema": seeded_rrdbnet(num_feat=64, num_block=6, seed=16).state_dict()},
               tmp_path / "x4.pth")
    torch.save({k: torch.from_numpy(v) for k, v in synth_retinaface_sd().items()},
               tmp_path / "retinaface.pth")
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path / "out"), "upscale": 2.0,
                       "frame_count": 2, "overlap_length": 0, "dtype": "float32",
                       "upscaler_model_path": str(tmp_path / "x4.pth"), "use_face_enhancer": True})
    require_ported(cfg)
    absent = str(tmp_path / "absent.pth")
    for paths, what in (({"face_detector_model_path": absent}, "RetinaFace"),
                        ({"face_detector_model_path": str(tmp_path / "retinaface.pth"),
                          "face_enhancer_model_path": absent}, "GFPGAN")):
        with pytest.raises(FileNotFoundError, match=what):
            tv2v.vid2vid(config=cfg.replace(**paths), pipeline=StubPipeline(2),
                         frame_source=tmedia.ArrayFrameSource(_video(19, 2)),
                         frame_sink=tmedia.ArrayFrameSink())
