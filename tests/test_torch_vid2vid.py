"""The port's vid2vid loop against the JAX package's on the CPU.

Both loops are fed the same deterministic stub pipeline (a window's frames
are a numpy function of its input frames, the previous outputs and the
epoch), so any difference comes from the loop and the stitch: frame reads,
overlap bookkeeping, color match, blend, emit order, checkpoint and resume,
and with `upscale` the emit through each package's RealESRGAN `Upscaler` on
the same weights. Gate: summaries, progress reports and the stub's calls
equal; sink frames within the uint8 color match's gate
(`assert_frames_close`). Then one run of the tiny real pipelines (the same
weights through `weights/from_jax.py`, the same JAX noise) and the
configuration checks: every sample YAML's `extras` equal to the JAX
package's, and NotImplementedError for each setting the port lacks."""

import dataclasses
import glob
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.io import media as jmedia
from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.models.upscaler import Upscaler
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from scripts.vid2vid import vid2vid as jax_vid2vid
from test_torch_common import (JaxDraws, clip_pair, seeded_rrdbnet, unet_pair, upscaler_pair,
                               vae_pair)
from test_torch_controlnet import LCM_CN, controlnet_pair

SIZE = 64


def _video(seed, n):
    """n smooth 64x64 frames with motion and noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
    frames = []
    for i in range(n):
        base = np.stack([128 + 90 * np.sin((xx + 3 * i) / 9.0), 60 + 1.5 * yy + i,
                         128 + 80 * np.cos((xx + yy - 2 * i) / 13.0)], axis=-1)
        frames.append(np.clip(base + rng.randn(SIZE, SIZE, 3) * 6, 0, 255))
    return np.stack(frames).astype(np.uint8)


class StubPipeline:
    """A window as a numpy function of its inputs: a tone shift per epoch
    and frame, the overlap slots mixed with the previous outputs. txt2vid
    windows start from a seeded pattern. `animate` returns a torch tensor
    (the port's contract), `animate_async` a jax array (the JAX loop's)."""

    device = "cpu"

    def __init__(self, frame_count: int):
        self.frame_count = frame_count
        self.calls = []

    def _window(self, input_frames, last_output_frames, overlaps, strength, seed, epoch):
        self.calls.append((epoch, overlaps, round(float(strength), 4)))
        if input_frames is None:
            x = _video(seed + epoch, self.frame_count).astype(np.float32)
        else:
            x = np.asarray(input_frames).astype(np.float32)
        idx = np.arange(x.shape[0], dtype=np.float32)[:, None, None, None]
        out = x * 0.8 + 12.0 * (epoch % 3) + 2.0 * idx
        if last_output_frames is not None and overlaps:
            last = np.asarray(last_output_frames).astype(np.float32)
            out[:overlaps] = 0.5 * out[:overlaps] + 0.5 * last[-overlaps:]
        return np.clip(out + 0.5, 0, 255).astype(np.uint8)

    def animate(self, input_frames, last_output_frames, *, overlaps=0, strength=None, seed=0,
                epoch=0):
        return torch.from_numpy(self._window(input_frames, last_output_frames, overlaps,
                                             strength, seed, epoch))

    def animate_async(self, input_frames, last_output_frames, *, overlaps=0, strength=None,
                      seed=0, epoch=0, **_):
        return jnp.asarray(self._window(input_frames, last_output_frames, overlaps, strength,
                                        seed, epoch))


BASE = dict(width=SIZE, height=SIZE, frame_count=16, overlap_length=8, seed=7, strength=0.9,
            overlap_strength=0.8, ffmpeg_path="ffmpeg-absent-here")


def _run_one(cfg, loop, media, frames, max_windows=None, should_stop=None, sink=True,
             upscaler=None, pix_fmt="rgb24"):
    stub = StubPipeline(cfg.frame_count)
    out_sink = None
    if sink:
        out_sink = media.ArrayFrameSink()
        out_sink.pix_fmt = pix_fmt  # what an ffmpeg sink takes, read by both loops
    progress = []
    summary = loop(
        config=cfg, pipeline=stub,
        frame_source=None if frames is None else media.ArrayFrameSource(frames),
        frame_sink=out_sink, upscaler=upscaler, max_windows=max_windows,
        progress=progress.append,
        should_stop=None if should_stop is None else should_stop(progress),
    )
    return summary, (out_sink.frames if sink else None), progress, stub.calls


def _pair(tmp_path, frames, run_kw=None, upscalers=(None, None), **cfg_kw):
    """The same run through both loops: returns (jax result, port result)."""
    out = []
    for (name, cfg_cls, loop, media), up in zip(
            (("jax", JaxRunConfig, jax_vid2vid, jmedia),
             ("torch", RunConfig, tv2v.vid2vid, tmedia)), upscalers):
        cfg = cfg_cls(**{**BASE, "output_video_dir": str(tmp_path / name), **cfg_kw})
        out.append(_run_one(cfg, loop, media, frames, upscaler=up, **(run_kw or {})))
    return out


def _assert_same(j, t):
    (js, jf, jp, jc), (ts, tf, tp, tc) = j, t
    for key in ("frames_written", "windows", "canceled", "seed"):
        assert ts[key] == js[key], key
    assert tp == jp and tc == jc
    if jf is not None:
        assert len(tf) == len(jf)
        for a, b in zip(tf, jf):
            assert a.shape == b.shape and a.dtype == np.uint8
            assert_frames_close(a, b)


def assert_frames_close(a, b):
    """The uint8 color match's gate, loosened for a chain of windows. From
    the second window on every window is color-matched to an anchor, and a
    value that rounds to the other level in the match's fp32 MKL stage can
    move by a few levels through its histogram stage
    (tests/test_torch_stitch.py `test_match_colors_u8_matches_jax`); the
    moved pixels then feed the next window's anchor and blend. With the real
    pipelines the windows themselves also differ by 1 LSB before the match.
    Gate per frame: at most 5% of values differ, on average by at most 0.05
    LSB, none by more than 8 (seen: at most 2.0% of values, 0.027 LSB on
    average, 5 LSB at most). A loop fault (a frame out of order, a wrong
    blend weight or anchor) moves most values of a frame."""
    diff = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    assert (diff > 0).mean() <= 5e-2 and diff.mean() <= 5e-2 and diff.max() <= 8, (
        diff.max(), (diff > 0).mean(), diff.mean())


@pytest.mark.parametrize("overlap_host_work", [True, False])
def test_overlap8_stream_matches_jax(tmp_path, overlap_host_work):
    """40 frames: one whole window and three overlap-8 windows."""
    j, t = _pair(tmp_path, _video(0, 40), overlap_host_work=overlap_host_work)
    _assert_same(j, t)
    assert t[0]["windows"] == 4 and t[0]["frames_written"] == 40
    assert [c["windows"] for c in t[2]] == [1, 2, 3, 4, 4]


def test_txt2vid_total_frames_matches_jax(tmp_path):
    j, t = _pair(tmp_path, None, frame_count=8, overlap_length=4, total_frames=20)
    _assert_same(j, t)
    assert t[0]["frames_written"] == 20


def test_resume_mid_video_matches_jax(tmp_path):
    frames = _video(1, 40)
    first = _pair(tmp_path, frames, run_kw=dict(max_windows=2))
    _assert_same(*first)
    assert first[1][0]["frames_written"] == 16  # 8 + 8 novel, the tail held back
    assert (tmp_path / "torch" / tv2v.STATE_FILE).exists()
    z_j = np.load(tmp_path / "jax" / tv2v.STATE_FILE)
    z_t = np.load(tmp_path / "torch" / tv2v.STATE_FILE)
    assert set(z_j.files) == set(z_t.files)
    for k in z_j.files:
        assert z_t[k].shape == z_j[k].shape and np.abs(
            z_t[k].astype(np.int64) - z_j[k].astype(np.int64)).max() <= 4, k
    second = _pair(tmp_path, frames, resume=True)
    _assert_same(*second)
    assert first[1][0]["frames_written"] + len(second[1][1]) == 40
    assert not (tmp_path / "torch" / tv2v.STATE_FILE).exists()


def test_resume_appends_in_directory_sink(tmp_path):
    """Without ffmpeg the sink is numbered PNGs; a resumed run numbers after
    the frames already written."""
    from PIL import Image

    frames = _video(2, 40)
    for resume, mw in ((False, 2), (True, None)):
        j, t = _pair(tmp_path, frames, run_kw=dict(max_windows=mw, sink=False), resume=resume)
        _assert_same(j, t)
    names = sorted(p.name for p in (tmp_path / "torch" / "frames").glob("*.png"))
    assert names == [f"{i:04d}.png" for i in range(1, 41)]
    assert names == sorted(p.name for p in (tmp_path / "jax" / "frames").glob("*.png"))
    for n in names:
        a = np.asarray(Image.open(tmp_path / "torch" / "frames" / n), np.int64)
        b = np.asarray(Image.open(tmp_path / "jax" / "frames" / n), np.int64)
        assert_frames_close(a, b)
    assert t[0]["output"] == str(tmp_path / "torch" / "frames")


def test_directory_sink_writes_every_frame_and_reports_failures(tmp_path):
    """The PNG sink's worker threads: every frame lands, numbered in write
    order, with its pixels (the caller's buffer reused at once); `close`
    raises a failed write."""
    from PIL import Image

    sink = tmedia.DirectoryFrameSink(str(tmp_path / "ok"), start_index=3)
    buf, want = np.empty((24, 40, 3), np.uint8), []
    for i in range(20):
        buf[:] = _video(i, 1)[0, :24, :40]
        want.append(buf.copy())
        sink.write(buf)
    sink.close()
    names = sorted(p.name for p in (tmp_path / "ok").glob("*.png"))
    assert names == [f"{i:04d}.png" for i in range(4, 24)]
    for name, frame in zip(names, want):
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "ok" / name)), frame)
    sink = tmedia.DirectoryFrameSink(str(tmp_path / "gone"))
    (tmp_path / "gone").rmdir()
    sink.write(buf)
    with pytest.raises(FileNotFoundError):
        sink.close()


def test_cooperative_cancel_matches_jax(tmp_path):
    def stop_after_two(progress):
        return lambda: bool(progress and progress[-1]["windows"] >= 2)

    j, t = _pair(tmp_path, _video(3, 40), run_kw=dict(should_stop=stop_after_two))
    _assert_same(j, t)
    assert t[0]["canceled"] is True and t[0]["frames_written"] == 16
    assert (tmp_path / "torch" / tv2v.STATE_FILE).exists()


def test_interrupted_without_checkpointing_flushes_tail(tmp_path):
    j, t = _pair(tmp_path, _video(4, 40), run_kw=dict(max_windows=2), checkpoint_interval=0)
    _assert_same(j, t)
    assert t[0]["frames_written"] == 24 and len(t[1]) == 24
    assert not (tmp_path / "torch" / tv2v.STATE_FILE).exists()


def test_completion_clears_stale_checkpoint(tmp_path):
    frames = _video(5, 40)
    _pair(tmp_path, frames, run_kw=dict(max_windows=2))
    assert (tmp_path / "torch" / tv2v.STATE_FILE).exists()
    j, t = _pair(tmp_path, frames, checkpoint_interval=0)
    _assert_same(j, t)
    assert not (tmp_path / "torch" / tv2v.STATE_FILE).exists()


def test_save_frames_dumps_match_jax(tmp_path):
    """save_frames: numbered output and input PNGs and info.json, as the JAX
    loop writes them (the sink gets RGB frames, no I420)."""
    from PIL import Image

    j, t = _pair(tmp_path, _video(7, 24), save_frames=True)
    _assert_same(j, t)
    for sub in ("vid2vid_frames", "vid2vid_input_frames"):
        names = sorted(q.name for q in (tmp_path / "torch" / sub).glob("*.png"))
        assert names == sorted(q.name for q in (tmp_path / "jax" / sub).glob("*.png"))
        assert len(names) == 16  # the windows' emitted frames; the tail is not dumped
        for n in names:
            a = np.asarray(Image.open(tmp_path / "torch" / sub / n), np.int64)
            b = np.asarray(Image.open(tmp_path / "jax" / sub / n), np.int64)
            assert_frames_close(a, b)
    assert (tmp_path / "torch" / "info.json").exists()


def test_trace_dir_records_a_profiler_trace(tmp_path):
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path / "out"),
                       "trace_dir": str(tmp_path / "trace")})
    summary, *_ = _run_one(cfg, tv2v.vid2vid, tmedia, _video(8, 24))
    assert summary["frames_written"] == 24
    assert list((tmp_path / "trace").glob("trace_*.json"))
    assert {"animate_window", "stitch", "emit"} <= set(summary["timers"])


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


def _tiny_real_loops(tmp_path, frames, controlnet: bool = False, run_jax: bool = True,
                     **cfg_kw):
    """The port's facade and loop and the JAX ones (unless not `run_jax`) on
    the same tiny models and JAX noise (LCM unless `cfg_kw` says otherwise,
    fp32); with `controlnet`, one
    canny ControlNet of the tiny UNet's down path at scale 0.8. Returns
    both summaries and sinks ((None, None) for JAX when it did not run)."""
    cfg_kw = {**dict(width=SIZE, height=SIZE, frame_count=4, overlap_length=2, use_lcm=True,
                     steps=2, strength=0.9, overlap_strength=0.85, lcm_origin_steps=8,
                     guidance_scale=7.5, dtype="float32", prompt="a (red fox)+",
                     n_prompt="blurry", seed=5, ffmpeg_path="ffmpeg-absent-here"), **cfg_kw}
    junet, uparams, tunet = unet_pair(seed=41)
    jvae, vparams, tvae = vae_pair(seed=42)
    jclip, cparams, tclip = clip_pair(seed=43)
    jcn = dict(controlnets=[], controlnet_params=[], cond_scales=[])
    tcn = dict(controlnets=[])
    if controlnet:
        jmodel, params, tmodel = controlnet_pair(LCM_CN, seed=44)
        cfg_kw.update(controlnets=("lllyasviel/sd-controlnet-canny",), cond_scale=(0.8,))
        jcn = dict(controlnets=[jmodel], controlnet_params=[params], cond_scales=[0.8])
        tcn = dict(controlnets=[tmodel])
    jcfg = JaxRunConfig(**cfg_kw, output_video_dir=str(tmp_path / "jax"))
    jpipe = jfacade.ControlAnimatePipeline(
        jcfg, models=jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae,
                                          vae_params=vparams, **jcn),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams))
    tcfg = RunConfig(**cfg_kw, output_video_dir=str(tmp_path / "torch"))
    tpipe = tfacade.ControlAnimatePipeline(
        tcfg, models=tengine.EngineModels(unet=tunet, vae=tvae, **tcn),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")

    class WithJaxNoise:
        device = tpipe.device
        prepare_cond_images = tpipe.prepare_cond_images

        def animate(self, *args, seed, **kw):
            return tpipe.animate(*args, seed=seed, noise=JaxDraws(jax.random.PRNGKey(seed)), **kw)

    js, ts, j = jmedia.ArrayFrameSink(), tmedia.ArrayFrameSink(), None
    if run_jax:
        j = jax_vid2vid(config=jcfg, pipeline=jpipe,
                        frame_source=jmedia.ArrayFrameSource(frames), frame_sink=js)
    t = tv2v.vid2vid(config=tcfg, pipeline=WithJaxNoise(),
                     frame_source=tmedia.ArrayFrameSource(frames), frame_sink=ts)
    return (j, js), (t, ts)


def test_tiny_real_pipeline_matches_jax(tmp_path):
    """The port's facade and loop against the JAX ones on the same tiny
    models and JAX noise: 8 frames, 3 windows (4 frames, overlap 2), LCM,
    fp32. Gate: the windows agree within the facade test's 1 LSB, and the
    stitch's color match then applies `assert_frames_close`."""
    (j, js), (t, ts) = _tiny_real_loops(tmp_path, _video(6, 8))
    assert t["windows"] == j["windows"] == 3 and t["frames_written"] == j["frames_written"] == 8
    for a, b in zip(ts.frames, js.frames):
        assert_frames_close(a, b)


def test_tiny_cfg_loop_matches_jax(tmp_path):
    """The default profile's sampler through both loops: `use_lcm` off,
    EulerDiscreteScheduler at guidance 7.5 with the negative prompt, a whole
    window at strength 1 (3 steps) and an overlap window at
    `overlap_strength` 0.92 (2 steps) that starts from the first window's
    last outputs. Gates as above."""
    (j, js), (t, ts) = _tiny_real_loops(
        tmp_path, _video(8, 6), use_lcm=False, scheduler="EulerDiscreteScheduler", steps=3,
        strength=1.0, overlap_strength=0.92)
    assert t["windows"] == j["windows"] == 2 and t["frames_written"] == j["frames_written"] == 6
    for a, b in zip(ts.frames, js.frames):
        assert_frames_close(a, b)


@pytest.mark.parametrize("loop_back", [False, True])
def test_tiny_controlnet_loop_matches_jax(tmp_path, loop_back):
    """The same loops with a canny ControlNet, with and without
    `loop_back_frames` (the previous window's generated overlap frames
    annotated and encoded in the overlap slots), within the same gates; the
    loop times the annotation, and loop-back changes the frames."""
    (j, js), (t, ts) = _tiny_real_loops(tmp_path, _video(6, 8), controlnet=True,
                                        loop_back_frames=loop_back)
    assert t["windows"] == j["windows"] == 3 and t["frames_written"] == j["frames_written"] == 8
    assert t["timers"]["annotate"]["count"] == 3
    for a, b in zip(ts.frames, js.frames):
        assert_frames_close(a, b)
    if loop_back:
        (_, _), (_, plain) = _tiny_real_loops(tmp_path / "plain", _video(6, 8), controlnet=True,
                                              run_jax=False)
        assert any(not np.array_equal(a, b) for a, b in zip(ts.frames, plain.frames))


def test_controlnet_dumps_match_jax(tmp_path):
    """`save_frames` with a ControlNet: each window's condition maps land as
    PNGs under controlnet_outputs_<time>/<net>/<epoch>_<frame>.png, the
    same files with the same pixels as the JAX facade's."""
    from PIL import Image

    _tiny_real_loops(tmp_path, _video(7, 6), controlnet=True, save_frames=True)
    dumps = {}
    for name in ("jax", "torch"):
        (root,) = (tmp_path / name).glob("controlnet_outputs_*")
        dumps[name] = {p.name: np.asarray(Image.open(p))
                       for p in sorted((root / "sd-controlnet-canny").glob("*.png"))}
    assert list(dumps["torch"]) == list(dumps["jax"]) == [
        f"{e:04d}_{i:02d}.png" for e in range(2) for i in range(4)]
    for k, v in dumps["jax"].items():
        np.testing.assert_array_equal(dumps["torch"][k], v)


# -- configuration -------------------------------------------------------------
@pytest.mark.parametrize("path", sorted(glob.glob("configs/prompts/*.yaml")))
def test_yaml_extras_match_jax(path):
    """Every key the JAX package knows is a field of the port's RunConfig,
    read with the same coercions; only unknown keys land in extras."""
    mine, theirs = RunConfig.from_yaml(path), JaxRunConfig.from_yaml(path)
    assert mine.extras == theirs.extras
    assert {f.name for f in dataclasses.fields(RunConfig)} == {
        f.name for f in dataclasses.fields(JaxRunConfig)}
    for f in dataclasses.fields(RunConfig):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name


def test_probe_video_asks_ffprobe(tmp_path):
    """Videos are probed with the ffprobe beside `ffmpeg_path` (the port
    does not import OpenCV, which the JAX package probes with)."""
    fake = tmp_path / "ffprobe"
    fake.write_text("#!/bin/sh\necho '{\"streams\": [{\"width\": 640, \"height\": 360, "
                    "\"r_frame_rate\": \"30000/1001\", \"nb_frames\": \"90\"}]}'\n")
    fake.chmod(0o755)
    fps, n, w, h = tmedia.probe_video("clip.mp4", str(tmp_path / "ffmpeg"))
    assert (n, w, h) == (90, 640, 360) and abs(fps - 30000 / 1001) < 1e-9
    with pytest.raises(RuntimeError, match="ffprobe"):
        tmedia.probe_video("clip.mp4", str(tmp_path / "absent" / "ffmpeg"))


def test_unknown_keys_land_in_extras():
    cfg = RunConfig.from_dict({"width": "320", "use_pallas_conv": "1", "no_such_key": 3})
    assert cfg.width == 320 and cfg.use_pallas_conv is True and cfg.extras == {"no_such_key": 3}


UNPORTED = {
    "parallel_segments": 4, "mesh_shape": (4, 2),
    "temporal_band": 4, "token_merge_ratio": 0.5, "encoder_reuse_every": 2,
}


@pytest.mark.parametrize("key", sorted(UNPORTED))
def test_unported_settings_raise(tmp_path, key):
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path), key: UNPORTED[key]})
    with pytest.raises(NotImplementedError, match=key):
        tv2v.vid2vid(config=cfg, pipeline=StubPipeline(16), frame_sink=tmedia.ArrayFrameSink())
    _, _, tunet = unet_pair()
    _, _, tvae = vae_pair()
    _, _, tclip = clip_pair()
    with pytest.raises(NotImplementedError, match=key):
        tfacade.ControlAnimatePipeline(
            cfg.replace(use_lcm=True), models=tengine.EngineModels(unet=tunet, vae=tvae),
            text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")


def test_textual_inversion_raises_only_for_a_disk_build(tmp_path):
    """The default TI path names a file that is not in the repo: a disk build
    raises FileNotFoundError for it, a run on an injected pipeline never reads
    it."""
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path)})
    assert cfg.textual_inversion_paths  # the default is not empty
    require_ported(cfg)
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg, pipeline=StubPipeline(16), frame_sink=sink, max_windows=1)
    assert sink.frames
    tokenizer = tmp_path / "snapshot" / "tokenizer"
    tokenizer.mkdir(parents=True)
    (tokenizer / "vocab.json").write_text(json.dumps(CLIPTokenizer.tiny().vocab))
    (tokenizer / "merges.txt").write_text("#version: 0.2\n")
    with pytest.raises(FileNotFoundError, match="easynegative"):
        tv2v.vid2vid(config=cfg.replace(use_lcm=True,
                                        pretrained_lcm_model_path=str(tokenizer.parent)),
                     device="cpu")
