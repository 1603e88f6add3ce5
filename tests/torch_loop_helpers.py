"""Helpers shared by the vid2vid loop tests (`tests/test_torch_vid2vid*.py`)
and the segment and IP-Adapter tests: a seeded synthetic video, the stub
pipeline both loops are fed, one run through both loops, and the frame gate."""

import jax.numpy as jnp
import numpy as np
import torch

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.io import media as jmedia
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from scripts.vid2vid import vid2vid as jax_vid2vid

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
