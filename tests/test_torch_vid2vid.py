"""The port's vid2vid loop against the JAX package's on the CPU.

Both loops are fed the same deterministic stub pipeline (a window's frames
are a numpy function of its input frames, the previous outputs and the
epoch), so any difference comes from the loop and the stitch: frame reads,
overlap bookkeeping, color match, blend, emit order, checkpoint and resume.
Gate: summaries, progress reports and the stub's calls equal; sink frames
within the uint8 color match's gate (`assert_frames_close`). Then one run of the tiny real pipelines (the same
weights through `weights/from_jax.py`, the same JAX noise) and the
configuration checks: every sample YAML's `extras` equal to the JAX
package's, and NotImplementedError for each setting the port lacks."""

import dataclasses
import glob

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
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from scripts.vid2vid import vid2vid as jax_vid2vid
from test_torch_common import JaxDraws, clip_pair, unet_pair, vae_pair

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


def _run_one(cfg, loop, media, frames, max_windows=None, should_stop=None, sink=True):
    stub = StubPipeline(cfg.frame_count)
    out_sink = media.ArrayFrameSink() if sink else None
    progress = []
    summary = loop(
        config=cfg, pipeline=stub,
        frame_source=None if frames is None else media.ArrayFrameSource(frames),
        frame_sink=out_sink, max_windows=max_windows,
        progress=progress.append,
        should_stop=None if should_stop is None else should_stop(progress),
    )
    return summary, (out_sink.frames if sink else None), progress, stub.calls


def _pair(tmp_path, frames, run_kw=None, **cfg_kw):
    """The same run through both loops: returns (jax result, port result)."""
    out = []
    for name, cfg_cls, loop, media in (("jax", JaxRunConfig, jax_vid2vid, jmedia),
                                       ("torch", RunConfig, tv2v.vid2vid, tmedia)):
        cfg = cfg_cls(**{**BASE, "output_video_dir": str(tmp_path / name), **cfg_kw})
        out.append(_run_one(cfg, loop, media, frames, **(run_kw or {})))
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


def test_tiny_real_pipeline_matches_jax(tmp_path):
    """The port's facade and loop against the JAX ones on the same tiny
    models and JAX noise: 8 frames, 3 windows (4 frames, overlap 2), LCM,
    fp32. Gate: the windows agree within the facade test's 1 LSB, and the
    stitch's color match then applies `assert_frames_close`."""
    cfg_kw = dict(width=SIZE, height=SIZE, frame_count=4, overlap_length=2, use_lcm=True,
                  steps=2, strength=0.9, overlap_strength=0.85, lcm_origin_steps=8,
                  guidance_scale=7.5, dtype="float32", prompt="a (red fox)+", n_prompt="blurry",
                  seed=5, ffmpeg_path="ffmpeg-absent-here")
    junet, uparams, tunet = unet_pair(seed=41)
    jvae, vparams, tvae = vae_pair(seed=42)
    jclip, cparams, tclip = clip_pair(seed=43)
    jcfg = JaxRunConfig(**cfg_kw, output_video_dir=str(tmp_path / "jax"))
    jpipe = jfacade.ControlAnimatePipeline(
        jcfg, models=jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae,
                                          vae_params=vparams),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams))
    tcfg = RunConfig(**cfg_kw, output_video_dir=str(tmp_path / "torch"))
    tpipe = tfacade.ControlAnimatePipeline(
        tcfg, models=tengine.EngineModels(unet=tunet, vae=tvae),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")

    class WithJaxNoise:
        device = tpipe.device

        def animate(self, *args, seed, **kw):
            return tpipe.animate(*args, seed=seed, noise=JaxDraws(jax.random.PRNGKey(seed)), **kw)

    frames = _video(6, 8)
    js, ts = jmedia.ArrayFrameSink(), tmedia.ArrayFrameSink()
    j = jax_vid2vid(config=jcfg, pipeline=jpipe, frame_source=jmedia.ArrayFrameSource(frames),
                    frame_sink=js)
    t = tv2v.vid2vid(config=tcfg, pipeline=WithJaxNoise(),
                     frame_source=tmedia.ArrayFrameSource(frames), frame_sink=ts)
    assert t["windows"] == j["windows"] == 3 and t["frames_written"] == j["frames_written"] == 8
    for a, b in zip(ts.frames, js.frames):
        assert_frames_close(a, b)


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


def test_unknown_keys_land_in_extras():
    cfg = RunConfig.from_dict({"width": "320", "use_pallas_conv": "1", "no_such_key": 3})
    assert cfg.width == 320 and cfg.use_pallas_conv is True and cfg.extras == {"no_such_key": 3}


UNPORTED = {
    "upscale": 2.0, "use_face_enhancer": True, "parallel_segments": 4, "mesh_shape": (4, 2),
    "use_ipadapter": True, "do_initial_generation": True,
    "controlnets": ("lllyasviel/sd-controlnet-canny",), "loop_back_frames": True,
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


def test_textual_inversion_raises_only_for_a_disk_build():
    cfg = RunConfig()
    assert cfg.textual_inversion_paths  # the default is not empty
    require_ported(cfg)
    with pytest.raises(NotImplementedError, match="textual_inversion_paths"):
        require_ported(cfg, disk_build=True)
    require_ported(cfg.replace(textual_inversion_paths=()), disk_build=True)


def test_loop_rejects_an_upscaler(tmp_path):
    with pytest.raises(NotImplementedError, match="upscal"):
        tv2v.vid2vid(config=RunConfig(**{**BASE, "output_video_dir": str(tmp_path)}),
                     pipeline=StubPipeline(16), frame_sink=tmedia.ArrayFrameSink(),
                     upscaler=object())
