"""The port's vid2vid loop against the JAX package's on the CPU.

Both loops are fed the same deterministic stub pipeline (a window's frames
are a numpy function of its input frames, the previous outputs and the
epoch), so any difference comes from the loop and the stitch: frame reads,
overlap bookkeeping, color match, blend, emit order, checkpoint and resume.
Gate: summaries, progress reports and the stub's calls equal; sink frames
within the uint8 color match's gate (`assert_frames_close`). Then the
configuration checks: every sample YAML's `extras` equal to the JAX
package's, and NotImplementedError for each setting the port lacks. The
upscaled and face-enhanced streams are in `test_torch_vid2vid_upscale.py`,
the loops of the tiny real pipelines in `test_torch_vid2vid_models.py`."""

import dataclasses
import glob
import json

import numpy as np
import pytest

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from test_torch_common import LCM_MOTION, clip_pair, unet_pair, vae_pair
from torch_loop_helpers import (BASE, StubPipeline, _assert_same, _pair, _run_one, _video,
                                assert_frames_close)


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


UNPORTED = {"mesh_shape": (4, 2), "token_merge_ratio": 0.5, "encoder_reuse_every": 2}


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


def test_temporal_band_runs_in_the_loop_and_the_facade(tmp_path):
    """`temporal_band` is ported: the loop runs with it, and the facade
    takes an injected UNet built with that band (one built with another
    raises: tests/test_torch_attention_variants.py)."""
    cfg = RunConfig(**{**BASE, "output_video_dir": str(tmp_path), "temporal_band": 4})
    require_ported(cfg)
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg, pipeline=StubPipeline(16), frame_source=tmedia.ArrayFrameSource(
        _video(3, 16)), frame_sink=sink)
    assert len(sink.frames) == 16
    _, _, tunet = unet_pair(motion={**LCM_MOTION, "attention_band": 4})
    _, _, tvae = vae_pair()
    _, _, tclip = clip_pair()
    pipe = tfacade.ControlAnimatePipeline(
        cfg.replace(use_lcm=True), models=tengine.EngineModels(unet=tunet, vae=tvae),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")
    assert pipe.models.unet.config.motion.attention_band == 4


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
