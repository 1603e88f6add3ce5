"""The port's segment-parallel path against the JAX package's on the CPU.

The same tiny models (`weights/from_jax.py`) and the JAX draws (`JaxDraws`)
on both sides, fp32, one torch thread. Held against JAX: the batched stitch
(`stitch_window_batch`), the condition maps of (S, F, H, W, 3) frames (canny
and HED), the batched IP-Adapter anchor embed, `animate(segments=2)` (native
LCM with overlap-latent reuse, a multi-step CFG window, a ControlNet
window), the overlap-latent cache across a change of batch, and the loop
against JAX's `_run_segments` for each of the JAX package's segment tests
(`tests/test_vid2vid_e2e.py`: counts and determinism, cancel, per-segment
parity with the sequential loop, pad and trim, `max_windows`), plus
loop-back, the IP-Adapter's initial double pass and the upscale. Windows
agree within 1 LSB; the frames the loops write within the stitch's color
match gate (`torch_loop_helpers.assert_frames_close`). Where a window's
output feeds the next (loop-back, the double pass) the JAX windows are
held one by one first, then replayed through the port's loop, as
`test_torch_ip_adapter.py` does. Each JAX pipeline is built once for the
file, so its window programs compile once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.io import media as jmedia
from controlanimate_tpu.models.annotators import neural as jax_neural
from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.ops import stitch as jstitch
from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.annotators.edge_nets import HEDAnnotator
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.ops import stitch as tstitch
from controlanimate_tpu_torch.ops.canny import canny
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from scripts.vid2vid import vid2vid as jax_vid2vid
from test_torch_annotators import _seeded_hed
from test_torch_common import (LCM_MOTION, LCM_UNET, JaxDraws, clip_pair, unet_pair,
                               upscaler_pair, vae_pair)
from test_torch_controlnet import LCM_CN, controlnet_pair
from test_torch_ip_adapter import IP_UNET, adapter_pair, no_ipp  # noqa: F401 (a fixture)
from torch_loop_helpers import _video, assert_frames_close

SIZE = 64
BASE = dict(width=SIZE, height=SIZE, frame_count=4, overlap_length=2, use_lcm=True, steps=2,
            strength=0.9, overlap_strength=0.85, lcm_origin_steps=8, guidance_scale=7.5,
            dtype="float32", prompt="a (red fox)+", n_prompt="blurry", seed=5,
            ffmpeg_path="ffmpeg-absent-here", checkpoint_interval=0)
# the pipelines of the file, by name: their settings over BASE
PROFILES = {
    "lcm": {},
    "cfg": dict(use_lcm=False, scheduler="EulerDiscreteScheduler", steps=3, strength=1.0,
                overlap_strength=0.92),
    "controlnet": dict(controlnets=("lllyasviel/sd-controlnet-canny",), cond_scale=(0.8,),
                       loop_back_frames=True),
    "ip": dict(use_ipadapter=True, do_initial_generation=True, ipa_scale=0.65),
}
_PIPES: dict = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny models on one thread (six test workers share the
    machine's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int)).max())


def pipes(name: str):
    """(JAX pipeline, port pipeline) of PROFILES[name] on the same tiny
    models, built once for the file; each test clears the overlap-latent
    caches."""
    if name not in _PIPES:
        kw = {**BASE, **PROFILES[name]}
        # motion modules in the "lcm" UNet alone: the others compile faster
        unet_kw = {**(IP_UNET if name == "ip" else LCM_UNET), "use_motion_module": name == "lcm"}
        junet, uparams, tunet = unet_pair(unet_kw, LCM_MOTION, seed=41)
        jvae, vparams, tvae = vae_pair(seed=42)
        jclip, cparams, tclip = clip_pair(seed=43)
        jcn, tcn, jad, tad = dict(controlnets=[], controlnet_params=[]), [], None, None
        if name == "controlnet":
            jmodel, params, tmodel = controlnet_pair(LCM_CN, seed=44)
            jcn = dict(controlnets=[jmodel], controlnet_params=[params], cond_scales=[0.8])
            tcn = [tmodel]
        if name == "ip":
            jad, tad = adapter_pair("base")
        jpipe = jfacade.ControlAnimatePipeline(
            JaxRunConfig(**kw), models=jengine.EngineModels(
                unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams, **jcn),
            text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams), ip_adapter=jad)
        tpipe = tfacade.ControlAnimatePipeline(
            RunConfig(**kw), models=tengine.EngineModels(unet=tunet, vae=tvae, controlnets=tcn),
            text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), ip_adapter=tad,
            device="cpu")
        _PIPES[name] = (jpipe, tpipe)
    jpipe, tpipe = _PIPES[name]
    jpipe._overlap_latent_cache = tpipe._overlap_latent_cache = None
    return jpipe, tpipe


def draws(seed: int) -> JaxDraws:
    return JaxDraws(jax.random.PRNGKey(seed))


class WithJaxDraws:
    """The port pipeline, its noise drawn by JAX (the JAX loop's draws)."""

    def __init__(self, pipe):
        self.pipe, self.device = pipe, pipe.device

    def animate(self, *args, seed, **kw):
        return self.pipe.animate(*args, seed=seed, noise=draws(seed), **kw)

    def prepare_cond_images(self, *args, **kw):
        return self.pipe.prepare_cond_images(*args, **kw)


def run_loops(tmp_path, name, frames, run_kw=None, upscalers=(None, None), pix_fmt="rgb24",
              **cfg_kw):
    """The same segment run through the JAX loop (its pipeline's windows
    recorded) and the port's (JAX draws): ((summary, frames, progress,
    JAX windows), (summary, frames, progress)). A `should_stop` in `run_kw`
    is made from the run's progress list; the sinks take `pix_fmt`, as an
    ffmpeg sink would."""
    jpipe, tpipe = pipes(name)
    kw = {**BASE, **PROFILES[name], "parallel_segments": 2, **cfg_kw}
    jwindows = []
    animate_async = jpipe.animate_async

    def record(input_frames, last, **call):
        out = animate_async(input_frames, last, **call)
        jwindows.append((np.asarray(input_frames), None if last is None else np.asarray(last),
                         {k: call[k] for k in ("overlaps", "strength", "seed", "epoch",
                                                "segments")}, np.asarray(out)))
        return out

    out = []
    for side, (cfg_cls, loop, media, pipe), up in zip(
            ("jax", "torch"), ((JaxRunConfig, jax_vid2vid, jmedia, jpipe),
                               (RunConfig, tv2v.vid2vid, tmedia, WithJaxDraws(tpipe))),
            upscalers):
        if side == "jax":
            jpipe.animate_async = record
        progress, sink = [], media.ArrayFrameSink()
        sink.pix_fmt = pix_fmt  # read by both loops
        extra = dict(run_kw or {})
        if "should_stop" in extra:
            extra["should_stop"] = extra["should_stop"](progress)
        try:
            summary = loop(config=cfg_cls(**kw, output_video_dir=str(tmp_path / side)),
                           pipeline=pipe, frame_source=media.ArrayFrameSource(frames),
                           frame_sink=sink, upscaler=up, progress=progress.append, **extra)
        finally:
            jpipe.animate_async = animate_async
        out.append((summary, [np.asarray(f) for f in sink.frames], progress))
    return (*out[0], jwindows), out[1]


def assert_same_run(j, t):
    (js, jf, jp, _), (ts, tf, tp) = j, t
    for key in ("frames_written", "windows", "segments", "canceled", "seed"):
        assert ts[key] == js[key], key
    assert tp == jp
    assert len(tf) == len(jf)
    for a, b in zip(tf, jf):
        assert a.shape == b.shape and a.dtype == np.uint8
        assert_frames_close(a, b)


# -- the batched stitch --------------------------------------------------------
@pytest.mark.parametrize("to_yuv", [False, True])
@pytest.mark.parametrize("chained", [False, True], ids=["first_window", "overlap_window"])
def test_stitch_window_batch_matches_jax(chained, to_yuv):
    """Three segments of 6 frames, overlap 2, 4 emitted: against JAX's
    vmapped stitch within the color match's gate; each segment equal to
    `stitch_window` on that segment alone; no returned tensor shares
    storage with an input."""
    frames = np.stack([_video(s, 6) for s in range(3)])
    anchor = _video(7, 3) if chained else None
    prev = np.stack([_video(8 + s, 2) for s in range(3)]) if chained else None
    kw = dict(overlap_length=2, to_yuv=to_yuv, emit=4)
    want = jstitch.stitch_window_batch(jnp.asarray(frames), None if anchor is None else
                                       jnp.asarray(anchor), None if prev is None else
                                       jnp.asarray(prev), **kw)
    inputs = [torch.from_numpy(x) if x is not None else None for x in (frames, anchor, prev)]
    got = tstitch.stitch_window_batch(*inputs, **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape) and g.dtype == torch.uint8
        for s in range(3):
            assert_frames_close(g[s].numpy(), np.asarray(w[s]))
    for s in range(3):
        one = tstitch.stitch_window(inputs[0][s], None if anchor is None else inputs[1][s],
                                    None if prev is None else inputs[2][s], **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[s], o)
    stores = {x.untyped_storage().data_ptr() for x in inputs if x is not None}
    assert not stores & {g.untyped_storage().data_ptr() for g in got}


# -- condition maps and anchors of S segments --------------------------------------
def test_prepare_cond_images_of_segments_matches_jax(tmp_path, monkeypatch):
    """(2, 3, 64, 64, 3) frames through canny and HED (seeded
    ControlNetHED.pth): each map keeps the segment axis, canny equal to
    JAX's and HED within 1 LSB, and each segment's maps equal to those of
    its frames annotated alone."""
    path = tmp_path / "ControlNetHED.pth"
    torch.save(_seeded_hed(3).state_dict(), path)
    monkeypatch.setattr(jax_neural, "ANNOTATOR_DIR", tmp_path)
    names = ("lllyasviel/sd-controlnet-canny", "lllyasviel/sd-controlnet-hed")
    kw = {**BASE, "controlnets": names, "cond_scale": (1.0, 0.5)}
    jmodel, params, tmodel = controlnet_pair(LCM_CN, seed=44)
    junet, uparams, tunet = unet_pair(seed=41)
    jvae, vparams, tvae = vae_pair(seed=42)
    jclip, cparams, tclip = clip_pair(seed=43)
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**kw), models=jengine.EngineModels(
            unet=junet, unet_params=uparams, vae=jvae, vae_params=vparams,
            controlnets=[jmodel, jmodel], controlnet_params=[params, params],
            cond_scales=[1.0, 0.5]),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams))
    tpipe = tfacade.ControlAnimatePipeline(
        RunConfig(**kw), models=tengine.EngineModels(
            unet=tunet, vae=tvae, controlnets=[tmodel, tmodel],
            annotators=[canny, HEDAnnotator.from_file(path, device="cpu")]),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), device="cpu")
    frames = np.stack([_video(20, 3), _video(21, 3)])
    want = jpipe.prepare_cond_images(frames, 0)
    got = tpipe.prepare_cond_images(torch.from_numpy(frames), 0)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want] == [(2, 3, 64, 64, 3)] * 2
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert _lsb(got[1].numpy(), want[1]) <= 1 and got[1].float().std() > 5
    for s in range(2):
        alone = tpipe.prepare_cond_images(frames[s], 0)
        for g, a in zip(got, alone):
            assert torch.equal(g[s], a[0])


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_embed_images_of_three_segments_match_jax(no_ipp, kind):  # noqa: F811
    """The anchors of three segments through one run of the tower equal
    the per-frame embeds (the JAX package's
    `test_embed_images_matches_per_frame_loop`), and JAX's, for both uncond
    sources."""
    jad, tad = adapter_pair(kind)
    frames = np.stack([_video(30 + s, 1)[0] for s in range(3)])
    cond, uncond = tad.embed_images(torch.from_numpy(frames))
    want_c, want_u = jad.embed_images(frames)
    assert tuple(cond.shape) == tuple(uncond.shape) == (3, 4, 16)
    np.testing.assert_allclose(cond.numpy(), np.asarray(want_c), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(uncond.numpy(), np.asarray(want_u), atol=1e-4, rtol=1e-4)
    for s in range(3):
        one_c, one_u = tad.embed_image(frames[s])
        np.testing.assert_allclose(cond[s].numpy(), one_c[0].numpy(), atol=1e-5, rtol=1e-5)
        assert torch.equal(uncond[s], one_u[0])


# -- animate(segments=2) ---------------------------------------------------------------
def _segments(seed: int, frames: int = 4) -> np.ndarray:
    return np.stack([_video(seed, frames), _video(seed + 1, frames)])


def test_animate_segments_lcm_reuses_overlap_latents_as_jax(monkeypatch):
    """Native LCM, two segments: a whole window, then the overlap window
    (epoch 1, overlaps 2) from the cached (2, 2, h, w, 4) tail latents,
    whose encode takes the new frames only; within 1 LSB of JAX."""
    jpipe, tpipe = pipes("lcm")
    encoded = []
    encode = tengine.AnimationEngine.encode_frames

    def spy(self, frames, noise):
        encoded.append(tuple(frames.shape[:2]))
        return encode(self, frames, noise)

    monkeypatch.setattr(tengine.AnimationEngine, "encode_frames", spy)
    w0 = _segments(40)
    want0 = np.asarray(jpipe.animate_async(w0, None, seed=5, epoch=0, segments=2))
    got0 = tpipe.animate(w0, None, seed=5, epoch=0, segments=2, noise=draws(5))
    assert tuple(got0.shape) == want0.shape == (2, 4, SIZE, SIZE, 3)
    assert _lsb(got0.numpy(), want0) <= 1
    epoch, tail = tpipe._overlap_latent_cache
    assert epoch == 1 and tuple(tail.shape) == (2, 2, 8, 8, 4)
    w1 = np.concatenate([w0[:, -2:], _segments(42, 2)], axis=1)
    kw = dict(overlaps=2, strength=0.85, seed=5, epoch=1, segments=2)
    want1 = np.asarray(jpipe.animate_async(w1, want0[:, -2:], **kw))
    got1 = tpipe.animate(w1, got0[:, -2:], noise=draws(5), **kw)
    assert _lsb(got1.numpy(), want1) <= 1
    assert encoded == [(2, 4), (2, 2)]


def test_overlap_latent_cache_checks_the_batch():
    """A two-segment window caches (2, 2, ...) tail latents; a one-segment
    window at the next epoch must not take them (JAX checks the batch):
    it encodes its frames, within 1 LSB of JAX."""
    jpipe, tpipe = pipes("lcm")
    w0 = _segments(44)
    want0 = np.asarray(jpipe.animate_async(w0, None, seed=5, epoch=0, segments=2))
    got0 = tpipe.animate(w0, None, seed=5, epoch=0, segments=2, noise=draws(5))
    assert _lsb(got0.numpy(), want0) <= 1
    w1 = np.concatenate([w0[0, -2:], _video(46, 2)])
    kw = dict(overlaps=2, strength=0.85, seed=5, epoch=1)
    want1 = np.asarray(jpipe.animate_async(w1, want0[0, -2:], **kw))
    got1 = tpipe.animate(w1, got0[0, -2:], noise=draws(5), **kw)
    assert tuple(got1.shape) == want1.shape == (4, SIZE, SIZE, 3)
    assert _lsb(got1.numpy(), want1) <= 1
    assert tuple(tpipe._overlap_latent_cache[1].shape) == (1, 2, 8, 8, 4)


def test_animate_segments_cfg_matches_jax():
    """Euler under CFG 7.5, two segments: an overlap window at 0.92 from
    each segment's own last outputs (the doubled batch is [negative x 2,
    positive x 2]); within 1 LSB of JAX."""
    jpipe, tpipe = pipes("cfg")
    w1, last = _segments(50), _segments(52, 2)
    kw = dict(overlaps=2, strength=0.92, seed=5, epoch=1, segments=2)
    want1 = np.asarray(jpipe.animate_async(w1, last, **kw))
    got1 = tpipe.animate(w1, last, noise=draws(5), **kw)
    assert _lsb(got1.numpy(), want1) <= 1
    assert _lsb(got1[0].numpy(), got1[1].numpy()) > 1  # each from its own last outputs


# -- the loop against JAX's _run_segments ----------------------------------------------
def test_segment_loop_counts_and_determinism_match_jax(tmp_path):
    """20 frames over 2 segments: 4 lockstep windows of 4 frames (overlap 2)
    a segment cover every frame once, as in JAX; the run repeats exactly."""
    frames = _video(60, 20)
    j, t = run_loops(tmp_path, "lcm", frames)
    assert_same_run(j, t)
    assert t[0]["frames_written"] == 20 and t[0]["segments"] == 2 and t[0]["windows"] == 4
    assert t[2] == [{"windows": w, "segments": 2, "frames_generated": 2 * (4 + 2 * (w - 1))}
                    for w in range(1, 5)]
    assert {"read_input", "animate_window", "stitch", "emit_buffer",
            "upscale_and_emit"} <= set(t[0]["timers"])
    _, again = run_loops(tmp_path / "again", "lcm", frames)
    assert all(np.array_equal(a, b) for a, b in zip(again[1], t[1]))


def test_segment_loop_cancel_is_all_or_nothing_as_jax(tmp_path):
    """A stop request after the second window: nothing is written, the
    summary says `canceled`, and the last progress report counts no frames,
    as in JAX."""
    def stop_after_two(progress):
        return lambda: bool(progress and progress[-1]["windows"] >= 2)

    j, t = run_loops(tmp_path, "lcm", _video(61, 20), run_kw=dict(should_stop=stop_after_two))
    assert_same_run(j, t)
    assert t[0]["canceled"] is True and t[0]["frames_written"] == 0 and not t[1]
    assert t[0]["windows"] == 2 and t[2][-1] == {"windows": 2, "segments": 2,
                                                 "frames_generated": 0}


def test_segments_match_the_sequential_loop_per_segment(tmp_path):
    """The parity contract: each segment of a one-window segment run equals
    the sequential loop on that segment's frames alone, same seed, within 1
    LSB; and the JAX segment run within the stitch's gate."""
    frames = _video(62, 8)
    j, t = run_loops(tmp_path, "lcm", frames)
    assert_same_run(j, t)
    assert t[0]["windows"] == 1 and t[0]["frames_written"] == 8
    _, tpipe = pipes("lcm")
    sequential = []
    for s in range(2):
        sink = tmedia.ArrayFrameSink()
        tv2v.vid2vid(config=RunConfig(**BASE, output_video_dir=str(tmp_path / f"seq{s}")),
                     pipeline=WithJaxDraws(tpipe),
                     frame_source=tmedia.ArrayFrameSource(frames[4 * s:4 * s + 4]),
                     frame_sink=sink)
        sequential += sink.frames
    assert _lsb(np.stack(t[1]), np.stack(sequential)) <= 1


@pytest.mark.parametrize("n,segments,windows", [(18, 2, 4), (5, 4, 1)])
def test_segment_loop_pads_and_trims_as_jax(tmp_path, n, segments, windows):
    """18 frames over 2 segments: 9 a segment, padded to 10 (4 windows), the
    pad trimmed; 5 over 4: two segments of pure pad are skipped."""
    j, t = run_loops(tmp_path, "lcm", _video(63, n), parallel_segments=segments)
    assert_same_run(j, t)
    assert t[0]["frames_written"] == len(t[1]) == n and t[0]["windows"] == windows


def test_segment_loop_max_windows_keeps_the_boundaries(tmp_path):
    """max_windows bounds each segment's windows without moving the split:
    each segment's frames written before its tail are a prefix of the
    unbounded run's; the same counts and frames as JAX."""
    frames = _video(64, 20)
    _, full = run_loops(tmp_path / "full", "lcm", frames)
    j, t = run_loops(tmp_path, "lcm", frames, run_kw=dict(max_windows=2))
    assert_same_run(j, t)
    assert t[0]["frames_written"] == 12  # 2 windows x 2 new + 2 tail frames, a segment
    for bounded_lo, full_lo in ((0, 0), (6, 10)):
        for a, b in zip(t[1][bounded_lo:bounded_lo + 4], full[1][full_lo:full_lo + 4]):
            assert np.array_equal(a, b)


class Replay:
    """The JAX loop's windows, in order, for the port's loop; records the
    port loop's calls."""

    device = "cpu"

    def __init__(self, windows):
        self.windows, self.calls = windows, []

    def animate(self, input_frames, last, **kw):
        self.calls.append((np.asarray(input_frames), None if last is None else np.asarray(last),
                           {k: kw[k] for k in ("overlaps", "strength", "seed", "epoch",
                                               "segments")}))
        return torch.from_numpy(self.windows[len(self.calls) - 1][3])


def _hold_windows_then_replay(tmp_path, name, frames, calls):
    """The JAX segment run; each of its windows through the port's facade
    (within 1 LSB); then the port's loop on the JAX windows, which makes the
    same calls. Returns the JAX windows, the replay's calls, and the frames
    the port's and the JAX loop wrote."""
    j, _ = run_loops(tmp_path, name, frames)
    jwindows = j[3]
    assert [(c[2]["epoch"], c[2]["overlaps"], c[2]["strength"], c[1] is None)
            for c in jwindows] == calls
    _, tpipe = pipes(name)
    for inputs, last, call, want in jwindows:
        got = tpipe.animate(inputs, last, noise=draws(call["seed"]), **call)
        assert _lsb(got.numpy(), want) <= 1
    replay, sink = Replay(jwindows), tmedia.ArrayFrameSink()
    summary = tv2v.vid2vid(config=RunConfig(**{**BASE, **PROFILES[name]}, parallel_segments=2,
                                            output_video_dir=str(tmp_path / "replay")),
                           pipeline=replay, frame_source=tmedia.ArrayFrameSource(frames),
                           frame_sink=sink)
    assert summary["frames_written"] == j[0]["frames_written"] == len(frames)
    assert [c[2] for c in replay.calls] == [c[2] for c in jwindows]
    return jwindows, replay.calls, sink.frames, j[1]


def test_segment_loop_back_with_a_controlnet_matches_jax(tmp_path):
    """A canny ControlNet and `loop_back_frames`, 12 frames over 2 segments
    (two windows each): each JAX window (annotated inside the window, from
    the input whose overlap slots hold that segment's generated frames)
    within 1 LSB through the port's facade; the port's loop fills the
    overlap slots of each segment with its own stitched tail."""
    frames = _video(65, 12)
    jwindows, calls, written, jax_written = _hold_windows_then_replay(
        tmp_path, "controlnet", frames, [(0, 0, 0.9, True), (1, 2, 0.85, False)])
    for a, b in zip(written, jax_written):
        assert_frames_close(a, b)
    segs = frames.reshape(2, 6, *frames.shape[1:])
    second = calls[1][0]
    assert np.array_equal(second[:, 2:], segs[:, 4:6])
    assert not np.array_equal(second[:, :2], segs[:, 2:4])  # looped back
    for s in range(2):
        assert_frames_close(second[s, :2], jwindows[1][0][s, :2])


def test_segment_initial_generation_with_ip_adapter_matches_jax(tmp_path, no_ipp):  # noqa: F811
    """The IP-Adapter's initial double pass, batched, on 8 frames over 2
    segments: the window from zero image tokens, again from each segment's
    own last 2 frames (each segment's image prompt its own first); each JAX
    pass within 1 LSB through the port's facade, and the port's loop makes
    the same calls with the same anchors and writes the batched stitch of
    the second pass color-matched to the first pass's first frames, bit for
    bit. (Against the JAX loop's frames the color match's 64x64 gap shows
    here: 3 values of one frame differ, one by 9 LSB, over
    `assert_frames_close`'s 8; the stitch is held against JAX's in
    `test_stitch_window_batch_matches_jax`. ROADMAP §3 "Tolerances".)"""
    frames = _video(66, 8)
    jwindows, calls, written, _ = _hold_windows_then_replay(
        tmp_path, "ip", frames, [(0, 0, 0.9, True), (0, 2, 0.85, False)])
    first, second = (torch.from_numpy(w[3]) for w in jwindows)
    assert np.array_equal(calls[1][1], first[:, -2:].numpy())
    emitted, _, _, tail = tstitch.stitch_window_batch(second, first[:, 0], None, overlap_length=2,
                                                      to_yuv=False, emit=2)
    want = torch.cat([emitted, tail], dim=1).reshape(-1, SIZE, SIZE, 3)
    assert np.array_equal(np.stack(written), want.numpy())


@pytest.mark.parametrize("scale,pix_fmt", [(4.0, "rgb24"), (4.0, "yuv420p"), (1.0, "yuv420p")])
def test_segment_loop_upscales_and_packs_as_jax(tmp_path, scale, pix_fmt):
    """8 frames over 2 segments into an rgb24 or a yuv420p sink: at
    `upscale: 4` through each package's Upscaler on the same seeded
    RealESRGAN, each segment upscaled 4 frames at a time after the loop
    (then packed to I420 for a yuv420p sink); at 1 the stitch packs each
    window and the tail to I420. Within the stitch's gate of JAX's."""
    ups = (upscaler_pair(tmp_path / "realesrgan.pth", scale=scale, seed=11) if scale > 1
           else (None, None))
    j, t = run_loops(tmp_path, "lcm", _video(67, 8), upscalers=ups, pix_fmt=pix_fmt,
                     upscale=scale)
    assert_same_run(j, t)
    side = int(SIZE * scale)
    size = side * side * 3 // 2 if pix_fmt == "yuv420p" else side * side * 3
    assert len(t[1]) == 8 and all(f.size == size for f in t[1])


# -- what a segment run refuses ---------------------------------------------------
@pytest.mark.parametrize("bad", [dict(resume=True), dict(save_frames=True),
                                 dict(overlap_length=4), dict(source=None)],
                         ids=["resume", "save_frames", "overlap", "txt2vid"])
def test_segment_run_refusals_raise_before_any_io(tmp_path, bad):
    """ValueError, as the JAX loop raises, before the output folder is made
    or a pipeline is built."""
    bad = dict(bad)
    source = bad.pop("source", tmedia.ArrayFrameSource(_video(68, 8)))
    out = tmp_path / "out"
    cfg = RunConfig(**{**BASE, "parallel_segments": 2, "output_video_dir": str(out), **bad})
    with pytest.raises(ValueError, match="parallel_segments"):
        tv2v.vid2vid(config=cfg, pipeline=None, frame_source=source,
                     frame_sink=tmedia.ArrayFrameSink())
    assert not out.exists()


def test_shipped_multichip_profile_raises_only_for_its_mesh():
    """SampleConfigMultiChip.yaml as shipped names a [4, 2] mesh, which the
    port does not take (JAX's make_mesh refuses it on one device);
    without it the profile's `parallel_segments: 4` is taken."""
    cfg = RunConfig.from_yaml("configs/prompts/SampleConfigMultiChip.yaml")
    assert cfg.parallel_segments == 4 and cfg.mesh_shape == (4, 2)
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        require_ported(cfg)
    with pytest.raises(NotImplementedError, match="mesh_shape"):
        tv2v.vid2vid(config=cfg, pipeline=None)
    require_ported(cfg.replace(mesh_shape=()))
