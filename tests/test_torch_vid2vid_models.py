"""The port's facade and vid2vid loop against the JAX ones on the same tiny
real models (the same weights through `weights/from_jax.py`, the same JAX
noise): LCM, the multi-step CFG sampler, a canny ControlNet with and without
loop-back, and the ControlNet dumps. Gate: the windows within 1 LSB, then
the stitch's `assert_frames_close`."""

import jax
import numpy as np
import pytest

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.io import media as jmedia
from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from scripts.vid2vid import vid2vid as jax_vid2vid
from test_torch_common import JaxDraws, clip_pair, unet_pair, vae_pair
from test_torch_controlnet import LCM_CN, controlnet_pair
from torch_loop_helpers import SIZE, _video, assert_frames_close


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
