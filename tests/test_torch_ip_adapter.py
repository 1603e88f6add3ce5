"""The port's IP-Adapter (`pipelines/ip_adapter.py`, the CLIP vision tower,
the UNet's dual-stream cross-attention, the engine's, facade's and loop's
hooks) against the JAX package's on the CPU: the same seeded weights
(carried by `weights/from_jax.py`), fp32, tiny widths, and the JAX draws.

Gates (ROADMAP's): 1e-4 on model forwards, 2e-3 on a window's decoded
frames, `assert_frames_close` (the uint8 color match's gate over a chain of
windows) on a loop, and the anchor's resize bit for bit against cv2 with
Intel IPP off (ROADMAP §3 (y)). Then the disk build from a synthetic
`.bin` and HF image-encoder folder against the JAX build (base and plus),
the shipped profile's settings through the CLI at tiny geometry, and the
settings that raise."""

import dataclasses
import functools
import json
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from safetensors.torch import save_file

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.io import media as jmedia
from controlanimate_tpu.models import layers as jlayers
from controlanimate_tpu.models.clip import CLIPVisionConfig as JaxVisionConfig
from controlanimate_tpu.models.clip import CLIPVisionModelWithProjection as JaxVision
from controlanimate_tpu.models.tokenizer import CLIPTokenizer as JaxTokenizer
from controlanimate_tpu.pipelines import engine as jengine
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu.pipelines import ip_adapter as jip
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models import layers as tlayers
from controlanimate_tpu_torch.models.clip import (CLIPTextConfig, CLIPTextModel,
                                                  CLIPVisionConfig, CLIPVisionModelWithProjection)
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from controlanimate_tpu_torch.models.vae import AutoencoderKL
from controlanimate_tpu_torch.ops.resize import resize_cubic
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.pipelines import ip_adapter as tip
from controlanimate_tpu_torch.weights import from_jax
from scripts.vid2vid import vid2vid as jax_vid2vid
from test_ip_adapter import _sd_numpy, _torch_image_proj, _torch_mlp_proj, _torch_resampler
from test_torch_common import LCM_MOTION, LCM_UNET, JaxDraws, clip_pair, random_params, unet_pair
from test_torch_common import vae_pair
from test_torch_controlnet import LCM_CN, controlnet_pair
from torch_loop_helpers import StubPipeline, _video, assert_frames_close

# the tiny tower of tests/test_ip_adapter.py `test_embed_images_matches_per_frame_loop`
VISION = dict(hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32, image_size=224,
              patch_size=32, projection_dim=12)
D_CTX = 16  # the tiny UNets' cross-attention width
IP_UNET = {**LCM_UNET, "ip_tokens": 4}
# a perceiver with the checkpoints' 64-wide heads, over the tiny tower's states
PLUS = dict(dim=64, depth=1, dim_head=64, heads=1, num_queries=4, embedding_dim=16,
            output_dim=D_CTX)
GATE = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's tiny models on one thread: the suite runs six workers on
    the machine's cores, and PyTorch's intra-op threads on top of them made
    the CLI run here 8x slower (its frames do not depend on the count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _close(got, want, gate=1e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=gate, rtol=gate)


@pytest.fixture
def no_ipp():
    """cv2 with Intel IPP off: OpenCV's own INTER_CUBIC, which the port
    computes (ROADMAP §3 (y))."""
    cv2.setUseOptimized(False)
    try:
        yield
    finally:
        cv2.setUseOptimized(True)


def _shapes(module, *args):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args)["params"])


def vision_pair(seed: int = 3):
    jm = JaxVision(JaxVisionConfig(**VISION))
    params = random_params(_shapes(jm, jnp.zeros((1, 224, 224, 3))), seed)
    tm = CLIPVisionModelWithProjection(CLIPVisionConfig(**VISION)).eval()
    tm.load_state_dict(from_jax.clip_vision_state_dict(params, tm.config))
    return jm, params, tm


def projection_pair(kind: str, seed: int = 4):
    """(JAX module, its params, port module) of one SD1.5 projection at the
    tiny tower's widths."""
    if kind == "base":
        jm, x = jip.ImageProjModel(cross_attention_dim=D_CTX, num_tokens=4), jnp.zeros((1, 12))
        tm = tip.ImageProjModel(D_CTX, 12, 4)
    elif kind == "full":
        jm, x = jip.MLPProjModel(cross_attention_dim=D_CTX), jnp.zeros((1, 5, 16))
        tm = tip.MLPProjModel(D_CTX, 16)
    else:
        jm, x = jip.Resampler(**PLUS), jnp.zeros((1, 5, 16))
        tm = tip.Resampler(**PLUS)
    params = random_params(_shapes(jm, x), seed)
    sd = (from_jax.mlp_proj_state_dict(params) if kind == "full" else
          from_jax.image_proj_state_dict(params, PLUS["depth"] if kind == "plus" else 0))
    tm.load_state_dict(sd)
    return jm, params, tm.eval()


@functools.partial(jax.jit, static_argnums=0)
def _jitted_apply(module, variables, x):
    return module.apply(variables, x)


class _Jitted:
    """A flax module whose `apply` is compiled (the JAX adapter calls its
    tower's and projection's `apply` op by op otherwise); equal modules, as
    the tiny towers of every test here, share one program."""

    def __init__(self, module):
        self.module = module

    def apply(self, variables, x):
        return _jitted_apply(self.module, variables, x)


def adapter_pair(kind: str = "base"):
    """A JAX and a port IPAdapter with the same tiny tower and projection."""
    jv, vparams, tv = vision_pair()
    jv = _Jitted(jv)
    jp, pparams, tp = projection_pair(kind)
    source = "image_embeds" if kind == "base" else "penultimate"
    tokens = 4
    return (jip.IPAdapter(jv, vparams, jp, pparams, num_tokens=tokens, embed_source=source),
            tip.IPAdapter(tv, tp, num_tokens=tokens, embed_source=source))


# -- (a) the projections, (b) their detection ---------------------------------
@pytest.mark.parametrize("kind", ["base", "full", "plus"])
def test_projection_matches_jax(kind):
    jm, params, tm = projection_pair(kind)
    rng = np.random.RandomState(5)
    x = rng.randn(2, 12) if kind == "base" else rng.randn(2, 5, 16)
    x = x.astype(np.float32)
    want = _Jitted(jm).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want)


def _layout(name):
    """One `image_proj` state dict of each layout tests/test_ip_adapter.py
    builds, the cross-attention width the caller passes, and an input."""
    torch.manual_seed(0)
    rng = np.random.RandomState(6)
    if name == "base":
        return _sd_numpy(_torch_image_proj(32, 64, 4)), 32, rng.randn(2, 64)
    if name == "full":
        return _sd_numpy(_torch_mlp_proj(32, 64)), 32, rng.randn(2, 17, 64)
    if name == "plus":
        m = _torch_resampler(dim=128, depth=2, dim_head=64, heads=2, num_queries=8,
                             embedding_dim=48, output_dim=32)
        return _sd_numpy(m), 32, rng.randn(2, 10, 48)
    if name == "xl":
        return _sd_numpy(_torch_image_proj(2048, 1280, 4)), 768, rng.randn(2, 1280) * 0.2
    m = _torch_resampler(dim=128, depth=1, dim_head=64, heads=2, num_queries=8,
                         embedding_dim=48, output_dim=2048)
    return _sd_numpy(m), 768, rng.randn(2, 10, 48)


@pytest.mark.parametrize("name", ["base", "full", "plus", "xl", "plus-xl"])
def test_build_projection_matches_jax(name):
    sd, cross, x = _layout(name)
    x = x.astype(np.float32)
    vcfg = (32, 8)  # image and patch size: 17 tokens for the full layout
    jproj = jip.IPAdapter.build_projection(
        sd, JaxVisionConfig(image_size=vcfg[0], patch_size=vcfg[1]), cross_attention_dim=cross)
    tproj = tip.build_projection({k: torch.from_numpy(v) for k, v in sd.items()},
                                 CLIPVisionConfig(image_size=vcfg[0], patch_size=vcfg[1]),
                                 cross_attention_dim=cross)
    assert (tproj.num_tokens, tproj.embed_source, tproj.variant) == (
        jproj.num_tokens, jproj.embed_source, jproj.variant)
    assert tproj.variant == name
    want = _Jitted(jproj.model).apply({"params": jproj.params}, jnp.asarray(x))
    with torch.no_grad():
        got = tproj.model(torch.from_numpy(x))
    _close(got, want)


def test_build_projection_rejects_what_jax_rejects():
    sd = {"proj.weight": np.zeros((1000, 16), np.float32), "proj.bias": np.zeros(1000, np.float32),
          "norm.weight": np.ones(16, np.float32), "norm.bias": np.zeros(16, np.float32)}
    for build in (lambda: jip.IPAdapter.build_projection(sd, None),
                  lambda: tip.build_projection(sd, None)):
        with pytest.raises(ValueError, match="not a multiple"):
            build()
    with pytest.raises(ValueError, match="unrecognized"):
        tip.build_projection({"weight": np.zeros(3, np.float32)}, None)


# -- (c) the vision tower, (d) the anchor's preprocessing, (e) the embeds ----
def test_vision_tower_matches_jax():
    jm, params, tm = vision_pair()
    x = np.random.RandomState(7).randn(2, 224, 224, 3).astype(np.float32)
    want = _Jitted(jm).apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for key in ("image_embeds", "pooled_output", "penultimate_hidden_states"):
        assert got[key].shape == want[key].shape, key
        _close(got[key], want[key])


@pytest.mark.parametrize("shape", [(768, 512), (37, 53), (224, 224), (150, 301)])
def test_preprocess_clip_image_matches_jax(no_ipp, shape):
    """Bit for bit before and after the normalisation, on a frame of the
    shipped geometry and odd ones (down, up, equal and mixed scales)."""
    frame = np.random.RandomState(sum(shape)).randint(0, 256, (*shape, 3), dtype=np.uint8)
    resized = resize_cubic(torch.from_numpy(frame)[None], 224, 224)[0].numpy()
    np.testing.assert_array_equal(
        resized, cv2.resize(frame, (224, 224), interpolation=cv2.INTER_CUBIC))
    got = tip.preprocess_clip_image(torch.from_numpy(frame)[None])
    np.testing.assert_array_equal(got.numpy(), jip.preprocess_clip_image(frame))


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_embed_images_match_jax(no_ipp, kind):
    """Cond and uncond tokens of three anchors at once and of one; the uncond
    tokens are computed once and cached (base: zero embeds projected; plus:
    a zero image's penultimate states)."""
    jad, tad = adapter_pair(kind)
    jad.proj_model = _Jitted(jad.proj_model)
    frames = np.random.RandomState(8).randint(0, 256, (3, 64, 48, 3), dtype=np.uint8)
    cond_j, uncond_j = jad.embed_images(frames)
    cond_t, uncond_t = tad.embed_images(torch.from_numpy(frames))
    assert cond_t.shape == uncond_t.shape == (3, 4, D_CTX)
    _close(cond_t, cond_j)
    _close(uncond_t, uncond_j)
    cache = tad._uncond_cache
    one_c, one_u = tad.embed_image(frames[1])
    assert tad._uncond_cache is cache
    _close(one_c, jad.embed_image(frames[1])[0])
    _close(one_c[0], cond_t[1])
    assert torch.equal(one_u[0], uncond_t[0])


# -- (f) the dual-stream attention, (g) the UNet and the injection ------------
def test_dual_stream_attention_matches_jax():
    """At ip_scale 0.65 against the JAX `Attention(ip_tokens=4)`; at 0 equal
    to text-only attention over the context without its image tokens."""
    jm = jlayers.Attention(16, heads=2, dim_head=8, cross_attention_dim=12, ip_tokens=4)
    rng = np.random.RandomState(9)
    x = rng.randn(2, 10, 16).astype(np.float32)
    ctx = rng.randn(2, 7 + 4, 12).astype(np.float32)
    params = random_params(_shapes(jm, jnp.zeros((1, 10, 16)), jnp.zeros((1, 11, 12))), 10)
    tm = tlayers.Attention(16, heads=2, dim_head=8, cross_attention_dim=12, ip_tokens=4).eval()
    entries = [(f"{n}.weight", f"{n}/kernel", "dense")
               for n in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip")]
    entries += [("to_out.0.weight", "to_out_0/kernel", "dense"),
                ("to_out.0.bias", "to_out_0/bias", "raw")]
    tm.load_state_dict(from_jax._state_dict(params, iter(entries)))
    want = jax.jit(functools.partial(jm.apply, ip_scale=0.65))(
        {"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(ctx), ip_scale=0.65)
        text_only = tlayers.Attention(16, heads=2, dim_head=8, cross_attention_dim=12).eval()
        text_only.load_state_dict({k: v for k, v in tm.state_dict().items() if "_ip" not in k})
        zero = tm(torch.from_numpy(x), torch.from_numpy(ctx), ip_scale=0.0)
        plain = text_only(torch.from_numpy(x), torch.from_numpy(ctx[:, :7]))
    _close(got, want)
    torch.testing.assert_close(zero, plain, atol=1e-6, rtol=0)
    assert (got - zero).abs().max() > 1e-3
    with pytest.raises(ValueError, match="image tokens"):
        tm(torch.from_numpy(x), torch.from_numpy(ctx[:, :4]))


def _ip_checkpoint(ucfg, seed: int) -> dict:
    """`{2k+1}.to_{k,v}_ip.weight` of the k-th cross-attention in checkpoint
    order, (inner, cross) each, seeded."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, path in enumerate(tip.attn2_paths_in_checkpoint_order(ucfg)):
        level = int(path.split(".")[1]) if "blocks." in path and "mid" not in path else None
        if path.startswith("down"):
            inner = ucfg.block_out_channels[level]
        elif path.startswith("up"):
            inner = ucfg.block_out_channels[::-1][level]
        else:
            inner = ucfg.block_out_channels[-1]
        for name in ("to_k_ip", "to_v_ip"):
            out[f"{2 * i + 1}.{name}.weight"] = (rng.randn(inner, ucfg.cross_attention_dim)
                                                 * 0.3).astype(np.float32)
    return out


def test_unet_with_injected_ip_weights_matches_jax():
    """The UNet with 4 image tokens, its to_k_ip / to_v_ip replaced by a
    checkpoint's in checkpoint order (down, up, mid) on both sides: the same
    state dict, and the forward at ip_scale 0.65 within 1e-4 (no motion
    modules: the image stream is the cross-attention's alone)."""
    jmodel, params, tmodel = unet_pair({**IP_UNET, "use_motion_module": False}, LCM_MOTION,
                                       seed=11)
    ucfg = tmodel.config
    assert tip.attn2_paths_in_checkpoint_order(ucfg) == [
        "down_blocks.0.attentions.0", "up_blocks.1.attentions.0", "up_blocks.1.attentions.1",
        "mid_block.attentions.0"]
    ip_sd = _ip_checkpoint(ucfg, 12)
    jad = jip.IPAdapter.random_init(clip_embed_dim=12, cross_attention_dim=D_CTX)
    jad.ip_sd = ip_sd
    params = jad.inject_into_unet_params(jax.tree_util.tree_map(np.asarray, params),
                                         jmodel.config)
    tad = tip.IPAdapter(None, tip.ImageProjModel(D_CTX, 12, 4),
                        ip_sd={k: torch.from_numpy(v) for k, v in ip_sd.items()})
    tad.inject(tmodel)
    want_sd = from_jax.unet_state_dict(params, ucfg)
    for k, v in tmodel.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
    rng = np.random.RandomState(13)
    x = rng.randn(1, 2, 8, 8, 4).astype(np.float32)
    ctx = rng.randn(1, 7 + 4, D_CTX).astype(np.float32)
    w = rng.randn(1, 8).astype(np.float32)
    fn = jax.jit(lambda p, x, c, w: jmodel.apply({"params": p}, x, jnp.asarray([5]), c,
                                                 timestep_cond=w, ip_scale=0.65))
    want = fn(params, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(w))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.tensor([5]), torch.from_numpy(ctx),
                     timestep_cond=torch.from_numpy(w), ip_scale=0.65)
        zero = tmodel(torch.from_numpy(x), torch.tensor([5]), torch.from_numpy(ctx),
                      timestep_cond=torch.from_numpy(w), ip_scale=0.0)
    _close(got, want)
    assert (got - zero).abs().max() > 1e-3
    with pytest.raises(ValueError, match="image tokens"):
        tad.inject(UNet3DConditionModel(dataclasses.replace(ucfg, ip_tokens=0)))
    del tad.ip_sd["5.to_v_ip.weight"]
    with pytest.raises(ValueError, match="up_blocks.1.attentions.1"):
        tad.inject(tmodel)


# -- (h) guess-mode CFG windows with a ControlNet, (i) the loop ----------------
def test_ip_adapter_loop_with_initial_generation_matches_jax(tmp_path, no_ipp):
    """The shipped profile's run at tiny size through the JAX loop: a real
    tiny adapter (tower and base projection), `use_ipadapter` and
    `do_initial_generation`, LCMScheduler under CFG 1.35, a canny ControlNet
    in guess mode. Its three windows (the first from zero tokens, again
    anchored on its own tail at `overlap_strength`, then an overlap window
    anchored on the last outputs) are each run by the port's facade on the
    same inputs and JAX draws: within 1 LSB, the ControlNet seeing the
    positive text without the image tokens. Then the port's loop, given the
    JAX windows, makes the same calls and writes the same frames within the
    stitch's gate (`assert_frames_close`). Run free, the two loops' 1 LSB
    window differences feed the next windows' anchors and grow through the
    color match (up to 23 LSB on 4% of a 64x64 frame's values)."""
    junet, uparams, tunet = unet_pair({**IP_UNET, "use_motion_module": False}, LCM_MOTION,
                                      seed=19)
    jvae, vparams, tvae = vae_pair(seed=20)
    jclip, cparams, tclip = clip_pair(seed=21)
    jcn, cnparams, tcn = controlnet_pair(LCM_CN, seed=22)
    jad, tad = adapter_pair("base")
    kw = dict(width=64, height=64, frame_count=4, overlap_length=2, use_lcm=False,
              scheduler="LCMScheduler", steps=2, strength=1.0, overlap_strength=0.92,
              lcm_origin_steps=8, guidance_scale=1.35, guess_mode=True, dtype="float32",
              prompt="a (red fox)+", n_prompt="blurry", seed=5,
              ffmpeg_path="ffmpeg-absent-here", use_ipadapter=True,
              do_initial_generation=True, ipa_scale=0.65,
              controlnets=("lllyasviel/sd-controlnet-canny",), cond_scale=(0.8,))
    jcfg = JaxRunConfig(**kw, output_video_dir=str(tmp_path / "jax"))
    jpipe = jfacade.ControlAnimatePipeline(
        jcfg, models=jengine.EngineModels(unet=junet, unet_params=uparams, vae=jvae,
                                          vae_params=vparams, controlnets=[jcn],
                                          controlnet_params=[cnparams], cond_scales=[0.8]),
        text_stack=jfacade.TextStack(JaxTokenizer.tiny(), jclip, cparams), ip_adapter=jad)
    jcalls = []
    animate_async = jpipe.animate_async

    def record(input_frames, last, **kw):
        out = animate_async(input_frames, last, **kw)
        jcalls.append((np.asarray(input_frames), None if last is None else np.asarray(last),
                       {k: kw[k] for k in ("overlaps", "strength", "seed", "epoch")},
                       np.asarray(out)))
        return out

    jpipe.animate_async = record
    frames = _video(6, 6)
    js = jmedia.ArrayFrameSink()
    j = jax_vid2vid(config=jcfg, pipeline=jpipe, frame_source=jmedia.ArrayFrameSource(frames),
                    frame_sink=js)
    assert [(c[2]["epoch"], c[2]["overlaps"], c[2]["strength"], c[1] is None)
            for c in jcalls] == [(0, 0, 1.0, True), (0, 2, 0.92, False), (1, 2, 0.92, False)]

    tcfg = RunConfig(**kw, output_video_dir=str(tmp_path / "torch"))
    tpipe = tfacade.ControlAnimatePipeline(
        tcfg, models=tengine.EngineModels(unet=tunet, vae=tvae, controlnets=[tcn]),
        text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), tclip), ip_adapter=tad, device="cpu")
    texts = []
    forward = tcn.forward

    def spy(sample, t, text, *args, **kw):
        texts.append(tuple(text.shape))
        return forward(sample, t, text, *args, **kw)

    tcn.forward = spy
    for inputs, last, call, want in jcalls:
        got = tpipe.animate(inputs, last, noise=JaxDraws(jax.random.PRNGKey(call["seed"])),
                            **call)
        assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1
    assert texts and set(texts) == {(1, 77, D_CTX)}  # 77 + 4 tokens, stripped
    tpipe.config = tcfg.replace(ipa_scale=0.0)
    inputs, last, call, want = jcalls[-1]
    other = tpipe.animate(inputs, last, noise=JaxDraws(jax.random.PRNGKey(call["seed"])), **call)
    assert np.abs(other.numpy().astype(int) - want.astype(int)).max() > 2  # the image stream

    class Replay:
        """The JAX windows, in order, for the port's loop."""

        device = "cpu"

        def __init__(self):
            self.calls = []

        def animate(self, input_frames, last, **kw):
            self.calls.append(kw)
            return torch.from_numpy(jcalls[len(self.calls) - 1][3])

    replay, ts = Replay(), tmedia.ArrayFrameSink()
    t = tv2v.vid2vid(config=tcfg, pipeline=replay, frame_source=tmedia.ArrayFrameSource(frames),
                     frame_sink=ts)
    assert t["windows"] == j["windows"] == 2 and t["frames_written"] == j["frames_written"] == 6
    assert [{k: c[k] for k in ("overlaps", "strength", "seed", "epoch")}
            for c in replay.calls] == [c[2] for c in jcalls]
    for a, b in zip(ts.frames, js.frames):
        assert_frames_close(a, b)


def test_initial_generation_without_ip_adapter_changes_nothing(tmp_path):
    """`do_initial_generation` alone runs each window once, as in JAX."""
    runs = []
    for initial in (False, True):
        stub = StubPipeline(16)
        sink = tmedia.ArrayFrameSink()
        cfg = RunConfig(width=64, height=64, frame_count=16, overlap_length=8, seed=7,
                        strength=0.9, overlap_strength=0.8, ffmpeg_path="ffmpeg-absent-here",
                        do_initial_generation=initial,
                        output_video_dir=str(tmp_path / str(initial)))
        tv2v.vid2vid(config=cfg, pipeline=stub, frame_source=tmedia.ArrayFrameSource(
            _video(1, 24)), frame_sink=sink)
        runs.append((stub.calls, sink.frames))
    (calls_off, frames_off), (calls_on, frames_on) = runs
    assert calls_on == calls_off == [(0, 0, 0.9), (1, 8, 0.8)]
    assert all(np.array_equal(a, b) for a, b in zip(frames_on, frames_off))


# -- (j) the disk build, the CLI, and what raises -----------------------------
# The disk build detects a base checkpoint by SD1.5's 768-wide cross-attention
# (both packages), so the zoo's text encoder and UNet are 768 wide
D_ZOO = 768
UNET_JSON = {"in_channels": 4, "out_channels": 4, "block_out_channels": [8, 8, 16, 16],
             "layers_per_block": 1, "attention_head_dim": 2, "cross_attention_dim": D_ZOO,
             "norm_num_groups": 4}
PLUS_ZOO = {**PLUS, "output_dim": D_ZOO}
TINY_VAE = {"block_out_channels": [8, 16, 16, 16], "norm_num_groups": 4,
            "scaling_factor": 0.18215}
V2 = "configs/inference/inference-v2.yaml"
ENCODER_JSON = {"hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
                "intermediate_size": 32, "image_size": 224, "patch_size": 32,
                "projection_dim": 12, "hidden_act": "gelu"}


def _seed_(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim >= 2:
                p.copy_(torch.randn(p.shape, generator=g) / np.sqrt(p[0].numel()))
            elif name.endswith("bias"):
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
            else:
                p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=g))
    return module.eval()


def _component(d: Path, config: dict, sd: dict, fname: str) -> None:
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(config))
    save_file({k: v.contiguous() for k, v in sd.items()}, str(d / fname))


def _checkpoint(path: Path, proj: torch.nn.Module, ip_sd: dict) -> Path:
    """An upstream-layout `.bin`: {"image_proj": ..., "ip_adapter": ...}."""
    torch.save({"image_proj": proj.state_dict(),
                "ip_adapter": {k: torch.from_numpy(v) for k, v in ip_sd.items()}}, path)
    return path


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    """A tiny SD snapshot with a v2 motion checkpoint, an HF image-encoder
    folder (config.json + model.safetensors, `vision_model.` keys), base-
    and plus-layout adapter checkpoints, and PNG frames."""
    root = tmp_path_factory.mktemp("ip_zoo")
    snap = root / "snapshot"
    tok = CLIPTokenizer.tiny()
    (snap / "tokenizer").mkdir(parents=True)
    (snap / "tokenizer" / "vocab.json").write_text(json.dumps(tok.vocab))
    (snap / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    ccfg = CLIPTextConfig(vocab_size=len(tok.vocab), hidden_size=D_ZOO, num_layers=1,
                          num_heads=12, intermediate_size=32, eos_token_id=tok.eos_token_id)
    clip = _seed_(CLIPTextModel(ccfg), 1)
    _component(snap / "text_encoder", {
        "vocab_size": ccfg.vocab_size, "hidden_size": D_ZOO, "num_hidden_layers": 1,
        "num_attention_heads": 12, "intermediate_size": 32, "eos_token_id": ccfg.eos_token_id},
        clip.state_dict(), "model.safetensors")
    vae = _seed_(AutoencoderKL(block_out_channels=TINY_VAE["block_out_channels"], groups=4), 2)
    _component(snap / "vae", TINY_VAE, vae.state_dict(), "diffusion_pytorch_model.safetensors")
    ucfg = UNet3DConfig.from_arch(ArchConfig.from_yaml(V2), UNET_JSON)
    unet = _seed_(UNet3DConditionModel(ucfg), 3)
    usd = unet.state_dict()
    _component(snap / "unet", UNET_JSON, {k: v for k, v in usd.items() if "motion" not in k},
               "diffusion_pytorch_model.safetensors")
    torch.save({k: v for k, v in usd.items() if "motion" in k}, root / "mm.ckpt")

    vision = _seed_(CLIPVisionModelWithProjection(CLIPVisionConfig(**VISION)), 4)
    _component(root / "image_encoder", ENCODER_JSON, vision.state_dict(), "model.safetensors")
    ip_sd = _ip_checkpoint(ucfg, 5)
    base = _checkpoint(root / "ip-adapter_sd15.bin", _seed_(tip.ImageProjModel(D_ZOO, 12, 4), 6),
                       ip_sd)
    plus = _checkpoint(root / "ip-adapter-plus_sd15.bin", _seed_(tip.Resampler(**PLUS_ZOO), 7),
                       ip_sd)
    frames = root / "frames"
    frames.mkdir()
    for i, f in enumerate(_video(8, 6)):
        Image.fromarray(f).save(frames / f"{i:04d}.png")
    return {"root": root, "snapshot": snap, "unet": unet, "vae": vae, "clip": clip,
            "vision": vision, "base": base, "plus": plus, "ip_sd": ip_sd}


def _cfg(zoo, **kw) -> dict:
    root = zoo["root"]
    base = dict(use_lcm=True, pretrained_lcm_model_path=str(zoo["snapshot"]),
                inference_config_path=V2, motion_module=str(root / "mm.ckpt"),
                textual_inversion_paths=(), width=64, height=64, frame_count=4,
                overlap_length=2, steps=2, strength=0.9, overlap_strength=0.85,
                lcm_origin_steps=8, guidance_scale=7.5, dtype="float32", seed=5,
                prompt="a (red fox)+", n_prompt="blurry", ffmpeg_path="ffmpeg-absent-here",
                output_video_dir=str(root / "out"), use_ipadapter=True, ipa_scale=0.65,
                ipadapter_image_encoder_path=str(root / "image_encoder"),
                ipadapter_ckpt_path=str(zoo["base"]))
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def jax_template_from_shapes():
    """The JAX build's UNet template from shapes alone, not an init compiled
    op by op (as tests/test_torch_facade_from_disk.py does), traced once for
    the zoo's UNet: the files hold every key, so no template value reaches
    the parameters."""
    init = jfacade.ControlAnimatePipeline._init_unet_params
    shapes = {}

    def template(unet, ucfg):
        if ucfg not in shapes:
            shapes[ucfg] = jax.eval_shape(lambda: init(unet, ucfg))
        return jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes[ucfg])

    with pytest.MonkeyPatch.context() as m:
        m.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(template))
        yield


@pytest.mark.parametrize("kind", ["base", "plus"])
def test_disk_build_equals_the_jax_build(zoo, kind, no_ipp, jax_template_from_shapes):
    """The adapter's files built by the JAX facade and by the port's: the
    UNet (4 image tokens, the checkpoint's K/V in every cross-attention),
    the tower and the projection equal `weights/from_jax.py` applied to the
    JAX trees, and the first anchor's tokens agree within 1e-4."""
    kw = _cfg(zoo, ipadapter_ckpt_path=str(zoo[kind]))
    jpipe = jfacade.ControlAnimatePipeline(JaxRunConfig(**kw))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    jad, tad = jpipe.ip_adapter, tpipe.ip_adapter
    assert (tad.num_tokens, tad.embed_source, tad.variant) == (
        jad.num_tokens, jad.embed_source, jad.variant)
    ucfg = tpipe.models.unet.config
    assert ucfg.ip_tokens == jpipe.models.unet.config.ip_tokens == 4
    assert ucfg.cross_attention_dim == D_ZOO
    for mine, theirs in (
            (tpipe.models.unet.state_dict(),
             from_jax.unet_state_dict(jax.device_get(jpipe.models.unet_params), ucfg)),
            (tad.vision_model.state_dict(), from_jax.clip_vision_state_dict(
                jax.device_get(jad.vision_params), tad.vision_model.config)),
            (tad.proj_model.state_dict(), from_jax.image_proj_state_dict(
                jax.device_get(jad.proj_params), PLUS_ZOO["depth"] if kind == "plus" else 0))):
        assert set(mine) == set(theirs)
        for k, v in theirs.items():
            assert torch.equal(mine[k], v), k
    key = "mid_block.attentions.0.transformer_blocks.0.attn2.to_v_ip.weight"
    last = 2 * len(tip.attn2_paths_in_checkpoint_order(ucfg)) - 1
    assert torch.equal(tpipe.models.unet.state_dict()[key],
                       torch.from_numpy(zoo["ip_sd"][f"{last}.to_v_ip.weight"]))
    frame = np.asarray(Image.open(zoo["root"] / "frames" / "0000.png"))
    jad.vision_model, jad.proj_model = _Jitted(jad.vision_model), _Jitted(jad.proj_model)
    for got, want in zip(tad.embed_image(frame), jad.embed_image(frame)):
        _close(got, want)


def test_shipped_profile_settings_run_through_the_cli(zoo, tmp_path):
    """SampleConfigIPAdapter.yaml's sampler and adapter settings (use_lcm 0,
    LCMScheduler, 12 steps, CFG 1.35, guess mode, ipa_scale 0.65,
    do_initial_generation, overlap_strength 0.92) at tiny geometry on the
    zoo, through the CLI: every frame equal to `vid2vid` with the injected
    pipeline of the same weights and the adapter built from the same
    files."""
    shipped = RunConfig.from_yaml("configs/prompts/SampleConfigIPAdapter.yaml")
    keep = ("use_lcm", "scheduler", "steps", "guidance_scale", "strength", "overlap_strength",
            "guess_mode", "use_ipadapter", "ipa_scale", "do_initial_generation")
    settings = {k: getattr(shipped, k) for k in keep}
    assert settings == dict(use_lcm=False, scheduler="LCMScheduler", steps=12,
                            guidance_scale=1.35, strength=1.0, overlap_strength=0.92,
                            guess_mode=True, use_ipadapter=True, ipa_scale=0.65,
                            do_initial_generation=True)
    profile = _cfg(zoo, **settings, lcm_origin_steps=shipped.lcm_origin_steps,
                   pretrained_model_path=str(zoo["snapshot"]),
                   input_video_path=str(zoo["root"] / "frames"),
                   output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[])
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                    for k, v in profile.items()}))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 6 and summary["windows"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]

    cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
    adapter = tip.IPAdapter.from_config(cfg, "cpu", torch.float32)
    ucfg = dataclasses.replace(zoo["unet"].config, ip_tokens=4)
    unet = UNet3DConditionModel(ucfg).eval()
    unet.load_state_dict({**zoo["unet"].state_dict(), **adapter.unet_weights(ucfg)})
    injected = tfacade.ControlAnimatePipeline(
        cfg, models=tengine.EngineModels(unet=unet, vae=zoo["vae"]),
        text_stack=tfacade.TextStack(
            CLIPTokenizer.from_pretrained(zoo["snapshot"] / "tokenizer"), zoo["clip"]),
        ip_adapter=adapter, arch=ArchConfig.from_yaml(V2), device="cpu")
    sink = tmedia.ArrayFrameSink()
    want = tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    assert want["frames_written"] == len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)


def _xl_checkpoint(root: Path, kind: str) -> Path:
    torch.manual_seed(0)
    proj = (_torch_image_proj(2048, 12, 4) if kind == "xl" else
            _torch_resampler(dim=64, depth=1, dim_head=64, heads=1, num_queries=4,
                             embedding_dim=16, output_dim=2048))
    return _checkpoint(root / f"ip-adapter-{kind}.bin", proj, {})


@pytest.mark.parametrize("kind", ["xl", "plus-xl"])
def test_sdxl_checkpoints_raise(zoo, kind, tmp_path):
    """As the JAX facade: the SDXL-family variants need an SDXL UNet."""
    kw = _cfg(zoo, ipadapter_ckpt_path=str(_xl_checkpoint(tmp_path, kind)))
    for make in (lambda: jfacade.ControlAnimatePipeline(JaxRunConfig(**kw)),
                 lambda: tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")):
        with pytest.raises(NotImplementedError, match=kind):
            make()


def test_missing_adapter_files_raise(zoo, tmp_path):
    """A missing checkpoint raises FileNotFoundError in both packages; so
    does an encoder folder without config.json in the port (JAX builds the
    ViT-H/14 defaults), and a checkpoint without one attn2's K/V raises
    ValueError naming it (JAX leaves it at its random init)."""
    absent = str(tmp_path / "absent.bin")
    kw = _cfg(zoo, ipadapter_ckpt_path=absent)
    for make in (lambda: jfacade.ControlAnimatePipeline(JaxRunConfig(**kw)),
                 lambda: tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")):
        with pytest.raises(FileNotFoundError, match="absent.bin"):
            make()
    bare = tmp_path / "encoder"
    bare.mkdir()
    (bare / "model.safetensors").write_bytes(
        (zoo["root"] / "image_encoder" / "model.safetensors").read_bytes())
    with pytest.raises(FileNotFoundError, match="config.json"):
        tfacade.ControlAnimatePipeline(RunConfig(**_cfg(
            zoo, ipadapter_image_encoder_path=str(bare))), device="cpu")
    partial = {k: v for k, v in zoo["ip_sd"].items() if not k.startswith("3.")}
    ckpt = _checkpoint(tmp_path / "partial.bin", tip.ImageProjModel(D_ZOO, 12, 4), partial)
    second = tip.attn2_paths_in_checkpoint_order(zoo["unet"].config)[1]
    with pytest.raises(ValueError, match=second):
        tfacade.ControlAnimatePipeline(RunConfig(**_cfg(zoo, ipadapter_ckpt_path=str(ckpt))),
                                       device="cpu")
