"""The UNet's attention variants against the JAX package on the CPU (fp32,
one torch thread): banded frame attention in the motion modules (and K3
kept off where a band is active), sparse-causal cross-frame self-attention
(K/V from frame 0 and the frame before) and the frame-axis temporal
sub-layer, at the geometry of tests/test_banded_motion.py and
tests/test_unet3d.py; then a tiny window built from disk with both flags in
the inference yaml and `temporal_band` in the run, equal to the JAX
facade's within 1 LSB, and the refusals. The whole UNet with each variant
is in tests/test_torch_unet3d.py `test_unet_matches_jax`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models import motion_module as jmm
from controlanimate_tpu.models import transformer as jt
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, MotionModuleConfig, RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models import layers as tl
from controlanimate_tpu_torch.models import motion_module as tmm
from controlanimate_tpu_torch.models import transformer as tt
from controlanimate_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from controlanimate_tpu_torch.models.vae import AutoencoderKL
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import CLIP, LCM_MOTION, LCM_UNET, VAE_CH, VAE_GROUPS, JaxDraws
from test_torch_facade_from_disk import (D_CTX, SIZE, TINY_VAE, UNET_JSON, V2, _save_component,
                                         _seed_)
from test_torch_layers import _close, _np, _pair


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


# -- banded frame attention ------------------------------------------------------
@pytest.mark.parametrize("band", [1, 2, 4, 5, 7])
def test_banded_frame_attention_matches_jax(band):
    """F = 6: bands 1, 2 and 4 are active (JAX `_banded_frame_attention`),
    5 and 7 are >= F - 1, exact dense attention, equal to the port's band 0."""
    x = _np(2, 6, 5, 16)
    jm = jmm.TemporalEinsumAttention(heads=2, band=band)
    tm = tmm.TemporalEinsumAttention(16, 2, band)
    f = _pair(jm, tm, from_jax._attn("", ""), jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        _close(out, f(jnp.asarray(x)))
        dense = tmm.TemporalEinsumAttention(16, 2)
        dense.load_state_dict(tm.state_dict())
        if band >= 5:
            _close(out, dense(torch.from_numpy(x)).numpy())
        else:
            assert (out - dense(torch.from_numpy(x))).abs().max() > 1e-3


def test_active_band_keeps_the_motion_kernel_off(monkeypatch):
    """K3 computes dense frame attention: a module with K3 on takes the dense
    path where its band is active at the call's F, and K3 where it is not
    (band >= F - 1), as JAX `MotionModule` dispatches; the banded module
    equals JAX's."""
    x = _np(1, 4, 2, 2, 32)
    jm = jmm.MotionModule(heads=4, max_len=8, groups=8, band=1)
    tm = tmm.MotionModule(32, heads=4, max_len=8, groups=8, band=1)
    f = _pair(jm, tm, from_jax._motion("", "", UNet3DConfig()), jnp.asarray(x))
    tm.use_motion_kernel = True
    fused = []
    monkeypatch.setattr(tm.temporal_transformer, "forward_fused",
                        lambda h4: fused.append(h4.shape[1]) or tm.temporal_transformer(h4))
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), f(jnp.asarray(x)))  # F = 4: band 1 active
        tm(torch.from_numpy(x[:, :2]))  # F = 2: band 1 >= F - 1
    assert fused == [2]


# -- sparse-causal attention and the temporal sub-layer -------------------------
def test_sparse_causal_kv_matches_jax():
    h = _np(2 * 5, 6, 16)
    want = np.asarray(jt.sparse_causal_kv(jnp.asarray(h), 5))
    got = tl.sparse_causal_kv(torch.from_numpy(h), 5).numpy()
    np.testing.assert_array_equal(got, want)
    h4 = h.reshape(2, 5, 6, 16)
    np.testing.assert_array_equal(got.reshape(2, 5, 12, 16)[:, 0], np.concatenate(
        [h4[:, 0], h4[:, 0]], axis=1))  # frame 0 sees itself twice


def _block_entries(temporal: bool):
    entries = [*from_jax._attn(".attn1", "attn1"), *from_jax._attn(".attn2", "attn2"),
               *from_jax._ff(".ff", "ff")]
    for n in ("norm1", "norm2", "norm3"):
        entries += from_jax._norm(f".{n}", n)
    if temporal:
        entries += [*from_jax._attn(".attn_temp", "attn_temp"),
                    *from_jax._norm(".norm_temp", "norm_temp")]
    return entries


@pytest.mark.parametrize("cross_frame,temporal", [(True, False), (False, True), (True, True)])
def test_block_variants_match_jax(cross_frame, temporal):
    """`BasicTransformerBlock` with each variant at JAX's `_sc_blocks`
    geometry (2 heads of 8, a 24-wide context; B = 2, F = 5, N = 6), the
    sparse-causal K/V projected before the gather here and after it in
    JAX, within 1e-4."""
    B, F, N, C = 2, 5, 6, 16
    x, ctx = _np(B * F, N, C, scale=0.5), _np(B * F, 7, 24, seed=2, scale=0.5)
    jm = jt.BasicTransformerBlock(heads=2, dim_head=8, cross_attention_dim=24,
                                  cross_frame=cross_frame, temporal_attention=temporal)
    tm = tt.BasicTransformerBlock(C, 2, 8, 24, cross_frame=cross_frame,
                                  temporal_attention=temporal)
    f = _pair(jm, tm, _block_entries(temporal), jnp.asarray(x), jnp.asarray(ctx), frames=F)
    with torch.no_grad():
        out = tm(torch.from_numpy(x), torch.from_numpy(ctx), frames=F)
    _close(out, f(jnp.asarray(x), jnp.asarray(ctx), frames=F), atol=1e-4, rtol=1e-4)


def test_fresh_temporal_sub_layer_is_the_identity():
    """`attn_temp`'s out projection starts at zero, as JAX's
    (`out_zero_init`): a fresh block with the sub-layer equals one without."""
    torch.manual_seed(0)
    plain = tt.BasicTransformerBlock(16, 2, 8, 24)
    temp = tt.BasicTransformerBlock(16, 2, 8, 24, temporal_attention=True)
    temp.load_state_dict(plain.state_dict(), strict=False)
    x, ctx = torch.randn(6, 4, 16), torch.randn(6, 7, 24)
    with torch.no_grad():
        torch.testing.assert_close(temp(x, ctx, frames=3), plain(x, ctx, frames=3))


# -- a window built from disk, and the refusals ---------------------------------
@pytest.fixture(scope="module")
def variant_zoo(tmp_path_factory):
    """A tiny snapshot whose inference yaml sets both UNet flags: its 2D
    unet file without `attn_temp` / `norm_temp`, which the motion file
    carries (JAX reads them from the 2D file, else the motion file); the
    same snapshot with a motion file that lacks them; and frames."""
    root = tmp_path_factory.mktemp("variants")
    snap = root / "snapshot"
    tok = CLIPTokenizer.tiny()
    (snap / "tokenizer").mkdir(parents=True)
    (snap / "tokenizer" / "vocab.json").write_text(json.dumps(tok.vocab))
    (snap / "tokenizer" / "merges.txt").write_text("#version: 0.2\n")
    ccfg = CLIPTextConfig(vocab_size=len(tok.vocab), hidden_size=D_CTX, num_layers=2,
                          num_heads=2, intermediate_size=32, eos_token_id=tok.eos_token_id)
    clip = _seed_(CLIPTextModel(ccfg), 61)
    _save_component(snap, "text_encoder", {
        "vocab_size": ccfg.vocab_size, "hidden_size": D_CTX, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 32, "max_position_embeddings": 77,
        "eos_token_id": ccfg.eos_token_id},
        {**clip.state_dict(), "text_model.embeddings.position_ids": torch.arange(77)[None]},
        "model.safetensors")
    vae = _seed_(AutoencoderKL(block_out_channels=TINY_VAE["block_out_channels"], groups=4), 62)
    _save_component(snap, "vae", TINY_VAE, vae.state_dict(), "diffusion_pytorch_model.safetensors")

    with open(V2) as f:
        arch = yaml.safe_load(f)
    arch["unet_additional_kwargs"].update(unet_use_cross_frame_attention=True,
                                          unet_use_temporal_attention=True)
    (root / "inference.yaml").write_text(yaml.safe_dump(arch))
    ucfg = UNet3DConfig.from_arch(ArchConfig.from_yaml(root / "inference.yaml"), UNET_JSON)
    assert ucfg.cross_frame_attention and ucfg.temporal_attention
    unet = _seed_(UNet3DConditionModel(ucfg), 63)  # attn_temp's out projection seeded too
    usd = unet.state_dict()

    def is_motion(k):
        return "motion_modules" in k or "_temp." in k

    _save_component(snap, "unet", UNET_JSON, {k: v for k, v in usd.items() if not is_motion(k)},
                    "diffusion_pytorch_model.safetensors")
    torch.save({k: v for k, v in usd.items() if is_motion(k)}, root / "mm.ckpt")
    torch.save({k: v for k, v in usd.items() if "motion_modules" in k}, root / "mm_no_temp.ckpt")
    rng = np.random.RandomState(64)
    frames = rng.randint(0, 255, (4, SIZE, SIZE, 3), dtype=np.uint8)
    return {"root": root, "snapshot": snap, "frames": frames}


def _variant_cfg(zoo, **kw) -> dict:
    root = zoo["root"]
    return {**dict(
        use_lcm=True, pretrained_lcm_model_path=str(zoo["snapshot"]),
        inference_config_path=str(root / "inference.yaml"), motion_module=str(root / "mm.ckpt"),
        textual_inversion_paths=(), width=SIZE, height=SIZE, frame_count=4, overlap_length=2,
        steps=2, strength=0.9, lcm_origin_steps=8, guidance_scale=7.5, dtype="float32", seed=5,
        prompt="a (red fox)+", n_prompt="blurry", temporal_band=1,
        output_video_dir=str(root / "out")), **kw}


def test_variant_window_from_disk_matches_jax(variant_zoo, monkeypatch):
    """Both flags from the inference yaml, `temporal_band: 1` from the run (4
    frames: active): the port's disk build reads `attn_temp` from the motion
    file and runs a window equal to the JAX facade's within 1 LSB, the
    run's band in both UNets' motion modules."""
    # the JAX build's UNet template from shapes alone, not an init compiled
    # op by op: the files hold every key (the port's build raises otherwise),
    # so no template value reaches the parameters
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _variant_cfg(variant_zoo)
    jpipe = jfacade.ControlAnimatePipeline(JaxRunConfig(**kw))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    ucfg = tpipe.models.unet.config
    assert ucfg.cross_frame_attention and ucfg.temporal_attention
    assert ucfg.motion.attention_band == jpipe.models.unet.config.motion.attention_band == 1
    frames = variant_zoo["frames"]
    out_j = np.asarray(jpipe.animate(frames, None, seed=5))
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5))).numpy()
    assert np.abs(out_t.astype(int) - out_j.astype(int)).max() <= 1
    assert all(m.band == 1 for m in tpipe.models.unet.modules() if isinstance(m, tmm.MotionModule))


def test_variant_cli_segments_match_the_sequential_loop(variant_zoo, tmp_path):
    """The CLI (in-process) on a profile naming the variant snapshot, with
    `temporal_band: 1` and `parallel_segments: 2` over 8 PNG frames: each
    4-frame segment, batched with the other through the UNet's sparse-causal
    attention and sub-layer, equals the sequential loop on that segment's
    frames alone (same seed) within 1 LSB."""
    frames_dir = tmp_path / "frames"
    frames_dir.mkdir()
    rng = np.random.RandomState(65)
    frames = rng.randint(0, 255, (8, SIZE, SIZE, 3), dtype=np.uint8)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(frames_dir / f"{i:04d}.png")
    profile = _variant_cfg(variant_zoo, input_video_path=str(frames_dir), parallel_segments=2,
                           overlap_length=0, output_video_dir=str(tmp_path / "cli"),
                           textual_inversion_paths=[])
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump(profile))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 8 and summary["segments"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]
    cfg = RunConfig.from_yaml(path).replace(parallel_segments=0)
    pipe = tfacade.ControlAnimatePipeline(cfg, device="cpu")
    sequential = []
    for s in range(2):
        sink = tmedia.ArrayFrameSink()
        tv2v.vid2vid(config=cfg.replace(output_video_dir=str(tmp_path / f"seq{s}")),
                     pipeline=pipe, frame_source=tmedia.ArrayFrameSource(frames[4 * s:4 * s + 4]),
                     frame_sink=sink)
        sequential += sink.frames
    diff = np.abs(np.stack(got).astype(int) - np.stack(sequential).astype(int))
    assert diff.max() <= 1


def test_variant_settings_that_raise(variant_zoo):
    """A motion file without the sub-layer's weights raises KeyError naming
    the first missing one (JAX's `strict_2d`); an injected UNet built with
    another band than `temporal_band` raises ValueError naming the key; a
    negative band raises ValueError (JAX fails inside `jnp.stack`)."""
    no_temp = _variant_cfg(variant_zoo, motion_module=str(variant_zoo["root"] / "mm_no_temp.ckpt"))
    with pytest.raises(KeyError, match=r"attn_temp\.to_q\.weight"):
        tfacade.ControlAnimatePipeline(RunConfig(**no_temp), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        tfacade.ControlAnimatePipeline(RunConfig(**_variant_cfg(variant_zoo, temporal_band=-1)),
                                       device="cpu")
    unet = UNet3DConditionModel(UNet3DConfig(**LCM_UNET, motion=MotionModuleConfig(
        **LCM_MOTION, attention_band=2)))
    vae = AutoencoderKL(block_out_channels=VAE_CH, groups=VAE_GROUPS)
    cfg = RunConfig(use_lcm=True, temporal_band=3, output_video_dir=str(variant_zoo["root"]))
    with pytest.raises(ValueError, match="temporal_band=3"):
        tfacade.ControlAnimatePipeline(
            cfg, models=tengine.EngineModels(unet=unet, vae=vae),
            text_stack=tfacade.TextStack(CLIPTokenizer.tiny(), CLIPTextModel(CLIPTextConfig(
                **CLIP))), device="cpu")
