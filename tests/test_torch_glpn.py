"""The GLPN depth annotator against the JAX package on the CPU.

At JAX's tiny transformers config (`tests/test_annotators.py`
`test_glpn_matches_transformers`: hidden 8/16/24/32, depths 1, sr
4/2/2/1, heads 1/2/3/4, MLP ratio 2, decoder 16; head dim 8, so the
attention takes K1's plain version on the CPU), on a seeded folder
(`annotators/seeded.py` `glpn_checkpoint`: config.json and
model.safetensors, the head calibrated on frames of the tests' kind):
the decoder's 2x resize against `jax.image.resize` at sides 1, 2 and odd
ones, edge rows included; `EfficientAttention` (sr > 1 and sr = 1),
`MixFFN`, `SelectiveFeatureFusion` (its BatchNorms folded) and the network
against the JAX modules on the weights `from_jax.glpn_state_dict` carries
back from the JAX loader's tree, within 1e-4 of the largest value (the
key table round-trips the file exactly); the annotator against JAX
`glpn.run_flax` on the same folder at 64x96 and 70x100 (snapped to 64x96)
with cv2's IPP off, within 1e-4 and 1 LSB once quantised; the refusals
(config values JAX never reads off its constants, a width its heads do
not divide, a missing weight, a head dim K1 does not take on the card's
path); a segment run's S*F stack, CHUNK frames a call; and a depth
ControlNet read from disk with a GLPN folder through
the facade against the JAX facade's. The port runs on one torch thread;
the JAX network compiles once for the network and annotator tests (both
at 2 frames of 64x96).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.annotators import glpn as jax_glpn
from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu.weights import ingest as jax_ingest
from controlanimate_tpu.weights.controlnet_weights import controlnet_params_from_torch
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import depth, glpn, seeded
from controlanimate_tpu_torch.models.annotators.dpt import HalfPixelUp2x
from controlanimate_tpu_torch.models.controlnet import ControlNetModel, controlnet_config_from_json
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import JaxDraws
from test_torch_depth import _close_to_largest, _frames, _nhwc, _q, opencv_path  # noqa: F401
from test_torch_facade_from_disk import (CN_JSON, D_CTX, REPO, SIZE, V1, _cfg,  # noqa: F401
                                         _save_component, _seed_, zoo)

TINY = glpn.GLPNConfig(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1), sr_ratios=(4, 2, 2, 1),
                       heads=(1, 2, 3, 4), mlp_ratios=(2, 2, 2, 2), decoder_hidden=16)
NAME = "lllyasviel/control_v11f1p_sd15_depth"
HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A seeded tiny GLPN folder, the JAX loader's tree of it and the JAX
    network jitted by `run_flax` (its cache, so the annotator tests share
    the compile), and the port's network on the tree's weights."""
    folder = tmp_path_factory.mktemp("glpn") / "depth"
    frames = torch.from_numpy(_frames(np.random.RandomState(1), HW, 4))
    config, sd = seeded.glpn_checkpoint(torch.Generator().manual_seed(3), frames, TINY)
    seeded.write_depth_folder(folder, config, sd)
    jax_glpn._CACHE.pop(str(folder), None)
    jax_glpn.run_flax(np.zeros((2, *HW, 3), np.uint8), folder)
    fn, params = jax_glpn._CACHE[str(folder)]
    params = jax.device_get(params)
    net = depth.depth_network(config, from_jax.glpn_state_dict(params, TINY), "cpu")
    return {"dir": folder, "config": config, "sd": sd, "fn": fn, "params": params, "net": net}


def _tokens(rng, B, H, W, C) -> np.ndarray:
    return rng.randn(B, H * W, C).astype(np.float32)


# -- the parts --------------------------------------------------------------------
@pytest.mark.parametrize("hw", [(1, 1), (2, 2), (1, 5), (3, 7), (8, 12)])
def test_up2_matches_jax(hw):
    """The decoder's 2x resize (`F.interpolate`, half-pixel centres) against
    JAX `_up2` (`jax.image.resize` bilinear), the edge rows and columns
    too: within 1e-6 of the largest value."""
    x = torch.from_numpy(np.random.RandomState(sum(hw)).randn(2, 3, *hw).astype(np.float32))
    got = HalfPixelUp2x()(x).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_glpn._up2(_nhwc(x)))
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=tol, rtol=0)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=tol, rtol=0)


@pytest.mark.parametrize("stage", [0, 3], ids=["sr4", "sr1"])
def test_efficient_attention_matches_jax(tiny, stage):
    """Stage 0's attention (keys and values from a 4x4 stride-4 conv, Nk =
    Nq / 16) and stage 3's (sr 1, Nk = Nq) on the carried weights, at the
    stage's 16x24 and 2x3 grids: within 1e-4 of the largest value."""
    H, W = (16, 24) if stage == 0 else (2, 3)
    C = TINY.hidden_sizes[stage]
    x = _tokens(np.random.RandomState(stage), 2, H, W, C)
    attn = tiny["net"].glpn.encoder.block[stage][0].attention
    with torch.no_grad():
        got = attn(torch.from_numpy(x), H, W).numpy()
    module = jax_glpn.EfficientAttention(TINY.heads[stage], TINY.sr_ratios[stage], TINY.ln_eps)
    want = module.apply({"params": tiny["params"][f"block_{stage}_0"]["attention"]},
                        jnp.asarray(x), H, W)
    _close_to_largest(got, np.asarray(want))


def test_mixffn_matches_jax(tiny):
    """Stage 1's MixFFN (dense, 3x3 depthwise conv, exact GELU, dense) at
    its 8x12 grid: within 1e-4 of the largest value."""
    H, W, C = 8, 12, TINY.hidden_sizes[1]
    x = _tokens(np.random.RandomState(5), 2, H, W, C)
    with torch.no_grad():
        got = tiny["net"].glpn.encoder.block[1][0].mlp(torch.from_numpy(x), H, W).numpy()
    module = jax_glpn.MixFFN(int(C * TINY.mlp_ratios[1]))
    want = module.apply({"params": tiny["params"]["block_1_0"]["mlp"]}, jnp.asarray(x), H, W)
    _close_to_largest(got, np.asarray(want))


@pytest.mark.parametrize("si", [1, 3])
def test_fusion_matches_jax(tiny, si):
    """A decoder stage's selective feature fusion, its BatchNorms folded into
    the convs at load, against JAX's, which applies them at run time (the
    seeded statistics: means N(0, 0.05^2), variances U(0.75, 1.25)): within
    1e-4 of the largest value."""
    rng = np.random.RandomState(si)
    c = TINY.decoder_hidden
    local, glob = (rng.randn(2, 6, 10, c).astype(np.float32) for _ in range(2))
    fusion = tiny["net"].decoder.stages[si].fusion
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in fusion.modules())
    with torch.no_grad():
        got = fusion(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (local, glob)))
    want = jax_glpn.SelectiveFeatureFusion(c).apply(
        {"params": tiny["params"][f"dec_fusion_{si}"]}, jnp.asarray(local), jnp.asarray(glob))
    _close_to_largest(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_network_matches_jax(tiny, monkeypatch):
    """The port's network on the carried weights against JAX's jitted
    network, at the annotator's 2 x 64x96 input: within 1e-4 of the largest
    value. Every stage's attention went through `flash_attention` (its
    plain version here), as (Nq, H, Nk)."""
    from controlanimate_tpu_torch.ops import flash_attention as fa

    x = depth.glpn_input(torch.from_numpy(_frames(np.random.RandomState(4), HW)))
    calls, plain = [], fa.flash_attention_plain

    def counted(q, k, v, scale=None):
        calls.append((q.shape[1], q.shape[2], k.shape[1]))
        return plain(q, k, v, scale)

    monkeypatch.setattr(fa, "flash_attention_plain", counted)
    with torch.no_grad():
        mine = tiny["net"](x).numpy()
    assert mine.shape == (2, *HW)
    assert calls == [(384, 1, 24), (96, 2, 24), (24, 3, 6), (6, 4, 6)]
    _close_to_largest(mine, np.asarray(tiny["fn"](tiny["params"], _nhwc(x))))


def test_key_table_round_trips_the_checkpoint(tiny):
    """`glpn_state_dict` of the JAX loader's tree is the seeded checkpoint
    key for key and value for value, but for the BatchNorms'
    `num_batches_tracked`, which JAX never reads and the port does not
    need."""
    sd = tiny["sd"]
    carried = from_jax.glpn_state_dict(tiny["params"], TINY)
    assert set(sd) - set(carried) == {k for k in sd if k.endswith("num_batches_tracked")}
    for k, v in carried.items():
        assert torch.equal(v, sd[k]), k


# -- the annotator -----------------------------------------------------------------
@pytest.mark.parametrize("hw", [HW, (70, 100)])
def test_annotator_matches_jax(tiny, hw, monkeypatch, opencv_path):
    """The annotator the depth ControlNet's name selects, read from the
    folder CONTROLANIMATE_DEPTH_MODEL names, against `glpn.run_flax` on it,
    at a size that is a multiple of 32 and one that is snapped to it (both
    through the 64x96 network): within 1e-4, within 1 LSB after the
    quantisation, in [0, 1] and not constant."""
    monkeypatch.setenv(depth.MODEL_ENV, str(tiny["dir"]))
    frames = _frames(np.random.RandomState(sum(hw)), hw)
    want = jax_glpn.run_flax(frames, tiny["dir"])
    ann = annotators.resolve_annotator(NAME, "cpu")
    assert isinstance(ann.model, glpn.GLPNDepth)
    mine = ann(torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, *hw, 3) and mine.dtype == np.float32
    assert mine.min() == 0.0 and mine.max() == 1.0 and mine[..., 0].std() > 0.05
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    assert np.abs(_q(mine) - _q(want)).max() <= 1


@pytest.mark.parametrize("change,match", [
    ({"hidden_act": "relu"}, "hidden_act"),
    ({"head_in_index": 0}, "head_in_index"),
    ({"num_encoder_blocks": 3}, "num_encoder_blocks"),
    ({"num_channels": 1}, "num_channels"),
    ({"num_attention_heads": [1, 2, 5, 4]}, "stage 2: its width 24"),
    ({"depths": [1, 1, 1]}, "depths is \\[1, 1, 1\\], not a list of one value for each of "
                            "its 4"),
    ({"hidden_sizes": 8}, "hidden_sizes is 8"),
])
def test_config_refusals(tiny, change, match, tmp_path):
    """A GLPN config whose value of a key JAX never reads is not the
    constant its network assumes, whose width its heads do not divide, or
    whose stage keys are not lists of one value a stage, raises ValueError
    naming it, before any weight is read."""
    folder = tmp_path / "depth"
    folder.mkdir()
    (folder / "config.json").write_text(json.dumps({**tiny["config"], **change}))
    with pytest.raises(ValueError, match=match):
        depth.DepthAnnotator.from_dir(folder, "cpu")


def test_missing_weight_raises(tiny, tmp_path):
    """A folder that lacks a weight raises KeyError naming it, where JAX's
    `depth.run` goes on to a host transformers model; a folder without
    `num_batches_tracked` reads as one with it."""
    key = "glpn.encoder.block.2.0.attention.self.sr.weight"
    sd = {k: v for k, v in tiny["sd"].items() if k != key}
    seeded.write_depth_folder(tmp_path / "missing", tiny["config"], sd)
    with pytest.raises(KeyError, match=key):
        depth.DepthAnnotator.from_dir(tmp_path / "missing", "cpu")
    sd = {k: v for k, v in tiny["sd"].items() if not k.endswith("num_batches_tracked")}
    seeded.write_depth_folder(tmp_path / "counters", tiny["config"], sd)
    got = depth.DepthAnnotator.from_dir(tmp_path / "counters", "cpu").model.state_dict()
    for k, v in tiny["net"].state_dict().items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)


def test_card_path_refuses_a_head_dim_k1_lacks(tiny, tmp_path):
    """On the card (the check alone: it raises before any weight or device
    is touched), a stage whose head dim K1 does not take raises ValueError
    naming the stage, where the CPU runs the plain attention; the b4 and b0
    widths pass (head dims 64 and 32)."""
    folder = tmp_path / "depth"
    folder.mkdir()
    (folder / "config.json").write_text(json.dumps(tiny["config"]))  # no weights
    with pytest.raises(ValueError, match="GLPN stage 0: head dim 8 / 1 = 8"):
        depth.DepthAnnotator.from_dir(folder, "cuda")
    for cfg in (glpn.GLPN_B4, glpn.GLPN_B0):
        glpn.check_head_dims(cfg)
    assert {c // h for c, h in zip(glpn.GLPN_B4.hidden_sizes, glpn.GLPN_B4.heads)} == {64}
    assert {c // h for c, h in zip(glpn.GLPN_B0.hidden_sizes, glpn.GLPN_B0.heads)} == {32}


def test_segment_stack_runs_in_chunks(tiny):
    """The segment path annotates its S*F frames (here 2 * 10 of 70x100,
    snapped to 64x96) as one stack, through the network CHUNK frames at a
    time (one full chunk and a part): each segment's maps equal that
    segment annotated alone within 1e-5 (the min-max is a frame's own), and
    its quantised maps within 1 LSB."""
    from types import SimpleNamespace

    ann = depth.DepthAnnotator(tiny["net"])
    S, F, hw = 2, 10, (70, 100)
    assert depth.CHUNK < S * F < 2 * depth.CHUNK
    stub = SimpleNamespace(
        models=SimpleNamespace(controlnets=[None], annotators=[ann]),
        config=SimpleNamespace(controlnets=(NAME,), save_frames=False),
        _to_device=torch.as_tensor)
    frames = _frames(np.random.RandomState(11), hw, S * F).reshape(S, F, *hw, 3)
    (maps,) = tfacade.ControlAnimatePipeline.prepare_cond_images(stub, frames)
    assert maps.shape == (S, F, *hw, 3) and maps.dtype == torch.uint8
    stacked = ann(torch.from_numpy(frames.reshape(S * F, *hw, 3)))
    for s in range(S):
        alone = ann(torch.from_numpy(frames[s]))
        torch.testing.assert_close(stacked[s * F:(s + 1) * F], alone, atol=1e-5, rtol=0)
        assert int((maps[s].int() - (alone * 255.0 + 0.5).to(torch.uint8).int()).abs().max()) <= 1


# -- a depth ControlNet from disk --------------------------------------------------
def test_glpn_depth_controlnet_from_disk_matches_jax(zoo, tmp_path, monkeypatch, opencv_path):
    """The port's build from disk with the depth ControlNet (under
    models/ControlNet/) and a GLPN folder at the default path from the
    working directory, its head calibrated on the zoo's frames, against the
    JAX facade with the same UNet, VAE, text stack and ControlNet from the
    same files, whose `depth.run` reaches `glpn.run_flax`: condition maps
    within 1 LSB and not flat, and a window within 1 LSB, which the
    ControlNet changed."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(depth.MODEL_ENV, raising=False)
    monkeypatch.setattr(jax_glpn, "_CACHE", {})
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    _save_component(tmp_path / "models" / "ControlNet", NAME.split("/")[-1], cn_json,
                    _seed_(ControlNetModel(cfg, cond), 17).state_dict(),
                    "diffusion_pytorch_model.safetensors")
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((zoo["root"] / "frames").glob("*.png"))])[:4]
    config, sd = seeded.glpn_checkpoint(torch.Generator().manual_seed(8),
                                        torch.from_numpy(frames), TINY)
    seeded.write_depth_folder(tmp_path / depth.DEFAULT_MODEL, config, sd)
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _cfg(zoo, controlnets=(NAME,), cond_scale=(1.0,), inference_config_path=str(REPO / V1))
    require_ported(RunConfig(**kw))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    assert isinstance(tpipe.models.annotators[0].model, glpn.GLPNDepth)
    jbase = jfacade.ControlAnimatePipeline(JaxRunConfig(**{**kw, "controlnets": (),
                                                           "cond_scale": ()}))
    jcfg = JaxUNetConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                         attention_heads=2, cross_attention_dim=D_CTX, norm_num_groups=4,
                         use_motion_module=False)
    jparams = [controlnet_params_from_torch(jax_ingest.load_hf_component(
        Path("models/ControlNet") / NAME.split("/")[-1], "")[1], jcfg)]
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**kw), text_stack=jbase.text, models=dataclasses.replace(
            jbase.models, controlnets=[JaxControlNet(jcfg)], controlnet_params=jparams,
            cond_scales=[1.0]))
    (map_t,) = [m.numpy().astype(int) for m in tpipe.prepare_cond_images(frames)]
    (map_j,) = [np.asarray(m).astype(int) for m in jpipe.prepare_cond_images(frames)]
    assert map_t.shape == map_j.shape == (1, 4, SIZE, SIZE, 3)
    assert np.abs(map_t - map_j).max() <= 1 and map_t.std() > 5
    out_j = jpipe.animate(frames, None, seed=5)
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1
    plain = tfacade.ControlAnimatePipeline(
        RunConfig(**{**kw, "controlnets": (), "cond_scale": ()}), device="cpu")
    out_plain = plain.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert not torch.equal(out_plain, out_t)
