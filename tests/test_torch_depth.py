"""The depth annotator (DPT and DPT-hybrid) against the JAX package on the
CPU.

The resizes and the transposed convs on their own: the fusion layers'
aligned-corner 2x resize (its one-pixel case too) and `jax.image.resize`'s
half-pixel bilinear (the head's 2x, a skip or a position grid shrunk with
antialias) within 1e-6 of JAX, and `up_by_stride` within 1e-6 of
`F.conv_transpose2d`. The networks at the tiny geometries of
`tests/test_annotators.py` (patch 16, position tables for the
annotator's 384x384 input) on weights carried by `weights/from_jax.py`
against JAX `DPTDepth` and `DPTHybridDepth`: within 1e-4 of the largest
value, and a hybrid whose stored position grid is larger and smaller than
its /16 map's. The key tables round-trip the seeded checkpoints exactly.
The annotator against JAX `depth.run` on the same seeded folders (plain
and hybrid) at 64x80 and 45x61: within 1e-4 and 1 LSB, not constant. The
refusals (a missing folder, an unknown model_type, a config value JAX
never reads off its constant, a missing weight, a plain position table off
the 384 grid; a DPT folder whose config names GLPN is read as GLPN, and
nothing falls back to the DPT in it; GLPN's own tests are in
tests/test_torch_glpn.py). And the path: a depth ControlNet read from disk, its window
against the JAX facade's (the hybrid), its CLI run against the injected
pipeline, a segment run's S*F stack. JAX resizes with cv2's IPP off. The
port runs on one torch thread; each JAX network compiles once per shape,
shared by the network and annotator tests (both at 2 frames of 384x384).
"""

import dataclasses
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
import yaml
from PIL import Image

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.annotators import depth as jax_depth
from controlanimate_tpu.models.annotators import dpt as jax_dpt
from controlanimate_tpu.models.annotators import dpt_hybrid as jax_hybrid
from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu.weights import ingest as jax_ingest
from controlanimate_tpu.weights.controlnet_weights import controlnet_params_from_torch
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, RunConfig, require_ported
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import depth, dpt, seeded
from controlanimate_tpu_torch.models.annotators.dpt_hybrid import BitConfig, DPTHybridConfig
from controlanimate_tpu_torch.models.annotators.edge_nets import up_by_stride
from controlanimate_tpu_torch.models.controlnet import ControlNetModel, controlnet_config_from_json
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_annotators import _long_chains
from test_torch_common import JaxDraws
from test_torch_facade_from_disk import (CN_JSON, D_CTX, REPO, SIZE, V1, V2, _cfg,  # noqa: F401
                                         _save_component, _seed_, zoo)

# tests/test_annotators.py's tiny geometries, at patch 16 (the Intel nets')
TINY = dpt.DPTConfig(hidden_size=32, num_layers=4, heads=2, mlp_dim=64, patch=16,
                     taps=(0, 1, 2, 3), neck_hidden=(16, 16, 32, 32), fusion_hidden=32)
TINY_HYBRID = DPTHybridConfig(bit=BitConfig(embedding_size=8, hidden_sizes=(16, 24, 32),
                                            depths=(1, 1, 1), num_groups=4),
                              hidden_size=32, num_layers=4, heads=2, mlp_dim=64, patch=16,
                              taps=(0, 1, 2, 3), neck_hidden=(16, 24, 32, 32), fusion_hidden=32)
NAME = "lllyasviel/control_v11f1p_sd15_depth"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def opencv_path():
    """OpenCV's own code path (IPP off) for the duration of a test."""
    cv2.setUseOptimized(False)
    yield
    cv2.setUseOptimized(True)


def _frames(rng, hw, n: int = 2) -> np.ndarray:
    """Noise frames, then frames with long edge chains."""
    return np.concatenate([rng.randint(0, 256, (n // 2, *hw, 3), dtype=np.uint8),
                           _long_chains(rng, n - n // 2, *hw)])


def _q(m: np.ndarray) -> np.ndarray:
    """The facade's uint8 quantisation."""
    return (np.clip(m, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(int)


def _nhwc(x: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(x.permute(0, 2, 3, 1).numpy())


def _close_to_largest(mine: np.ndarray, want: np.ndarray) -> None:
    """Within 1e-4 of the largest value."""
    assert mine.shape == want.shape
    np.testing.assert_allclose(mine, want, atol=1e-4 * np.abs(want).max(), rtol=0)


# -- the resizes and the transposed convs ------------------------------------------
@pytest.mark.parametrize("hw", [(1, 1), (1, 5), (3, 5), (12, 12), (24, 17)])
def test_aligned_corner_resize_matches_jax(hw):
    """The fusion layers' 2x resize against `_resize_align_corners`,
    a one-pixel side (repeated) included."""
    x = torch.from_numpy(np.random.RandomState(sum(hw)).randn(2, 3, *hw).astype(np.float32))
    got = dpt.resize_align_corners(x, 2 * hw[0], 2 * hw[1]).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax_dpt._resize_align_corners(_nhwc(x), 2 * hw[0], 2 * hw[1]))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("hw,out", [((5, 7), (10, 14)), ((192, 192), (384, 384)),
                                    ((13, 13), (12, 12)), ((48, 48), (24, 24)),
                                    ((12, 12), (24, 24)), ((7, 9), (5, 12))])
def test_half_pixel_resize_matches_jax(hw, out):
    """`resize_half_pixel` against `jax.image.resize(..., "bilinear")`, edge
    rows and columns included: the head's 2x, and shrinking (antialiased,
    the skip's and the position grid's) and mixed cases; within 1e-6 of
    the largest value. The port's shrinking weights equal JAX's at XLA's
    default optimisation bit for bit; the suite compiles JAX at level 0
    (tests/conftest.py), where its weights move by up to 5e-7."""
    x = torch.from_numpy(np.random.RandomState(sum(hw)).randn(2, 3, *hw).astype(np.float32))
    got = dpt.resize_half_pixel(x, *out).permute(0, 2, 3, 1).numpy()
    want = np.asarray(jax.image.resize(_nhwc(x), (2, *out, 3), "bilinear"))
    tol = 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=tol, rtol=0)


@pytest.mark.parametrize("k", [4, 2])
def test_up_by_stride_is_the_transposed_conv(k):
    """The reassemble's kernel = stride transposed convs as a forward conv
    and a pixel shuffle; other geometries are refused."""
    gen = torch.Generator().manual_seed(k)
    up = torch.nn.ConvTranspose2d(6, 5, k, stride=k)
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape, generator=gen))
    x = torch.randn(2, 6, 5, 7, generator=gen)
    torch.testing.assert_close(up_by_stride(x, up),
                               F.conv_transpose2d(x, up.weight, up.bias, stride=k),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="up_by_stride"):
        up_by_stride(x, torch.nn.ConvTranspose2d(6, 5, 3, stride=2, padding=1))


# -- the networks at the tiny geometries -------------------------------------------
@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Seeded tiny plain and hybrid folders (config.json + model.safetensors,
    their heads calibrated on frames of the tests' kind) and the port's
    annotators of them."""
    root = tmp_path_factory.mktemp("depth")
    frames = torch.from_numpy(_frames(np.random.RandomState(1), (64, 80), 4))
    out = {}
    for kind, make, cfg in (("plain", seeded.dpt_checkpoint, TINY),
                            ("hybrid", seeded.dpt_hybrid_checkpoint, TINY_HYBRID)):
        config, sd = make(torch.Generator().manual_seed(3), frames, cfg)
        seeded.write_depth_folder(root / kind, config, sd)
        out[kind] = {"dir": root / kind, "config": config, "sd": sd,
                     "annotator": depth.DepthAnnotator.from_dir(root / kind, "cpu")}
    return out


def _jax_network(kind: str, folder: Path):
    """The JAX package's jitted network and parameters of a folder, from
    its own caches (the network's compile is then shared with `run`)."""
    if kind == "plain":
        fn, params, _ = jax_dpt.load_flax_dpt(folder)
        return fn, params
    if str(folder) not in jax_hybrid._CACHE:
        jax_hybrid.run_flax(np.zeros((1, 8, 8, 3), np.uint8), folder)
    return jax_hybrid._CACHE[str(folder)]


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
def test_network_matches_jax(folders, kind):
    """The port's network, on the state dict `from_jax.py` carries back from
    the JAX loader's tree, against the JAX network on that tree, at the
    annotator's 2 x 384x384 input: within 1e-4 of the largest value."""
    f = folders[kind]
    fn, params = _jax_network(kind, f["dir"])
    carried = (from_jax.dpt_state_dict(params, TINY.num_layers) if kind == "plain"
               else from_jax.dpt_hybrid_state_dict(params, TINY_HYBRID))
    net = depth.depth_network(f["config"], carried, "cpu")
    x = depth.network_input(torch.from_numpy(_frames(np.random.RandomState(4), (64, 80))))
    with torch.no_grad():
        mine = net(x).numpy()
    assert mine.shape == (2, 384, 384)
    _close_to_largest(mine, np.asarray(fn(params, _nhwc(x))))


@pytest.mark.parametrize("patch", [8, 32])
def test_hybrid_resizes_a_stored_grid_as_jax(patch):
    """A hybrid whose stored position grid (384 / patch a side) is larger
    or smaller than its /16 map's (24): the table resized as JAX
    `dpt_hybrid.py:179-184` does, within 1e-4 of the largest value."""
    cfg = dataclasses.replace(TINY_HYBRID, patch=patch)
    frames = torch.from_numpy(_frames(np.random.RandomState(5), (64, 80)))
    config, sd = seeded.dpt_hybrid_checkpoint(torch.Generator().manual_seed(patch), frames, cfg)
    assert sd["dpt.embeddings.position_embeddings"].shape[1] == (384 // patch) ** 2 + 1
    params = jax_hybrid.dpt_hybrid_params_from_torch({k: v.numpy() for k, v in sd.items()},
                                                     config)
    model = jax_hybrid.model_from_config(config)
    x = depth.network_input(frames)
    with torch.no_grad():
        mine = depth.depth_network(config, sd, "cpu")(x).numpy()
    want = jax.jit(lambda p, x: model.apply({"params": p}, x))(params, _nhwc(x))
    _close_to_largest(mine, np.asarray(want))


@pytest.mark.parametrize("kind", ["plain", "hybrid"])
def test_key_table_round_trips_the_checkpoint(folders, kind):
    """`dpt_state_dict` / `dpt_hybrid_state_dict` of the JAX loader's tree is
    the seeded checkpoint, key for key and value for value (the hybrid's
    BiT convs unstandardised, as the file holds them)."""
    sd = folders[kind]["sd"]
    sdn = {k: v.numpy() for k, v in sd.items()}
    carried = (from_jax.dpt_state_dict(jax_dpt.dpt_params_from_torch(sdn, 4, TINY.taps), 4)
               if kind == "plain" else from_jax.dpt_hybrid_state_dict(
                   jax_hybrid.dpt_hybrid_params_from_torch(sdn, folders[kind]["config"]),
                   TINY_HYBRID))
    assert set(carried) == set(sd)
    for k, v in sd.items():
        assert torch.equal(carried[k], v), k


# -- the annotator -----------------------------------------------------------------
@pytest.mark.parametrize("kind", ["plain", "hybrid"])
@pytest.mark.parametrize("hw", [(64, 80), (45, 61)])
def test_annotator_matches_jax(folders, kind, hw, monkeypatch, opencv_path):
    """The annotator against `depth.run` on the same folder (its plain or
    hybrid `run_flax`): within 1e-4, within 1 LSB after the quantisation,
    in [0, 1] and not constant."""
    monkeypatch.setenv(depth.MODEL_ENV, str(folders[kind]["dir"]))
    frames = _frames(np.random.RandomState(sum(hw)), hw)
    want = jax_depth.run(frames)
    mine = folders[kind]["annotator"](torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, *hw, 3) and mine.dtype == np.float32
    assert mine.min() == 0.0 and mine.max() == 1.0 and mine[..., 0].std() > 0.05
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    assert np.abs(_q(mine) - _q(want)).max() <= 1


def test_missing_folder_raises(tmp_path, monkeypatch):
    """No folder at the default path (from the working directory) or at
    CONTROLANIMATE_DEPTH_MODEL: FileNotFoundError naming it, where JAX's
    `run` raises too."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(depth.MODEL_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="models/annotators/depth"):
        annotators.resolve_annotator(NAME, "cpu")
    monkeypatch.setenv(depth.MODEL_ENV, str(tmp_path / "elsewhere"))
    with pytest.raises(FileNotFoundError, match="elsewhere"):
        annotators.resolve_annotator(NAME, "cpu")


@pytest.mark.parametrize("change,error,match", [
    ({"model_type": "glpn"}, ValueError, "GLPN config's num_attention_heads is 2"),
    ({"model_type": "vit"}, ValueError, "'vit'"),
    ({"readout_type": "add"}, ValueError, "readout_type"),
    ({"hidden_act": "relu"}, ValueError, "hidden_act"),
    ({"layer_norm_eps": 1e-6}, ValueError, "layer_norm_eps"),
])
def test_config_refusals(folders, change, error, match, tmp_path, monkeypatch):
    """A config naming GLPN is read as GLPN's (the hybrid's one head count
    is not GLPN's list of one a stage: ValueError naming it), another
    model_type raises
    ValueError, and a value of a key JAX never reads that is not the
    constant its networks assume ValueError naming the key; nothing falls
    to another network."""
    folder = tmp_path / "depth"
    config = {**folders["hybrid"]["config"], **change}
    seeded.write_depth_folder(folder, config, folders["hybrid"]["sd"])
    monkeypatch.setenv(depth.MODEL_ENV, str(folder))
    with pytest.raises(error, match=match):
        annotators.resolve_annotator(NAME, "cpu")


@pytest.mark.parametrize("kind,key", [("plain", "dpt.encoder.layer.3.output.dense.weight"),
                                      ("hybrid", "dpt.embeddings.backbone.bit.embedder."
                                                 "convolution.weight")])
def test_missing_weight_raises(folders, kind, key, tmp_path):
    """A folder that lacks a weight raises KeyError naming it, where JAX
    goes on to the next network."""
    sd = {k: v for k, v in folders[kind]["sd"].items() if k != key}
    seeded.write_depth_folder(tmp_path / "depth", folders[kind]["config"], sd)
    with pytest.raises(KeyError, match=key):
        depth.DepthAnnotator.from_dir(tmp_path / "depth", "cpu")


def test_plain_table_off_the_384_grid_raises(folders, tmp_path):
    """A plain DPT whose position table does not hold 384 / patch squared
    plus one rows raises ValueError naming both sizes (JAX fails with a
    broadcast error); a `backbone.`-keyed file and the pooler read as the
    `dpt.` one."""
    config, sd = folders["plain"]["config"], folders["plain"]["sd"]
    bad = {**sd, "dpt.embeddings.position_embeddings":
           sd["dpt.embeddings.position_embeddings"][:, :145]}
    seeded.write_depth_folder(tmp_path / "bad", config, bad)
    with pytest.raises(ValueError, match="145 rows.*577"):
        depth.DepthAnnotator.from_dir(tmp_path / "bad", "cpu")
    renamed = {k.replace("dpt.", "backbone.", 1): v for k, v in sd.items()}
    renamed["backbone.pooler.dense.weight"] = torch.zeros(4, 4)
    seeded.write_depth_folder(tmp_path / "renamed", config, renamed)
    got = depth.DepthAnnotator.from_dir(tmp_path / "renamed", "cpu").model.state_dict()
    for k, v in folders["plain"]["annotator"].model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_segment_stack_annotates_each_frame_alone(folders):
    """The segment path annotates its S*F frames as one stack: each
    segment's maps equal that segment annotated alone within 1e-5 (the
    min-max is a frame's own), and within 1 LSB after the quantisation."""
    from types import SimpleNamespace

    ann = folders["hybrid"]["annotator"]
    stub = SimpleNamespace(
        models=SimpleNamespace(controlnets=[None], annotators=[ann]),
        config=SimpleNamespace(controlnets=(NAME,), save_frames=False),
        _to_device=torch.as_tensor)
    frames = _frames(np.random.RandomState(9), (64, 64), 6).reshape(3, 2, 64, 64, 3)
    (maps,) = tfacade.ControlAnimatePipeline.prepare_cond_images(stub, frames)
    assert maps.shape == (3, 2, 64, 64, 3) and maps.dtype == torch.uint8
    for s in range(3):
        alone = ann(torch.from_numpy(frames[s]))
        torch.testing.assert_close(ann(torch.from_numpy(frames.reshape(6, 64, 64, 3)))[
            2 * s:2 * s + 2], alone, atol=1e-5, rtol=0)
        assert int((maps[s].int() - (alone * 255.0 + 0.5).to(torch.uint8).int()).abs().max()) <= 1


# -- a depth ControlNet from disk --------------------------------------------------
@pytest.fixture(scope="module")
def depth_zoo(zoo, folders, tmp_path_factory):
    """models/ControlNet/control_v11f1p_sd15_depth (a seeded tiny ControlNet)
    and models/annotators/depth (the tiny hybrid folder) under a fresh
    directory."""
    root = tmp_path_factory.mktemp("depth_zoo")
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    net = _seed_(ControlNetModel(cfg, cond), 17)
    _save_component(root / "models" / "ControlNet", NAME.split("/")[-1], cn_json,
                    net.state_dict(), "diffusion_pytorch_model.safetensors")
    (root / "models" / "annotators").mkdir(parents=True)
    (root / depth.DEFAULT_MODEL).symlink_to(folders["hybrid"]["dir"], target_is_directory=True)
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((zoo["root"] / "frames").glob("*.png"))])
    return {"root": root, "net": net, "frames": frames}


def test_depth_controlnet_from_disk_matches_jax(zoo, depth_zoo, monkeypatch, opencv_path):
    """The port's build from disk with the depth ControlNet (found under
    models/ControlNet/, the hybrid folder at the default path from the
    working directory) against the JAX facade with the same UNet, VAE,
    text stack and ControlNet from the same files: condition maps within 1
    LSB, and a window within 1 LSB, which the ControlNet changed."""
    monkeypatch.chdir(depth_zoo["root"])
    monkeypatch.delenv(depth.MODEL_ENV, raising=False)
    monkeypatch.setattr(jax_hybrid, "_CACHE", {})
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _cfg(zoo, controlnets=(NAME,), cond_scale=(1.0,), inference_config_path=str(REPO / V1))
    require_ported(RunConfig(**kw))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
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
    frames = depth_zoo["frames"][:4]
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


def test_depth_cli_run_equals_the_injected_pipeline(zoo, depth_zoo, folders, tmp_path,
                                                    monkeypatch):
    """A profile naming the depth ControlNet through `main([...])`, the
    plain DPT folder named by CONTROLANIMATE_DEPTH_MODEL: every frame
    equals `vid2vid` with the injected pipeline of the same ControlNet and
    an annotator read from the same folder."""
    monkeypatch.chdir(depth_zoo["root"])
    monkeypatch.setenv(depth.MODEL_ENV, str(folders["plain"]["dir"]))
    profile = _cfg(zoo, inference_config_path=str(REPO / V2),
                   input_video_path=str(zoo["root"] / "frames"),
                   output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[],
                   controlnets=[NAME], cond_scale=[0.9])
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                    for k, v in profile.items()}))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 6 and summary["timers"]["annotate"]["count"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]
    cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
    injected = tfacade.ControlAnimatePipeline(
        cfg, models=tengine.EngineModels(
            unet=zoo["unet"], vae=zoo["vae"], controlnets=[depth_zoo["net"]],
            annotators=[annotators.resolve_annotator(NAME, "cpu")]),
        text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]),
                                     zoo["clip"]),
        arch=ArchConfig.from_yaml(REPO / V2), device="cpu")
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    assert len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)

