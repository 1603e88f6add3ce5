"""The NormalBae annotator (EfficientNet-B5 + NNET) against the JAX package
on the CPU.

The network at the tiny geometry of `tests/test_normalbae.py` against the
JAX `NormalBaeNNET` on weights carried by `weights/from_jax.py` at 64x64,
96x64, 100x60 and 45x61 (where both return 46x62 and the annotator keeps
the 45x61 over the frame); the full-B5 annotator against the JAX
`normalbae_net.run` on the same seeded `scannet.pt` at 64x80; the key
table; the file's layouts (flat, `module.`, {"model": ...} with and
without `module.`, the head BatchNorm and `num_batches_tracked` ignored),
of which JAX's loader cannot read the released nesting; a missing file;
the dispatch by name and CONTROLANIMATE_NORMALBAE_MODEL; a segment run's
S*F stack; and a normalbae
ControlNet read from disk, its window against the JAX facade's and its CLI
run against the injected pipeline. Gates: 1e-4 before the uint8
quantisation and 1 LSB after; the maps are not saturated (each channel's
std over 0.02); unit normals within 1e-4. The port runs on one torch
thread (the suite runs six workers), and each JAX network compiles once
per shape.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.annotators import normalbae_net as jax_nb
from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu.weights import ingest as jax_ingest
from controlanimate_tpu.weights.controlnet_weights import controlnet_params_from_torch
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import normalbae as nb
from controlanimate_tpu_torch.models.annotators import seeded
from controlanimate_tpu_torch.models.controlnet import ControlNetModel, controlnet_config_from_json
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_annotators import _long_chains
from test_torch_common import JaxDraws
from test_torch_facade_from_disk import (CN_JSON, D_CTX, REPO, SIZE, V1, V2, _cfg,  # noqa: F401
                                         _save_component, _seed_, zoo)

# tests/test_normalbae.py's tiny geometry
TINY = nb.NNETConfig(stem=8, widths=(8, 8, 16, 16, 16, 24, 24), repeats=(1,) * 7, head=32,
                     decoder=(24, 16, 12, 8), hidden=8)
TINY_JAX = jax_nb.EffNetConfig(stem=8, widths=TINY.widths, repeats=TINY.repeats, head=32)
NAME = "lllyasviel/control_v11p_sd15_normalbae"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _q(m: np.ndarray) -> np.ndarray:
    """The facade's uint8 quantisation."""
    return (np.clip(m, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(int)


def _assert_maps_close(mine: np.ndarray, want: np.ndarray) -> None:
    assert mine.shape == want.shape and mine.dtype == np.float32
    assert mine.reshape(-1, 3).std(0).min() > 0.02  # no channel saturated or constant
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    assert np.abs(_q(mine) - _q(want)).max() <= 1


def _frames(rng, hw, n: int = 2) -> np.ndarray:
    """Noise frames, then frames with long edge chains."""
    return np.concatenate([rng.randint(0, 256, (n // 2, *hw, 3), dtype=np.uint8),
                           _long_chains(rng, n - n // 2, *hw)])


def _stripped(ckpt: dict) -> dict:
    """A `normalbae_checkpoint`'s state dict without its wrappers."""
    return {k.removeprefix("module."): v for k, v in ckpt["model"].items()}


# -- the network at the tiny geometry ----------------------------------------------
@pytest.fixture(scope="module")
def tiny():
    """A seeded tiny checkpoint, the JAX tree of it, that tree carried back
    into the port's (folded) network, and the jitted JAX network."""
    frames = torch.from_numpy(_frames(np.random.RandomState(1), (64, 64), 4))
    ckpt = seeded.normalbae_checkpoint(torch.Generator().manual_seed(1), frames, TINY)
    params = jax_nb.nnet_params_from_torch({k: v.numpy() for k, v in ckpt["model"].items()},
                                           TINY_JAX)
    net = nb.nnet_from_state_dict(from_jax.normalbae_state_dict(params, TINY), TINY)
    model = jax_nb.NormalBaeNNET(effnet=TINY_JAX, dec_features=TINY.decoder, hidden=TINY.hidden)
    return {"ckpt": ckpt, "net": net,
            "jax": jax.jit(lambda x: model.apply({"params": params}, x))}


@pytest.mark.parametrize("hw,out_hw", [((64, 64), (64, 64)), ((96, 64), (96, 64)),
                                       ((100, 60), (100, 60)), ((45, 61), (46, 62))])
def test_nnet_matches_jax(tiny, hw, out_hw):
    """The folded network against `NormalBaeNNET` on the same weights: the
    four channels within 1e-4 and unit normals, at even sides that are not
    multiples of 32 and at odd ones (TF "SAME" pads the stride-2 convs
    asymmetrically; the refinement heads double the stem's rounded-up
    size)."""
    frames = _frames(np.random.RandomState(sum(hw)), hw)
    x = (frames.astype(np.float32) / 255.0 - jax_nb.IMAGENET_MEAN) / jax_nb.IMAGENET_STD
    want = np.asarray(tiny["jax"](jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        mine = tiny["net"](torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    assert mine.shape == want.shape == (2, 4, *out_hw)
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(mine[:, :3], axis=1), 1.0, atol=1e-4)
    assert mine[:, :3].std((0, 2, 3)).min() > 0.1


def test_odd_sides_keep_the_map_over_the_frame(tiny):
    """At 45x61 both networks return 46x62; the annotator returns the
    top-left 45x61 of JAX's (xyz + 1) / 2, which would not fit the
    ControlNet's frame whole (ROADMAP §3 (aq))."""
    frames = _frames(np.random.RandomState(4), (45, 61))
    x = (frames.astype(np.float32) / 255.0 - jax_nb.IMAGENET_MEAN) / jax_nb.IMAGENET_STD
    want = np.asarray(tiny["jax"](jnp.asarray(x)))[..., :3]
    assert want.shape == (2, 46, 62, 3)
    want = ((want + 1.0) * 0.5).clip(0.0, 1.0)[:, :45, :61]
    mine = nb.NormalBaeAnnotator(tiny["net"])(torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, 45, 61, 3)
    _assert_maps_close(mine, want)


def test_fold_keeps_the_network(tiny):
    """The folded network against the same weights with their BatchNorms
    applied at run time (the JAX package's way), in the port: the normals
    within 1e-4, kappa (up to tens) within 1e-4 and 1e-4 of its value."""
    with torch.device("meta"):
        unfolded = nb.NNET(TINY)
    unfolded.load_state_dict(_stripped(tiny["ckpt"]), strict=False, assign=True)
    unfolded.eval()
    folded = nb.nnet_from_state_dict(_stripped(tiny["ckpt"]), TINY)
    assert not any(isinstance(m, torch.nn.BatchNorm2d) for m in folded.modules())
    x = nb.normalize_frames(torch.from_numpy(_frames(np.random.RandomState(5), (64, 96))))
    with torch.no_grad():
        got, want = folded(x), unfolded(x)
    torch.testing.assert_close(got[:, :3], want[:, :3], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[:, 3], want[:, 3], atol=1e-4, rtol=1e-4)


def test_segment_stack_annotates_each_frame_alone(tiny):
    """The segment path annotates its S*F frames as one stack
    (`prepare_cond_images` on (S, F, H, W, 3)): each segment's maps equal
    that segment annotated alone, within 1e-5 (the convs may sum another
    batch in another order), and within 1 LSB after the quantisation."""
    from types import SimpleNamespace

    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    ann = nb.NormalBaeAnnotator(tiny["net"])
    stub = SimpleNamespace(
        models=SimpleNamespace(controlnets=[None], annotators=[ann]),
        config=SimpleNamespace(controlnets=(NAME,), save_frames=False),
        _to_device=torch.as_tensor)
    frames = _frames(np.random.RandomState(9), (64, 64), 6).reshape(3, 2, 64, 64, 3)
    (maps,) = ControlAnimatePipeline.prepare_cond_images(stub, frames)
    assert maps.shape == (3, 2, 64, 64, 3) and maps.dtype == torch.uint8
    stacked = ann(torch.from_numpy(frames.reshape(6, 64, 64, 3)))
    for s in range(3):
        alone = ann(torch.from_numpy(frames[s]))
        torch.testing.assert_close(stacked[2 * s:2 * s + 2], alone, atol=1e-5, rtol=0)
        assert int((maps[s].int() - (alone * 255.0 + 0.5).to(torch.uint8).int()).abs().max()) <= 1


# -- the full-B5 annotator ---------------------------------------------------------
@pytest.fixture(scope="module")
def b5(tmp_path_factory):
    """A seeded full-B5 `scannet.pt` (its statistics from frames of the
    tests' kind) in the released nesting ({"model": {"module.…"}}) and as a
    flat DataParallel state dict (`module.` keys), which the JAX loader
    reads; the port's annotator of the latter."""
    root = tmp_path_factory.mktemp("normalbae")
    frames = _frames(np.random.RandomState(2), (64, 80), 4)
    ckpt = seeded.normalbae_checkpoint(torch.Generator().manual_seed(2),
                                       torch.from_numpy(frames))
    nested, flat = root / "release" / "scannet.pt", root / "flat" / "scannet.pt"
    for path, obj in ((nested, ckpt), (flat, ckpt["model"])):
        path.parent.mkdir()
        torch.save(obj, path)
    return {"ckpt": ckpt, "nested": nested, "flat": flat,
            "annotator": nb.NormalBaeAnnotator.from_file(flat, "cpu")}


def test_annotator_matches_jax(b5, monkeypatch):
    """The annotator against `normalbae_net.run` on the same file at 64x80:
    within 1e-4, within 1 LSB after the quantisation, not saturated."""
    monkeypatch.setattr(jax_nb, "_CACHE", {})
    monkeypatch.setenv(nb.MODEL_ENV, str(b5["flat"]))
    frames = _frames(np.random.RandomState(6), (64, 80))
    want = jax_nb.run(frames)
    mine = b5["annotator"](torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, 64, 80, 3)
    _assert_maps_close(mine, want)


def test_key_table_is_the_checkpoint(b5):
    """`from_jax.normalbae_state_dict` of the JAX loader's tree is the
    checkpoint without its wrappers, key for key and value for value."""
    sd = {k: v.numpy() for k, v in b5["ckpt"]["model"].items()}
    carried = from_jax.normalbae_state_dict(jax_nb.nnet_params_from_torch(sd))
    stripped = _stripped(b5["ckpt"])
    assert set(carried) == set(stripped)
    for k, v in stripped.items():
        assert torch.equal(carried[k], v), k
    assert sum(v.numel() for v in stripped.values()) == 72_594_560


LAYOUTS = {
    "flat": lambda sd: sd,
    "module": lambda sd: {f"module.{k}": v for k, v in sd.items()},
    "model": lambda sd: {"model": sd},
    "model_module": lambda sd: {"model": {f"module.{k}": v for k, v in sd.items()}},
    # a released file also holds the backbone's unused head BatchNorm and
    # every BatchNorm's counter
    "with_bn2": lambda sd: {"model": {f"module.{k}": v for k, v in {
        **sd, **{f"encoder.original_model.bn2.{n}": torch.ones(32)
                 for n in ("weight", "bias", "running_mean", "running_var")},
        **{k.rsplit(".", 1)[0] + ".num_batches_tracked": torch.tensor(7)
           for k in sd if k.endswith("running_var")}}.items()}},
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layouts_give_the_same_network(tiny, layout, tmp_path):
    """Every layout of the same weights loads into the same folded network."""
    path = tmp_path / "scannet.pt"
    torch.save(LAYOUTS[layout](_stripped(tiny["ckpt"])), path)
    got = nb.load_nnet(path, "cpu", TINY).state_dict()
    want = nb.nnet_from_state_dict(_stripped(tiny["ckpt"]), TINY).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_jax_cannot_read_the_released_nesting(b5, monkeypatch):
    """{"model": {"module.…"}}: the JAX loader flattens it to `model.module.`
    keys and strips `module.` then `model.` once each, so its lookup fails
    (ROADMAP §3 (ap)); the port reads it into the same network as the flat
    file."""
    monkeypatch.setattr(jax_nb, "_CACHE", {})
    monkeypatch.setenv(nb.MODEL_ENV, str(b5["nested"]))
    frames = _frames(np.random.RandomState(7), (32, 32))
    with pytest.raises(KeyError, match="encoder.original_model.conv_stem.weight"):
        jax_nb.run(frames)
    got = nb.load_nnet(b5["nested"], "cpu").state_dict()
    for k, v in b5["annotator"].model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_missing_file_raises_without_fallback(tmp_path, monkeypatch):
    """No `scannet.pt` at the default path (from the working directory) or
    at CONTROLANIMATE_NORMALBAE_MODEL: FileNotFoundError naming the path,
    where the JAX package falls back to depth or luminance normals."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(nb.MODEL_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="models/annotators/normalbae/scannet.pt"):
        annotators.resolve_annotator(NAME, "cpu")
    monkeypatch.setenv(nb.MODEL_ENV, str(tmp_path / "elsewhere.pt"))
    with pytest.raises(FileNotFoundError, match="elsewhere.pt"):
        annotators.resolve_annotator(NAME, "cpu")


def test_dispatch_reads_the_model_env(b5, tmp_path, monkeypatch):
    """`annotate_frames` finds the file CONTROLANIMATE_NORMALBAE_MODEL names,
    not one in CONTROLANIMATE_ANNOTATOR_DIR."""
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(tmp_path))
    monkeypatch.setenv(nb.MODEL_ENV, str(b5["nested"]))
    frames = torch.from_numpy(_frames(np.random.RandomState(8), (32, 48)))
    assert torch.equal(annotators.annotate_frames(NAME, frames), b5["annotator"](frames))


# -- a normalbae ControlNet from disk ----------------------------------------------
@pytest.fixture(scope="module")
def nb_zoo(zoo, b5, tmp_path_factory):
    """models/ControlNet/control_v11p_sd15_normalbae (a seeded tiny ControlNet
    with the SD1.5 condition embedding) and models/annotators/normalbae/
    scannet.pt (the flat B5 file, which JAX reads too), under a fresh
    directory."""
    root = tmp_path_factory.mktemp("normalbae_zoo")
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    net = _seed_(ControlNetModel(cfg, cond), 16)
    _save_component(root / "models" / "ControlNet", NAME.split("/")[-1], cn_json,
                    net.state_dict(), "diffusion_pytorch_model.safetensors")
    (root / "models" / "annotators" / "normalbae").mkdir(parents=True)
    (root / nb.DEFAULT_MODEL).symlink_to(b5["flat"])
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((zoo["root"] / "frames").glob("*.png"))])
    return {"root": root, "net": net, "frames": frames}


def test_normalbae_controlnet_from_disk_matches_jax(zoo, nb_zoo, monkeypatch):
    """The port's build from disk with the normalbae ControlNet (found under
    models/ControlNet/, `scannet.pt` at the default path from the working
    directory) against the JAX facade with the same UNet, VAE, text stack
    and ControlNet from the same files: condition maps within 1 LSB, and a
    window within 1 LSB, which the ControlNet changed."""
    monkeypatch.chdir(nb_zoo["root"])
    monkeypatch.delenv(nb.MODEL_ENV, raising=False)
    monkeypatch.setattr(jax_nb, "_CACHE", {})
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _cfg(zoo, controlnets=(NAME,), cond_scale=(1.0,), inference_config_path=str(REPO / V1))
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
    frames = nb_zoo["frames"][:4]
    (map_t,) = [m.numpy().astype(int) for m in tpipe.prepare_cond_images(frames)]
    (map_j,) = [np.asarray(m).astype(int) for m in jpipe.prepare_cond_images(frames)]
    assert map_t.shape == map_j.shape == (1, 4, SIZE, SIZE, 3)
    assert np.abs(map_t - map_j).max() <= 1 and map_t.reshape(-1, 3).std(0).min() > 5
    out_j = jpipe.animate(frames, None, seed=5)
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1
    plain = tfacade.ControlAnimatePipeline(
        RunConfig(**{**kw, "controlnets": (), "cond_scale": ()}), device="cpu")
    out_plain = plain.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert not torch.equal(out_plain, out_t)


def test_normalbae_cli_run_equals_the_injected_pipeline(zoo, nb_zoo, b5, tmp_path,
                                                        monkeypatch):
    """A profile naming the normalbae ControlNet through `main([...])`, its
    `scannet.pt` the released nesting named by CONTROLANIMATE_NORMALBAE_MODEL:
    every frame equals `vid2vid` with the injected pipeline of the same
    ControlNet and an annotator read from the same file."""
    monkeypatch.chdir(nb_zoo["root"])
    monkeypatch.setenv(nb.MODEL_ENV, str(b5["nested"]))
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
            unet=zoo["unet"], vae=zoo["vae"], controlnets=[nb_zoo["net"]],
            annotators=[annotators.resolve_annotator(NAME, "cpu")]),
        text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]),
                                     zoo["clip"]),
        arch=ArchConfig.from_yaml(REPO / V2), device="cpu")
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    assert len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)
