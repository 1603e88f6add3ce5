"""The port's disk build and CLI with ControlNets, on the synthetic model zoo
of `tests/test_torch_facade_from_disk.py` (nothing is downloaded):

  * a tiny diffusers ControlNet folder, built by the port from its
    config.json equal bit for bit to the JAX `controlnet_params_from_torch`
    on the same file, found under models/ControlNet/ or by its path, through
    the CLI with the canny annotator; a missing folder and a `cond_scale` of
    the wrong length raise;
  * lineart and MLSD ControlNets (the LCM-LoRA profile's scales 0.35 and
    1.0) and their annotators' `sk_model.pth` and `mlsd_large_512_fp32.pth`
    from disk: the port's condition maps and window against the JAX
    facade's on the same files (the lineart maps within 1 LSB, the MLSD maps
    equal, the window within 1 LSB), and the CLI against the injected
    pipeline;
  * softedge and lineart_anime ControlNets and their annotators'
    `table5_pidinet.pth` (released layout) and `netG.pth` from disk, through
    the CLI against the injected pipeline.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.annotators import edge_nets as jax_edge_nets
from controlanimate_tpu.models.annotators import mlsd_net as jax_mlsd_net
from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.weights import ingest as jax_ingest
from controlanimate_tpu.weights.controlnet_weights import controlnet_params_from_torch
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu_torch import __main__ as cli
from controlanimate_tpu_torch import vid2vid as tv2v
from controlanimate_tpu_torch.config import ArchConfig, RunConfig
from controlanimate_tpu_torch.io import media as tmedia
from controlanimate_tpu_torch.models.controlnet import ControlNetModel, controlnet_config_from_json
from controlanimate_tpu_torch.models.tokenizer import CLIPTokenizer
from controlanimate_tpu_torch.pipelines import engine as tengine
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import seeded
from controlanimate_tpu_torch.models.annotators.lineart_anime import UnetGenerator
from test_torch_annotators import _seeded_lineart, mlsd_checkpoint
from test_torch_common import JaxDraws
from test_torch_facade_from_disk import (CN_JSON, D_CTX, REPO, SIZE, V1, V2,  # noqa: F401
                                         _assert_state_equal, _cfg, _save_component, _seed_,
                                         zoo)


@pytest.fixture(scope="module")
def cn_zoo(tmp_path_factory):
    """models/ControlNet/sd-controlnet-canny under a fresh directory: the
    config.json and a safetensors file of a seeded tiny ControlNet."""
    root = tmp_path_factory.mktemp("cn_zoo")
    cfg, cond = controlnet_config_from_json(CN_JSON)
    net = _seed_(ControlNetModel(cfg, cond), 7)
    _save_component(root / "models" / "ControlNet", "sd-controlnet-canny", CN_JSON,
                    net.state_dict(), "diffusion_pytorch_model.safetensors")
    return {"root": root, "folder": root / "models" / "ControlNet" / "sd-controlnet-canny",
            "net": net}


def test_controlnet_disk_build_equals_jax(zoo, cn_zoo, monkeypatch):
    """The folder found as models/ControlNet/<last part of the name> from the
    working directory, and by its path: the port's ControlNet equals
    `from_jax` of the JAX `controlnet_params_from_torch` on the same file."""
    monkeypatch.chdir(cn_zoo["root"])
    for name in ("lllyasviel/sd-controlnet-canny", str(cn_zoo["folder"])):
        cfg = RunConfig(**_cfg(zoo, controlnets=(name,), inference_config_path=str(REPO / V1)))
        models, _ = tfacade.build_from_disk(cfg, ArchConfig.from_yaml(REPO / V1), "cpu", torch.float32)
        (net,) = models.controlnets
        jcfg = JaxUNetConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                             attention_heads=2, cross_attention_dim=D_CTX, norm_num_groups=4,
                             use_motion_module=False)
        _, sd = jax_ingest.load_hf_component(cn_zoo["folder"], "")
        params = controlnet_params_from_torch(sd, jcfg)
        _assert_state_equal(net.state_dict(), from_jax.controlnet_state_dict(params, net.config))
        _assert_state_equal(net.state_dict(), cn_zoo["net"].state_dict())


def test_controlnet_cli_run_equals_the_injected_pipeline(zoo, cn_zoo, tmp_path, monkeypatch):
    """A profile naming the ControlNet (canny annotator, `cond_scale` 0.7)
    through `main([...])`: its frames equal the injected pipeline's with the
    same ControlNet, and differ from a run without it."""
    monkeypatch.chdir(cn_zoo["root"])
    profile = _cfg(zoo, inference_config_path=str(REPO / V2), input_video_path=str(zoo["root"] / "frames"),
                   output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[],
                   controlnets=["lllyasviel/sd-controlnet-canny"], cond_scale=[0.7])
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                    for k, v in profile.items()}))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 6 and summary["timers"]["annotate"]["count"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]

    cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
    sinks = []
    for nets, c in (([cn_zoo["net"]], cfg), ([], cfg.replace(controlnets=(), cond_scale=()))):
        injected = tfacade.ControlAnimatePipeline(
            c, models=tengine.EngineModels(unet=zoo["unet"], vae=zoo["vae"], controlnets=nets),
            text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]),
                                         zoo["clip"]),
            arch=ArchConfig.from_yaml(REPO / V2), device="cpu")
        sinks.append(tmedia.ArrayFrameSink())
        tv2v.vid2vid(config=c, pipeline=injected, frame_sink=sinks[-1])
    for a, b in zip(got, sinks[0].frames):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(got, sinks[1].frames))


def test_controlnet_settings_that_raise(zoo, cn_zoo):
    """A missing ControlNet folder raises FileNotFoundError; a `cond_scale`
    whose length differs from `controlnets` raises ValueError before any
    file is read (JAX fails with an IndexError mid-trace)."""
    absent = str(zoo["root"] / "absent-sd-controlnet-canny")
    with pytest.raises(FileNotFoundError, match="absent-sd-controlnet-canny"):
        tfacade.ControlAnimatePipeline(RunConfig(**_cfg(zoo, controlnets=(absent,))),
                                       device="cpu")
    bad = RunConfig(**_cfg(zoo, controlnets=(str(cn_zoo["folder"]),) * 2, cond_scale=(1.0,),
                           pretrained_lcm_model_path=str(zoo["root"] / "absent")))
    with pytest.raises(ValueError, match="cond_scale"):
        tfacade.ControlAnimatePipeline(bad, device="cpu")



M13A_NAMES = ("lllyasviel/control_v11p_sd15_lineart", "lllyasviel/control_v11p_sd15_mlsd")
M13A_SCALES = (0.35, 1.0)  # SampleConfigLCMLoRA.yaml's


@pytest.fixture(scope="module")
def m13a_zoo(zoo, tmp_path_factory):
    """models/ControlNet/control_v11p_sd15_{lineart,mlsd} (seeded tiny
    ControlNets of the zoo UNet's down path with the SD1.5 condition
    embedding, which the JAX facade builds) and models/annotators/ with a
    seeded `sk_model.pth` and an `mlsd_large_512_fp32.pth` whose head is set
    on the zoo's frames, under a fresh directory."""
    root = tmp_path_factory.mktemp("m13a_zoo")
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    nets = []
    for seed, name in enumerate(M13A_NAMES, start=8):
        nets.append(_seed_(ControlNetModel(cfg, cond), seed))
        _save_component(root / "models" / "ControlNet", name.split("/")[-1], cn_json,
                        nets[-1].state_dict(), "diffusion_pytorch_model.safetensors")
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((zoo["root"] / "frames").glob("*.png"))])
    ann = root / "models" / "annotators"
    ann.mkdir(parents=True)
    torch.save(_seeded_lineart(10).state_dict(), ann / "sk_model.pth")
    torch.save(mlsd_checkpoint(11, frames[:2]), ann / "mlsd_large_512_fp32.pth")
    return {"root": root, "nets": nets, "frames": frames}


def test_lineart_mlsd_controlnets_from_disk_match_jax(zoo, m13a_zoo, monkeypatch):
    """The port's build from disk with the lineart and MLSD ControlNets (found
    under models/ControlNet/, their annotators under models/annotators/ from
    the working directory) against the JAX facade with the same UNet, VAE and
    text stack from disk and ControlNets from the same files: equal condition
    maps (lineart within 1 LSB) and a window within 1 LSB, which the
    ControlNets changed."""
    monkeypatch.chdir(m13a_zoo["root"])
    monkeypatch.delenv(annotators.ANNOTATOR_ENV, raising=False)
    monkeypatch.setattr(jax_edge_nets, "_CACHE", {})
    monkeypatch.setattr(jax_mlsd_net, "_CACHE", {})
    # the JAX build's UNet template from shapes alone, not an init compiled
    # op by op: the files hold every key (the port's build raises otherwise),
    # so no template value reaches the parameters
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _cfg(zoo, controlnets=M13A_NAMES, cond_scale=M13A_SCALES,
              inference_config_path=str(REPO / V1))
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    jbase = jfacade.ControlAnimatePipeline(JaxRunConfig(**{**kw, "controlnets": (),
                                                           "cond_scale": ()}))
    jcfg = JaxUNetConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                         attention_heads=2, cross_attention_dim=D_CTX, norm_num_groups=4,
                         use_motion_module=False)
    jparams = [controlnet_params_from_torch(jax_ingest.load_hf_component(
        Path("models/ControlNet") / n.split("/")[-1], "")[1], jcfg) for n in M13A_NAMES]
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**kw), text_stack=jbase.text, models=dataclasses.replace(
            jbase.models, controlnets=[JaxControlNet(jcfg) for _ in M13A_NAMES],
            controlnet_params=jparams, cond_scales=list(M13A_SCALES)))
    frames = m13a_zoo["frames"][:4]
    maps_t = [m.numpy().astype(int) for m in tpipe.prepare_cond_images(frames)]
    maps_j = [np.asarray(m).astype(int) for m in jpipe.prepare_cond_images(frames)]
    assert [m.shape for m in maps_t] == [m.shape for m in maps_j] == [(1, 4, SIZE, SIZE, 3)] * 2
    assert np.abs(maps_t[0] - maps_j[0]).max() <= 1 and maps_t[0].std() > 5
    np.testing.assert_array_equal(maps_t[1], maps_j[1])
    assert maps_t[1].max() == 255  # MLSD drew segments
    out_j = jpipe.animate(frames, None, seed=5)
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1
    plain = tfacade.ControlAnimatePipeline(
        RunConfig(**{**kw, "controlnets": (), "cond_scale": ()}), device="cpu")
    out_plain = plain.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert not torch.equal(out_plain, out_t)


def test_lineart_mlsd_cli_run_equals_the_injected_pipeline(zoo, m13a_zoo, tmp_path,
                                                           monkeypatch):
    """A profile naming both ControlNets through `main([...])`: every frame
    equals `vid2vid` with the injected pipeline of the same ControlNets and
    annotators read from the same files."""
    monkeypatch.chdir(m13a_zoo["root"])
    monkeypatch.delenv(annotators.ANNOTATOR_ENV, raising=False)
    profile = _cfg(zoo, inference_config_path=str(REPO / V2),
                   input_video_path=str(zoo["root"] / "frames"),
                   output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[],
                   controlnets=list(M13A_NAMES), cond_scale=list(M13A_SCALES))
    path = tmp_path / "profile.yaml"
    path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                    for k, v in profile.items()}))
    summary = cli.main(["--config", str(path), "--device", "cpu"])
    assert summary["frames_written"] == 6 and summary["timers"]["annotate"]["count"] == 2
    got = [np.asarray(Image.open(p)) for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]
    cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
    injected = tfacade.ControlAnimatePipeline(
        cfg, models=tengine.EngineModels(
            unet=zoo["unet"], vae=zoo["vae"], controlnets=m13a_zoo["nets"],
            annotators=[annotators.resolve_annotator(n, "cpu") for n in M13A_NAMES]),
        text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]),
                                     zoo["clip"]),
        arch=ArchConfig.from_yaml(REPO / V2), device="cpu")
    sink = tmedia.ArrayFrameSink()
    tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    assert len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)


M13C1_NAMES = ("lllyasviel/control_v11p_sd15_softedge",
               "lllyasviel/control_v11p_sd15s2_lineart_anime")


@pytest.fixture(scope="module")
def m13c1_zoo(zoo, tmp_path_factory):
    """models/ControlNet/control_v11p_sd15_softedge and
    control_v11p_sd15s2_lineart_anime (seeded tiny ControlNets) and
    models/annotators/ with a seeded `table5_pidinet.pth` (its classifier
    set on the zoo's frames) and a seeded full-width `netG.pth`."""
    root = tmp_path_factory.mktemp("m13c1_zoo")
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    nets = []
    for seed, name in enumerate(M13C1_NAMES, start=12):
        nets.append(_seed_(ControlNetModel(cfg, cond), seed))
        _save_component(root / "models" / "ControlNet", name.split("/")[-1], cn_json,
                        nets[-1].state_dict(), "diffusion_pytorch_model.safetensors")
    frames = np.stack([np.asarray(Image.open(p))
                       for p in sorted((zoo["root"] / "frames").glob("*.png"))])
    ann = root / "models" / "annotators"
    ann.mkdir(parents=True)
    torch.save(seeded.pidinet_checkpoint(torch.Generator().manual_seed(14),
                                         torch.from_numpy(frames[:4])),
               ann / "table5_pidinet.pth")
    torch.save(seeded.seed_lineart_anime_(UnetGenerator(), torch.Generator().manual_seed(15))
               .state_dict(), ann / "netG.pth")
    return {"root": root, "nets": nets}


def test_softedge_lineart_anime_cli_run_equals_the_injected_pipeline(zoo, m13c1_zoo, tmp_path,
                                                                     monkeypatch):
    """A profile naming the softedge and lineart_anime ControlNets through
    `main([...])` (on one torch thread: the full-width lineart_anime runs
    on each window's frames): every frame equals `vid2vid` with the injected
    pipeline of the same ControlNets and annotators read from the same
    files, and the condition maps are neither constant nor saturated."""
    monkeypatch.chdir(m13c1_zoo["root"])
    monkeypatch.delenv(annotators.ANNOTATOR_ENV, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        profile = _cfg(zoo, inference_config_path=str(REPO / V2),
                       input_video_path=str(zoo["root"] / "frames"),
                       output_video_dir=str(tmp_path / "cli"), textual_inversion_paths=[],
                       controlnets=list(M13C1_NAMES), cond_scale=[1.0, 0.8])
        path = tmp_path / "profile.yaml"
        path.write_text(yaml.safe_dump({k: list(v) if isinstance(v, tuple) else v
                                        for k, v in profile.items()}))
        summary = cli.main(["--config", str(path), "--device", "cpu"])
        assert summary["frames_written"] == 6 and summary["timers"]["annotate"]["count"] == 2
        got = [np.asarray(Image.open(p))
               for p in sorted((tmp_path / "cli" / "frames").glob("*.png"))]
        cfg = RunConfig.from_yaml(path).replace(output_video_dir=str(tmp_path / "injected"))
        injected = tfacade.ControlAnimatePipeline(
            cfg, models=tengine.EngineModels(
                unet=zoo["unet"], vae=zoo["vae"], controlnets=m13c1_zoo["nets"],
                annotators=[annotators.resolve_annotator(n, "cpu") for n in M13C1_NAMES]),
            text_stack=tfacade.TextStack(CLIPTokenizer.from_pretrained(zoo["snapshot"]),
                                         zoo["clip"]),
            arch=ArchConfig.from_yaml(REPO / V2), device="cpu")
        maps = injected.prepare_cond_images(np.stack(got[:4]))
        assert all(5 < m.float().std() and 0 < m.float().mean() < 255 for m in maps)
        sink = tmedia.ArrayFrameSink()
        tv2v.vid2vid(config=cfg, pipeline=injected, frame_sink=sink)
    finally:
        torch.set_num_threads(threads)
    assert len(got) == len(sink.frames) == 6
    for a, b in zip(got, sink.frames):
        np.testing.assert_array_equal(a, b)
