"""The softedge (PidiNet) and lineart_anime annotators against the JAX
package on the CPU.

PidiNet: each PDC kind's folded kernel against the JAX `_pdc_weight`, the
difference convolutions' zero response to constant frames, the stem's
stride-2 `cd` conv as a conv less a 1x1 conv of the tap sum, and the
annotator against the JAX `pidinet.run` on the same seeded
`table5_pidinet.pth` (nested under `state_dict`, every key under
`module.`, as released) at 64x80 and at an odd size. lineart_anime: the
U-Net at `ngf` 8 with all 8 levels against the JAX `UnetGeneratorAnime`
on the same weights at 256x256, then the annotator at the default width
against the JAX `run` on a seeded `netG.pth` on 64x64 and 200x120 frames,
so both INTER_CUBIC resizes run (OpenCV with IPP off, as the port computes
OpenCV's own code path; ROADMAP §3 (y)). Gates: 1e-4 before the uint8
quantisation and 1 LSB after; the maps are not saturated (std > 0.02).
Also: `up2x` at the 4x4 geometry against `F.conv_transpose2d`, the key
tables of `weights/from_jax.py`, and both annotators found by name in
CONTROLANIMATE_ANNOTATOR_DIR. The port runs on one torch thread (the suite
runs six workers), and each JAX network compiles once per file.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from controlanimate_tpu.models.annotators import lineart_anime as jax_anime
from controlanimate_tpu.models.annotators import pidinet as jax_pidinet
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import seeded
from controlanimate_tpu_torch.models.annotators.edge_nets import up2x
from controlanimate_tpu_torch.models.annotators.lineart_anime import (LineartAnimeAnnotator,
                                                                      UnetGenerator)
from controlanimate_tpu_torch.models.annotators.pidinet import (PidiNetAnnotator, pdc_kernel,
                                                                pidinet_state_dict_from_torch)
from controlanimate_tpu_torch.weights import from_jax
from test_torch_annotators import _long_chains


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def no_ipp():
    """cv2 with Intel IPP off: OpenCV's own INTER_CUBIC, which the port
    computes."""
    cv2.setUseOptimized(False)
    try:
        yield
    finally:
        cv2.setUseOptimized(True)


def _q(m: np.ndarray) -> np.ndarray:
    """The facade's uint8 quantisation (a value outside [0, 1] to 0 or 255)."""
    return (np.clip(m, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8).astype(int)


def _assert_maps_close(mine: np.ndarray, want: np.ndarray) -> None:
    assert mine.shape == want.shape and mine.dtype == np.float32
    assert mine.std() > 0.02  # the maps are not saturated
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    assert np.abs(_q(mine) - _q(want)).max() <= 1


def _frames(rng, hw, n: int = 2) -> np.ndarray:
    """Noise frames, then frames with long edge chains."""
    return np.concatenate([rng.randint(0, 256, (n // 2, *hw, 3), dtype=np.uint8),
                           _long_chains(rng, n - n // 2, *hw)])


# -- PidiNet -----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["cv", "cd", "ad", "rd"])
@pytest.mark.parametrize("depthwise", [False, True], ids=["dense", "depthwise"])
def test_pdc_kernel_is_jax(kind, depthwise):
    """The folded kernel equals the JAX `_pdc_weight` of the same (O, I, 3,
    3) kernel (1e-6: `cd`'s tap sum may add in another order)."""
    shape = (6, 1, 3, 3) if depthwise else (5, 4, 3, 3)
    w = np.random.RandomState(len(kind)).randn(*shape).astype(np.float32)
    mine = pdc_kernel(kind, torch.from_numpy(w)).numpy()
    want, pad = jax_pidinet._pdc_weight(kind, jnp.asarray(w.transpose(2, 3, 1, 0)))
    want = np.asarray(want).transpose(3, 2, 0, 1)
    assert mine.shape == want.shape == ((*shape[:2], 5, 5) if kind == "rd" else shape)
    assert pad == mine.shape[-1] // 2
    np.testing.assert_allclose(mine, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["cd", "ad", "rd", "cv"])
def test_pdc_difference_convs_vanish_on_constants(kind):
    """The port's counterpart of `tests/test_annotators.py`'s: `cd`, `ad`
    and `rd` answer a constant frame with zero away from the padding; `cv`
    does not."""
    w = torch.randn(6, 1, 3, 3, generator=torch.Generator().manual_seed(0))
    k = pdc_kernel(kind, w)
    y = F.conv2d(torch.full((1, 6, 8, 8), 0.37), k, padding=k.shape[-1] // 2, groups=6)
    inner = y[:, :, 3:5, 3:5]
    if kind == "cv":
        assert inner.abs().max() > 1e-3
    else:
        torch.testing.assert_close(inner, torch.zeros_like(inner), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(16, 20), (17, 23)])
def test_stem_cd_is_conv_less_tap_sum_conv(hw):
    """The stem's folded `cd` kernel at stride 2 and padding 1 equals the
    plain conv less a 1x1 conv of the tap sum at stride 2 (controlnet_aux's
    form): only the centre tap reads the pixel a 1x1 conv reads."""
    g = torch.Generator().manual_seed(sum(hw))
    w = torch.randn(7, 3, 3, 3, generator=g)
    x = torch.rand(2, 3, *hw, generator=g)
    got = F.conv2d(x, pdc_kernel("cd", w), stride=2, padding=1)
    want = (F.conv2d(x, w, stride=2, padding=1)
            - F.conv2d(x, w.sum((2, 3), keepdim=True), stride=2))
    assert got.shape == (2, 7, -(-hw[0] // 2), -(-hw[1] // 2))
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pidinet_zoo(tmp_path_factory):
    """A seeded `table5_pidinet.pth` (its classifier set on 64x80 frames)
    and the port's annotator of it on the CPU."""
    path = tmp_path_factory.mktemp("pidinet") / "table5_pidinet.pth"
    frames = _frames(np.random.RandomState(3), (64, 80))
    ckpt = seeded.pidinet_checkpoint(torch.Generator().manual_seed(3), torch.from_numpy(frames))
    torch.save(ckpt, path)
    return {"path": path, "ckpt": ckpt, "annotator": PidiNetAnnotator.from_file(path, "cpu")}


@pytest.mark.parametrize("hw", [(64, 80), (45, 61)])
def test_pidinet_matches_jax(pidinet_zoo, hw, monkeypatch):
    """The annotator against `pidinet.run` on the same file: at 64x80 and at
    an odd size, where the stem rounds up, the pools round down and the
    four maps are taken back to 45x61."""
    monkeypatch.setattr(jax_pidinet, "_CACHE", {})
    frames = _frames(np.random.RandomState(hw[1]), hw)
    want = jax_pidinet.run(frames, pidinet_zoo["path"].parent)
    mine = pidinet_zoo["annotator"](torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, *hw, 3)
    _assert_maps_close(mine, want)


def test_pidinet_key_table_is_the_checkpoint(pidinet_zoo):
    """`from_jax.pidinet_state_dict` of the JAX loader's tree is the
    checkpoint without its `module.` prefix, exactly; the port folds it as
    it loads."""
    sd = {k: v.numpy() for k, v in pidinet_zoo["ckpt"]["state_dict"].items()}
    carried = from_jax.pidinet_state_dict(jax_pidinet.pidinet_params_from_torch(sd))
    stripped = {k.removeprefix("module."): torch.from_numpy(v) for k, v in sd.items()}
    assert set(carried) == set(stripped)
    for k, v in stripped.items():
        assert torch.equal(carried[k], v), k
    folded = pidinet_state_dict_from_torch(carried)
    assert set(folded) == set(pidinet_zoo["annotator"].model.state_dict())


# -- lineart_anime -----------------------------------------------------------------
@pytest.mark.parametrize("hw", [(7, 5), (1, 1), (16, 24)])
def test_up2x_is_the_4x4_transposed_conv(hw):
    """`up2x` (a 3x3 conv to four phases, then a pixel shuffle) equals
    `ConvTranspose2d(4, stride 2, padding 1)`, edges included."""
    g = torch.Generator().manual_seed(sum(hw))
    up = torch.nn.ConvTranspose2d(6, 4, 4, stride=2, padding=1)
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape, generator=g))
        up.bias.copy_(torch.randn(4, generator=g))
        x = torch.randn(2, 6, *hw, generator=g)
        want = up(x)
        got = up2x(x, up)
    assert got.shape == want.shape == (2, 4, 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_up2x_refuses_other_geometries():
    with pytest.raises(ValueError, match="up2x"):
        up2x(torch.zeros(1, 2, 4, 4), torch.nn.ConvTranspose2d(2, 2, 4, stride=2, padding=2))


def _anime_jax(ngf: int, sd: dict, x: np.ndarray) -> np.ndarray:
    params = jax_anime.anime_params_from_torch({k: v.numpy() for k, v in sd.items()})
    model = jax_anime.UnetGeneratorAnime(ngf=ngf)
    return np.asarray(jax.jit(lambda p, a: model.apply({"params": p}, a))(params, x))


def test_unet_generator_matches_jax_at_all_levels():
    """The U-Net at `ngf` 8 with its 8 levels (the innermost at 1x1, the
    InstanceNorms of the two levels above it over 2x2 maps) against the JAX
    `UnetGeneratorAnime` on the same weights at 256x256, and the key table."""
    net = seeded.seed_lineart_anime_(UnetGenerator(ngf=8), torch.Generator().manual_seed(5))
    rng = np.random.RandomState(5)
    x = _frames(rng, (256, 256)).astype(np.float32) / 127.5 - 1.0
    want = _anime_jax(8, net.state_dict(), x)[..., 0]
    with torch.no_grad():
        mine = net(torch.from_numpy(x).permute(0, 3, 1, 2))[:, 0].numpy()
    assert mine.shape == want.shape == (2, 256, 256) and mine.std() > 0.1
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    carried = from_jax.lineart_anime_state_dict(jax_anime.anime_params_from_torch(
        {k: v.numpy() for k, v in net.state_dict().items()}))
    assert set(carried) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(carried[k], v), k


@pytest.fixture(scope="module")
def anime_zoo(tmp_path_factory):
    """A seeded `netG.pth` at the default width and the port's annotator."""
    path = tmp_path_factory.mktemp("lineart_anime") / "netG.pth"
    net = seeded.seed_lineart_anime_(UnetGenerator(), torch.Generator().manual_seed(6))
    torch.save(net.state_dict(), path)
    return {"path": path, "annotator": LineartAnimeAnnotator.from_file(path, "cpu")}


@pytest.fixture(scope="module")
def anime_jax_runs(anime_zoo, no_ipp):
    """The JAX `run` on 64x64 and 200x120 frames (both go through the
    network at 256x256: one compile), from a fresh cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_anime, "_CACHE", {})
        runs = {}
        for hw in ((64, 64), (200, 120)):
            frames = _frames(np.random.RandomState(hw[0]), hw)
            runs[hw] = (frames, jax_anime.run(frames, anime_zoo["path"].parent))
    return runs


@pytest.mark.parametrize("hw", [(64, 64), (200, 120)])
def test_lineart_anime_matches_jax(anime_zoo, anime_jax_runs, hw):
    """The annotator against `lineart_anime.run` on the same file: the
    frames up to 256x256 by INTER_CUBIC on uint8, the map back by
    INTER_CUBIC on float32."""
    frames, want = anime_jax_runs[hw]
    mine = anime_zoo["annotator"](torch.from_numpy(frames)).numpy()
    assert mine.shape == (2, *hw, 3)
    _assert_maps_close(mine, want)


def test_both_through_the_dispatch(pidinet_zoo, anime_zoo, tmp_path, monkeypatch):
    """`annotate_frames` finds `table5_pidinet.pth` and `netG.pth` by the
    ControlNet's name in CONTROLANIMATE_ANNOTATOR_DIR."""
    for src in (pidinet_zoo["path"], anime_zoo["path"]):
        (tmp_path / src.name).symlink_to(src)
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(tmp_path))
    frames = torch.from_numpy(_frames(np.random.RandomState(9), (32, 48)))
    for name in ("lllyasviel/control_v11p_sd15_softedge", "my_pidi_net"):
        got = annotators.annotate_frames(name, frames)
        assert torch.equal(got, pidinet_zoo["annotator"](frames))
    got = annotators.annotate_frames("lllyasviel/control_v11p_sd15s2_lineart_anime", frames)
    assert torch.equal(got, anime_zoo["annotator"](frames))


def test_condition_maps_out_of_range_go_to_the_ends():
    """The facade quantises a map below 0 or above 1 (lineart_anime's cubic
    resize overshoots at sides off a multiple of 256) to 0 or 255; the JAX
    facade's uint8 cast wraps -0.02 to 252 and 1.02 to 4."""
    from types import SimpleNamespace

    from controlanimate_tpu_torch.pipelines.facade import ControlAnimatePipeline

    values = torch.tensor([-0.5, -0.02, 0.0, 0.5, 1.0, 1.02, 3.0])
    stub = SimpleNamespace(
        models=SimpleNamespace(controlnets=[None], annotators=[
            lambda f: values.reshape(1, 1, -1, 1).expand(*f.shape[:3], 3)]),
        config=SimpleNamespace(controlnets=("lineart_anime",), save_frames=False),
        _to_device=lambda f: torch.as_tensor(f)[None])
    (maps,) = ControlAnimatePipeline.prepare_cond_images(
        stub, np.zeros((2, 1, 7, 3), np.uint8))
    assert maps.shape == (1, 2, 1, 7, 3) and maps.dtype == torch.uint8
    assert maps[0, 0, 0, :, 0].tolist() == [0, 0, 0, 128, 255, 255, 255]
    wrapped = (values.numpy() * 255.0 + 0.5).astype(np.uint8)
    assert wrapped[1] == 252 and wrapped[5] == 4
