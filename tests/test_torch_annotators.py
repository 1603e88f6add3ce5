"""The port's annotators against OpenCV and the JAX package on the CPU:
canny bit for bit against `cv2.Canny(frame, 100, 200)` and the JAX
`annotate_frames("canny")` (random noise, smooth ramps, checkerboards,
frames with long edge chains, at odd sizes); HED against the JAX
`edge_nets.run("hed")` on the same synthetic `ControlNetHED.pth`, 1e-4
before the uint8 quantisation and 1 LSB after; HED's bilinear upsample
against `jax.image.resize`; and the annotator dispatch by substring, with
the annotators of M13 raising."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models.annotators import annotate_frames as jax_annotate
from controlanimate_tpu.models.annotators import edge_nets as jax_edge_nets
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators.edge_nets import (
    ControlNetHED, HEDAnnotator, hed_postprocess)
from controlanimate_tpu_torch.ops.canny import canny
from controlanimate_tpu_torch.weights import from_jax


def _ramps(rng, n, h, w):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    f = [np.stack([xx * (2 + i), yy * 3 + 7 * i, (xx + yy) * 1.5], -1) for i in range(n)]
    return np.clip(np.stack(f) + rng.randn(n, h, w, 3), 0, 255).astype(np.uint8)


def _checkerboard(rng, n, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    f = [((yy // (3 + i) + xx // (5 + i)) % 2 * 180 + 30)[..., None].repeat(3, -1)
         for i in range(n)]
    return np.stack(f).astype(np.uint8)


def _long_chains(rng, n, h, w):
    """Blurred spirals, circles and diagonals: edges hundreds of pixels long."""
    out = []
    for i in range(n):
        img = np.zeros((h, w, 3), np.uint8)
        cx, cy = w // 2 + i, h // 2
        pts = [(int(cx + t * 0.35 * np.cos(t / 6.0)), int(cy + t * 0.35 * np.sin(t / 6.0)))
               for t in range(0, 4 * min(h, w))]
        cv2.polylines(img, [np.asarray(pts, np.int32)], False, (200, 90 + 20 * i, 40), 2)
        cv2.circle(img, (w // 3, h // 3), min(h, w) // 4, (60, 220, 120), 1)
        cv2.line(img, (0, h - 1), (w - 1, 0), (255, 255, 255), 1)
        out.append(cv2.GaussianBlur(img, (5, 5), 1.2))
    return np.stack(out)


CASES = {
    "noise": lambda rng: rng.randint(0, 256, (3, 37, 53, 3), dtype=np.uint8),
    "ramps": lambda rng: _ramps(rng, 2, 41, 67),
    "checkerboard": lambda rng: _checkerboard(rng, 2, 33, 45),
    "long_chains": lambda rng: _long_chains(rng, 2, 131, 157),
    "one_row": lambda rng: rng.randint(0, 256, (2, 1, 29, 3), dtype=np.uint8),
    "tall": lambda rng: _long_chains(rng, 1, 203, 17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_canny_is_opencv_and_jax(case):
    frames = CASES[case](np.random.RandomState(sorted(CASES).index(case)))
    mine = canny(torch.from_numpy(frames)).numpy()
    want = np.stack([cv2.Canny(f, 100, 200) for f in frames]).astype(np.float32) / 255.0
    assert mine.shape == frames.shape and mine.dtype == np.float32
    for c in range(3):
        np.testing.assert_array_equal(mine[..., c], want)
    np.testing.assert_array_equal(mine, jax_annotate("lllyasviel/sd-controlnet-canny", frames))
    if case == "long_chains":
        assert want.sum() > 500  # the chains are there


def _seeded_hed(seed: int) -> ControlNetHED:
    """HED weights whose edge maps stay off 0 and 1: the offset near the
    frames' mean, the first conv scaled to 0..255 inputs, kernels
    N(0, 2/fan_in) (ReLU), projections N(0, 1/fan_in), biases small."""
    net = ControlNetHED()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name == "norm":
                p.copy_(torch.tensor([120.0, 110.0, 100.0]).reshape(1, 3, 1, 1))
            elif p.ndim == 4:
                gain = 1.0 if "projection" in name else 2.0
                p.copy_(torch.randn(p.shape, generator=g) * np.sqrt(gain / p[0].numel()))
                if name == "block1.convs.0.weight":
                    p.div_(64.0)
            else:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    return net.eval()


@pytest.fixture(scope="module")
def hed_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("annotators") / "ControlNetHED.pth"
    torch.save(_seeded_hed(3).state_dict(), path)
    return path


@pytest.mark.parametrize("hw", [(37, 45), (64, 64), (50, 33)])
def test_hed_matches_jax(hed_file, hw):
    rng = np.random.RandomState(hw[0])
    frames = np.concatenate([rng.randint(0, 256, (1, *hw, 3), dtype=np.uint8),
                             _long_chains(rng, 1, *hw)])
    want = jax_edge_nets.run("hed", frames, hed_file.parent)
    mine = HEDAnnotator.from_file(hed_file, device="cpu")(torch.from_numpy(frames)).numpy()
    assert mine.shape == want.shape == frames.shape
    assert 0.02 < mine.std()  # the maps are not saturated
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    q_mine = (mine * 255.0 + 0.5).astype(np.uint8).astype(int)
    q_want = (want * 255.0 + 0.5).astype(np.uint8).astype(int)
    assert np.abs(q_mine - q_want).max() <= 1


def test_hed_through_the_dispatch(hed_file, monkeypatch):
    """`annotate_frames` finds HED by name in CONTROLANIMATE_ANNOTATOR_DIR;
    a missing file raises FileNotFoundError."""
    frames = np.random.RandomState(1).randint(0, 256, (2, 24, 40, 3), dtype=np.uint8)
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(hed_file.parent))
    mine = annotators.annotate_frames("lllyasviel/sd-controlnet-hed", torch.from_numpy(frames))
    want = jax_edge_nets.run("hed", frames, hed_file.parent)
    np.testing.assert_allclose(mine.numpy(), want, atol=1e-4, rtol=0)
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(hed_file.parent / "absent"))
    with pytest.raises(FileNotFoundError, match="ControlNetHED.pth"):
        annotators.resolve_annotator("control_v11p_sd15_scribble", "cpu")


def test_hed_key_table_is_the_port_state_dict():
    shapes = jax.eval_shape(lambda: jax_edge_nets.ControlNetHED().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"])
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    carried = from_jax.hed_state_dict(params)
    sd = ControlNetHED().state_dict()
    assert set(carried) == set(sd)
    assert all(tuple(v.shape) == tuple(sd[k].shape) for k, v in carried.items())
    # the JAX loader reads the port's state dict back to the same tree
    theirs = jax_edge_nets.hed_params_from_torch({k: v.numpy() for k, v in sd.items()})
    assert jax.tree_util.tree_structure(theirs) == jax.tree_util.tree_structure(params)


@pytest.mark.parametrize("src,dst", [((7, 9), (28, 36)), ((3, 5), (50, 81)), ((16, 16), (16, 16)),
                                     ((2, 3), (37, 45))])
def test_hed_upsample_is_jax_resize(src, dst):
    """Half-pixel bilinear upsampling: `F.interpolate(align_corners=False)`
    equals `jax.image.resize(..., "bilinear")`, the frame edges included."""
    maps = [np.random.RandomState(i).randn(2, 1, *src).astype(np.float32) for i in range(5)]
    mine = hed_postprocess([torch.from_numpy(m) for m in maps], dst).numpy()
    want = np.asarray(jax_edge_nets.hed_postprocess(
        [jnp.asarray(m.transpose(0, 2, 3, 1)) for m in maps], dst))[..., 0]
    np.testing.assert_allclose(mine, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,key", [
    ("lllyasviel/sd-controlnet-canny", "canny"), ("lllyasviel/sd-controlnet-hed", "hed"),
    ("lllyasviel/control_v11p_sd15_canny", "canny"), ("control_v11p_sd15_scribble", "hed"),
    ("lllyasviel/ControlNet-HED", "hed"),
])
def test_dispatch_by_substring(name, key):
    assert annotators.annotator_name(name) == key


@pytest.mark.parametrize("name", [
    "lllyasviel/control_v11p_sd15_lineart", "lllyasviel/control_v11p_sd15_openpose",
    "lllyasviel/sd-controlnet-mlsd", "lllyasviel/control_v11p_sd15_softedge",
    "lllyasviel/control_v11f1p_sd15_depth", "lllyasviel/control_v11p_sd15_normalbae",
    "lllyasviel/control_v11p_sd15s2_lineart_anime", "my_pidi_net",
])
def test_m13_annotators_raise(name):
    """Every other annotator of the zoo raises NotImplementedError naming M13
    when the configuration is checked; `softedge` does not fall back to HED."""
    with pytest.raises(NotImplementedError, match="M13"):
        annotators.annotator_name(name)
    with pytest.raises(NotImplementedError, match="M13"):
        require_ported(RunConfig(controlnets=("lllyasviel/sd-controlnet-canny", name)))


def test_unknown_controlnet_name_raises():
    with pytest.raises(KeyError, match="no annotator"):
        annotators.annotator_name("my-controlnet")
