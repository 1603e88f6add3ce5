"""The port's annotators against OpenCV and the JAX package on the CPU:
canny bit for bit against `cv2.Canny(frame, 100, 200)` and the JAX
`annotate_frames("canny")` (random noise, smooth ramps, checkerboards,
frames with long edge chains, at odd sizes); HED and lineart against the
JAX `edge_nets.run` on the same synthetic `ControlNetHED.pth` /
`sk_model.pth`, 1e-4 before the uint8 quantisation and 1 LSB after; HED's
bilinear upsample against `jax.image.resize`; MLSD: the network's tpMap
against the JAX `MLSDLarge` on the same folded weights, the decode and the
drawing of JAX's own tpMaps (the network's, seeded and crafted ones) bit for
bit against the JAX `decode_lines` + `cv2.line`, the whole annotator against
`mlsd_net.run` (a stated share of pixels may differ), and its resizes and
line drawing bit for bit against `cv2.resize` and `cv2.line`; and the
annotator dispatch by substring, with a GLPN depth folder read as GLPN
and a missing weights file raising FileNotFoundError (OpenPose's own
parity tests are `test_torch_openpose.py`, softedge's and lineart_anime's
`test_torch_softedge_anime.py`, NormalBae's `test_torch_normalbae.py`,
depth's `test_torch_depth.py` and `test_torch_glpn.py`)."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models.annotators import annotate_frames as jax_annotate
from controlanimate_tpu.models.annotators import edge_nets as jax_edge_nets
from controlanimate_tpu.models.annotators import mlsd_net as jax_mlsd_net
from controlanimate_tpu_torch.config import RunConfig, require_ported
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import mlsd, seeded
from controlanimate_tpu_torch.models.annotators.edge_nets import (
    ControlNetHED, HEDAnnotator, LineartAnnotator, LineartGenerator, hed_postprocess)
from controlanimate_tpu_torch.ops.canny import canny
from controlanimate_tpu_torch.ops.draw import lines
from controlanimate_tpu_torch.ops.resize import resize_area, resize_nearest
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
    ("lllyasviel/ControlNet-HED", "hed"), ("lllyasviel/control_v11p_sd15_lineart", "lineart"),
    ("lllyasviel/sd-controlnet-mlsd", "mlsd"), ("lllyasviel/control_v11p_sd15_mlsd", "mlsd"),
    ("lllyasviel/control_v11p_sd15_openpose", "openpose"),
    ("lllyasviel/control_v11p_sd15_softedge", "softedge"), ("my_pidi_net", "softedge"),
    ("lllyasviel/control_v11p_sd15s2_lineart_anime", "lineart_anime"),
    ("lllyasviel/control_v11p_sd15_normalbae", "normalbae"),
    ("lllyasviel/control_v11f1p_sd15_depth", "depth"),
])
def test_dispatch_by_substring(name, key):
    assert annotators.annotator_name(name) == key


@pytest.mark.parametrize("name", ["lllyasviel/control_v11f1p_sd15_depth"])
def test_m13_annotators_raise(name, tmp_path, monkeypatch):
    """The depth name passes the configuration check (names only); a GLPN
    depth folder is read as GLPN when the pipeline reads it (the network
    GLPN, tests/test_torch_glpn.py), and a GLPN config without weights
    raises FileNotFoundError: nothing falls back."""
    from controlanimate_tpu_torch.models.annotators.glpn import GLPNConfig, GLPNDepth
    from controlanimate_tpu_torch.models.annotators.seeded import (glpn_checkpoint,
                                                                   write_depth_folder)

    assert annotators.annotator_name(name) == "depth"
    require_ported(RunConfig(controlnets=("lllyasviel/sd-controlnet-canny", name)))
    (tmp_path / "bare").mkdir()
    (tmp_path / "bare" / "config.json").write_text('{"model_type": "glpn"}')
    monkeypatch.setenv("CONTROLANIMATE_DEPTH_MODEL", str(tmp_path / "bare"))
    with pytest.raises(FileNotFoundError, match="no weight files"):
        annotators.resolve_annotator(name, "cpu")
    tiny = GLPNConfig(hidden_sizes=(8, 16, 24, 32), depths=(1, 1, 1, 1), heads=(1, 2, 3, 4),
                      mlp_ratios=(2, 2, 2, 2), decoder_hidden=16)
    frames = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 64, 64, 3),
                                                               dtype=np.uint8))
    write_depth_folder(tmp_path / "glpn", *glpn_checkpoint(torch.Generator().manual_seed(0),
                                                          frames, tiny))
    monkeypatch.setenv("CONTROLANIMATE_DEPTH_MODEL", str(tmp_path / "glpn"))
    ann = annotators.resolve_annotator(name, "cpu")
    assert isinstance(ann.model, GLPNDepth)
    assert ann(frames).shape == (1, 64, 64, 3)


def test_unknown_controlnet_name_raises():
    with pytest.raises(KeyError, match="no annotator"):
        annotators.annotator_name("my-controlnet")


OPENPOSE_FILES = ("body_pose_model.pth", "hand_pose_model.pth", "facenet.pth")


@pytest.mark.parametrize("name,fname", [("lllyasviel/control_v11p_sd15_lineart", "sk_model.pth"),
                                        ("lllyasviel/sd-controlnet-mlsd",
                                         "mlsd_large_512_fp32.pth"),
                                        ("lllyasviel/control_v11p_sd15_softedge",
                                         "table5_pidinet.pth"),
                                        ("lllyasviel/control_v11p_sd15s2_lineart_anime",
                                         "netG.pth"),
                                        ("lllyasviel/control_v11p_sd15_normalbae",
                                         "normalbae/scannet.pt")]
                         + [("lllyasviel/control_v11p_sd15_openpose", f) for f in OPENPOSE_FILES])
def test_missing_weights_raise(name, fname, tmp_path, monkeypatch):
    """A missing lineart, MLSD, PidiNet, lineart_anime or NormalBae file
    raises FileNotFoundError naming it (the JAX package falls back to Hough
    lines for MLSD, to HED for softedge and to depth or luminance normals
    for normalbae), and so does each of OpenPose's three with the other two
    present (the JAX package skips the hands or the face without a word).
    NormalBae's file is CONTROLANIMATE_NORMALBAE_MODEL's."""
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(tmp_path))
    monkeypatch.setenv("CONTROLANIMATE_NORMALBAE_MODEL", str(tmp_path / "normalbae/scannet.pt"))
    for other in OPENPOSE_FILES:
        if other != fname:  # an empty file: the missing one is found first
            (tmp_path / other).touch()
    with pytest.raises(FileNotFoundError, match=fname):
        annotators.resolve_annotator(name, "cpu")


# -- lineart ---------------------------------------------------------------------
def _seeded_lineart(seed: int) -> LineartGenerator:
    return seeded.seed_lineart_(LineartGenerator(), torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def lineart_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lineart") / "sk_model.pth"
    torch.save(_seeded_lineart(4).state_dict(), path)
    return path


@pytest.fixture
def fresh_jax_caches(monkeypatch):
    """The JAX annotators cache their jitted networks by weight path: each
    test starts with empty caches."""
    monkeypatch.setattr(jax_edge_nets, "_CACHE", {})
    monkeypatch.setattr(jax_mlsd_net, "_CACHE", {})


@pytest.mark.parametrize("hw", [(37, 45), (50, 33), (48, 64)])
def test_lineart_matches_jax(lineart_file, hw, fresh_jax_caches):
    """At odd sizes both packages return the network's map, whose sides are
    the frame's rounded up to a multiple of 4 (two stride-2 convs, two
    transposed ones; ROADMAP §3 (w))."""
    rng = np.random.RandomState(hw[1])
    frames = np.concatenate([rng.randint(0, 256, (1, *hw, 3), dtype=np.uint8),
                             _long_chains(rng, 1, *hw)])
    want = jax_edge_nets.run("lineart", frames, lineart_file.parent)
    mine = LineartAnnotator.from_file(lineart_file, device="cpu")(torch.from_numpy(frames)).numpy()
    assert mine.shape == want.shape == (2, -(-hw[0] // 4) * 4, -(-hw[1] // 4) * 4, 3)
    assert 0.02 < mine.std()  # the maps are not saturated
    np.testing.assert_allclose(mine, want, atol=1e-4, rtol=0)
    q_mine = (mine * 255.0 + 0.5).astype(np.uint8).astype(int)
    q_want = (want * 255.0 + 0.5).astype(np.uint8).astype(int)
    assert np.abs(q_mine - q_want).max() <= 1


def ingest_torch(path) -> dict:
    return {k: v.float() for k, v in torch.load(path, weights_only=True).items()}


def test_lineart_key_table_is_the_port_state_dict(lineart_file):
    """`from_jax.lineart_state_dict` of the JAX loader's tree is the
    checkpoint the port loads, exactly."""
    sd = ingest_torch(lineart_file)
    params = jax_edge_nets.lineart_params_from_torch({k: v.numpy() for k, v in sd.items()})
    carried = from_jax.lineart_state_dict(params)
    assert set(carried) == set(LineartGenerator().state_dict())
    for k, v in sd.items():
        assert torch.equal(carried[k], v), k


# -- MLSD ------------------------------------------------------------------------
def mlsd_checkpoint(seed: int, frames: np.ndarray) -> dict:
    """A synthetic `mlsd_large_512_fp32.pth`, its head set on `frames`."""
    return seeded.mlsd_checkpoint(torch.Generator().manual_seed(seed), torch.from_numpy(frames))


def _line_frames(rng, n: int, h: int, w: int) -> np.ndarray:
    """Frames with straight edges: bars, boxes and diagonals on a ramp."""
    out = []
    for i in range(n):
        img = np.repeat(np.linspace(40, 200, w, dtype=np.float32)[None, :, None], h, 0)
        img = np.repeat(img, 3, 2).astype(np.uint8)
        cv2.rectangle(img, (w // 5 + i, h // 4), (w // 2, 3 * h // 4), (250, 30, 30), 2)
        cv2.line(img, (0, h // 3 + i), (w - 1, h // 2), (0, 0, 0), 2)
        cv2.line(img, (w // 3, 0), (2 * w // 3 + i, h - 1), (255, 255, 255), 1)
        out.append(np.clip(img.astype(np.int16) + rng.randint(-6, 7, img.shape), 0, 255))
    return np.stack(out).astype(np.uint8)


@pytest.fixture(scope="module")
def mlsd_zoo(tmp_path_factory):
    """The synthetic checkpoint, two frames of 48x64 (smooth ramp with
    edges, and noise), the JAX `mlsd_net.run`'s maps of them and its
    network's tpMaps on the JAX package's own preprocessing of them (one
    compile: `run`'s jitted network, from a fresh cache), and the port's
    annotator on the CPU with its maps."""
    path = tmp_path_factory.mktemp("mlsd") / "mlsd_large_512_fp32.pth"
    rng = np.random.RandomState(6)
    frames = np.concatenate([_line_frames(rng, 1, 48, 64),
                             rng.randint(0, 256, (1, 48, 64, 3), dtype=np.uint8)])
    sd = mlsd_checkpoint(5, frames)
    torch.save(sd, path)
    params = jax_mlsd_net.mlsd_params_from_torch({k: v.numpy() for k, v in sd.items()})
    x = np.stack([cv2.resize(f, (512, 512), interpolation=cv2.INTER_AREA) for f in frames])
    x = np.concatenate([x, np.full((2, 512, 512, 1), 255.0)], axis=-1)
    x = x.astype(np.float32) / 127.5 - 1.0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mlsd_net, "_CACHE", {})
        want_map = jax_mlsd_net.run(frames, path)
        fn, jparams = jax_mlsd_net._CACHE[str(path)]
        tp = np.asarray(fn(jparams, x))
    annotator = mlsd.MLSDAnnotator.from_file(path, device="cpu")
    return {"path": path, "sd": sd, "params": params, "frames": frames, "tp": tp,
            "want_map": want_map, "annotator": annotator,
            "map": annotator(torch.from_numpy(frames))}


def test_mlsd_net_matches_jax(mlsd_zoo):
    """The port's tpMaps (INTER_AREA, the fourth channel, the folded network)
    against the JAX `MLSDLarge` on the JAX package's preprocessing: each
    channel within 1e-4 of its RMS (the centre logits' 1.6 absolute within
    1e-4, the displacements' 11 px within 1.1e-3). Over the network's 40
    fp32 convolutions either package sits up to 4e-4 px from a float64 run
    of it on the displacements, so an absolute 1e-4 there would gate on
    summation order."""
    mine = mlsd_zoo["annotator"].tp_map(torch.from_numpy(mlsd_zoo["frames"])).numpy()
    want = mlsd_zoo["tp"].transpose(0, 3, 1, 2)
    assert mine.shape == want.shape == (2, 16, 256, 256)
    assert 1.0 < want[:, 0].std() and 5.0 < want[:, 1:5].std()  # a live head
    np.testing.assert_allclose(mine[:, 0], want[:, 0], atol=1e-4, rtol=0)
    rms = np.sqrt((want ** 2).mean((0, 2, 3)))
    err = np.abs(mine - want).max((0, 2, 3))
    assert (err <= 1e-4 * rms).all(), (err, rms)


def test_mlsd_key_table_is_the_port_state_dict(mlsd_zoo):
    """The JAX loader's folded tree carried by `from_jax.mlsd_state_dict` is
    the port's own fold of the checkpoint, exactly."""
    carried = from_jax.mlsd_state_dict(mlsd_zoo["params"])
    mine = mlsd.mlsd_state_dict_from_torch(mlsd_zoo["sd"])
    assert set(carried) == set(mine) == set(mlsd.MLSDLarge().state_dict())
    for k, v in mine.items():
        assert torch.equal(carried[k], v), k


def _jax_draw(tp: np.ndarray) -> np.ndarray:
    """The JAX `run`'s decode and drawing of (N, 256, 256, 16) tpMaps."""
    out = []
    for t in tp:
        canvas = np.zeros((512, 512), np.uint8)
        for (x1, y1, x2, y2) in jax_mlsd_net.decode_lines(t):
            cv2.line(canvas, (int(x1), int(y1)), (int(x2), int(y2)), 255, 1)
        out.append(canvas)
    return np.stack(out)


def _crafted_tp(case: str) -> np.ndarray:
    rng = np.random.RandomState(len(case))
    tp = np.zeros((2, 256, 256, 16), np.float32)
    tp[..., 1:5] = rng.randn(2, 256, 256, 4) * 12.0
    if case == "seeded":
        tp[..., 0] = rng.randn(2, 256, 256) * 2.0
    elif case == "plateaus":
        # equal-valued plateaus (every pixel of one is a peak), saturated
        # ones (heat 1.0) among them; the background's peaks stay under 0.1
        tp[..., 0] = -6.0 + 0.3 * rng.rand(2, 256, 256)
        for i in range(12):
            y, x, s = rng.randint(8, 240), rng.randint(8, 240), rng.randint(1, 5)
            tp[i % 2, y:y + s, x:x + s, 0] = (0.5, 2.0, 30.0)[i % 3]
    elif case == "many_peaks":
        # 4096 isolated peaks of distinct heights above the 0.1 threshold
        tp[..., 0] = -8.0
        tp[:, ::4, ::4, 0] = rng.permutation(2 * 64 * 64).reshape(2, 64, 64) / 600.0 - 2.0
    elif case == "near_integers":
        # ends 2 * (x + d) on, and one float32 step either side of, integers
        tp[..., 0] = rng.randn(2, 256, 256) * 2.0
        half = rng.randint(-60, 60, (2, 256, 256, 4)).astype(np.float32) / 2.0
        nudge = rng.randint(-1, 2, half.shape)
        tp[..., 1:5] = np.where(nudge < 0, np.nextafter(half, -np.inf),
                                np.where(nudge > 0, np.nextafter(half, np.inf), half))
    elif case == "off_canvas":
        tp[..., 0] = rng.randn(2, 256, 256) * 2.0
        tp[..., 1:5] = rng.randn(2, 256, 256, 4) * 300.0
    return tp


@pytest.mark.parametrize("case", ["net", "seeded", "plateaus", "many_peaks", "near_integers",
                                  "off_canvas"])
def test_mlsd_decode_and_draw_is_jax(mlsd_zoo, case):
    """JAX's tpMaps through the port's decode and drawing give the JAX map
    bit for bit: the network's, seeded noise, equal-valued and saturated
    plateaus, more than 200 peaks over the threshold, ends on and one float32
    step off integers (negative ones included), segments leaving the canvas."""
    tp = mlsd_zoo["tp"] if case == "net" else _crafted_tp(case)
    want = _jax_draw(tp)
    mine = mlsd.draw_segments(torch.from_numpy(tp.transpose(0, 3, 1, 2).copy())).numpy()
    assert mine.shape == want.shape == (2, 512, 512) and mine.dtype == np.uint8
    assert (want > 0).mean() > 0.002  # segments were drawn
    np.testing.assert_array_equal(mine, want)


def test_mlsd_ties_across_rank_200_go_to_the_lower_index():
    """300 isolated peaks of one height over the threshold: the port keeps
    the 200 of lowest index, where numpy's `argpartition` keeps some 200 of
    them (ROADMAP §3 (v)). Each segment starts at its peak (zero start
    displacement) and runs 20 px right, so its start names the peak kept."""
    tp = np.zeros((1, 256, 256, 16), np.float32)
    tp[..., 0] = -8.0
    ys, xs = np.divmod(np.arange(300) * 7, 64)
    tp[0, 4 * ys, 4 * xs, 0] = 3.0
    tp[..., 3] = 20.0
    peaks = np.flatnonzero(tp[0, ..., 0].ravel() == 3.0)
    p1, _, keep = mlsd.decode_segments(torch.from_numpy(tp.transpose(0, 3, 1, 2).copy()))
    assert bool(keep.all())
    mine = (p1[0, :, 1] // 2 * 256 + p1[0, :, 0] // 2).numpy()
    np.testing.assert_array_equal(np.sort(mine), peaks[:200])
    theirs = [int(y1) // 2 * 256 + int(x1) // 2
              for x1, y1, _, _ in jax_mlsd_net.decode_lines(tp[0])]
    assert len(theirs) == 200 and set(theirs) <= set(peaks)


def test_mlsd_run_matches_jax(mlsd_zoo):
    """The whole annotator against `mlsd_net.run` on the same file and
    frames: maps of (F, H, W, 3) in {0, 1}. The tpMaps differ by float
    rounding (1e-4), which can move a segment's end across a pixel or a peak
    across the 200th rank; gate: the differing pixels are at most 2% of the
    pixels either map draws (0 measured), and on the JAX tpMaps the port's
    decode is exact (above)."""
    frames, want, mine = mlsd_zoo["frames"], mlsd_zoo["want_map"], mlsd_zoo["map"].numpy()
    assert mine.shape == want.shape == frames.shape and mine.dtype == np.float32
    assert set(np.unique(mine)) <= {0.0, 1.0} and want.mean() > 0.01
    drawn = int(((mine > 0) | (want > 0)).sum())
    differ = int((mine != want).sum())
    assert differ <= 0.02 * drawn, (differ, drawn)


def test_lineart_and_mlsd_through_the_dispatch(lineart_file, mlsd_zoo, tmp_path, monkeypatch):
    """`annotate_frames` finds both files by name in
    CONTROLANIMATE_ANNOTATOR_DIR."""
    for src in (lineart_file, mlsd_zoo["path"]):
        (tmp_path / src.name).symlink_to(src)
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(tmp_path))
    frames = torch.from_numpy(mlsd_zoo["frames"])
    got = annotators.annotate_frames("lllyasviel/control_v11p_sd15_lineart", frames)
    assert torch.equal(got, LineartAnnotator.from_file(lineart_file, "cpu")(frames))
    got = annotators.annotate_frames("lllyasviel/control_v11p_sd15_mlsd", frames)
    assert torch.equal(got, mlsd_zoo["map"])


# -- OpenCV's resizes and line, rebuilt -------------------------------------------
@pytest.mark.parametrize("src,dst", [
    ((768, 512), (512, 512)), ((513, 700), (512, 512)), ((1024, 1024), (512, 512)),
    ((1536, 512), (512, 512)), ((1024, 512), (512, 512)), ((12, 12), (4, 4)),
    ((64, 64), (64, 64)), ((37, 53), (512, 512)), ((31, 17), (100, 40)),
    ((700, 300), (512, 512)), ((10, 300), (90, 200)), ((3, 1), (511, 13)),
])
def test_resize_area_is_opencv(src, dst):
    """INTER_AREA bit for bit: down by 1.5 (the shipped 512x768 frame), down
    by non-integers, integer blocks (2x2, 3x1, 2x1, 3x3), equal, up, and up
    in one axis while down in the other."""
    frames = np.random.RandomState(sum(src)).randint(0, 256, (2, *src, 3), dtype=np.uint8)
    want = np.stack([cv2.resize(f, dst[::-1], interpolation=cv2.INTER_AREA) for f in frames])
    np.testing.assert_array_equal(resize_area(torch.from_numpy(frames), *dst).numpy(), want)


@pytest.mark.parametrize("channels", [1, 2, 4])
@pytest.mark.parametrize("src,dst", [((64, 96), (32, 48)), ((64, 96), (41, 30))])
def test_resize_area_channels_are_opencv(src, dst, channels):
    """A 2x2 block rounds half up for 1, 3 and 4 channels (OpenCV's vector
    path) and half to even for 2; the float path for any count."""
    frames = np.random.RandomState(channels).randint(0, 256, (2, *src, channels), dtype=np.uint8)
    want = np.stack([cv2.resize(f, dst[::-1], interpolation=cv2.INTER_AREA) for f in frames])
    got = resize_area(torch.from_numpy(frames), *dst).numpy()
    np.testing.assert_array_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("src,dst", [((512, 512), (768, 512)), ((512, 512), (48, 64)),
                                     ((512, 512), (37, 53)), ((7, 5), (512, 300)),
                                     ((512, 512), (512, 512))])
def test_resize_nearest_is_opencv(src, dst):
    frames = np.random.RandomState(sum(dst)).randint(0, 256, (2, *src, 1), dtype=np.uint8)
    want = np.stack([cv2.resize(f[..., 0], dst[::-1], interpolation=cv2.INTER_NEAREST)
                     for f in frames])
    np.testing.assert_array_equal(resize_nearest(torch.from_numpy(frames), *dst).numpy()[..., 0],
                                  want)


_EDGE_SEGMENTS = [(5, 5, 5, 5), (0, 0, 511, 511), (511, 0, 0, 511), (-1, -1, -1, -1),
                  (600, 3, 600, 3), (-5, 10, 520, 10), (10, -5, 10, 520), (-100, -50, 600, 700),
                  (3, 600, 700, -20), (511, 511, 511, 511), (512, 0, 512, 511),
                  (-1, 0, 511, 512), (100, 0, 101, 511), (0, 100, 511, 101), (1, 2, 3, 1),
                  (3, 1, 1, 2), (7, 3, 1, 6), (1, 6, 7, 3), (-900, 300, 1400, 301)]


@pytest.mark.parametrize("case", ["inside", "leaving", "one_by_one", "edges", "odd_canvas"])
def test_line_is_opencv(case):
    """`ops/draw.py` `lines` against `cv2.line(canvas, p1, p2, 255, 1)`:
    random segments inside and leaving the canvas (200 a canvas), single
    segments one canvas each (so one wrong pixel shows), points, edge rows and
    columns, shallow and steep slopes both ways, and a 37x53 canvas."""
    rng = np.random.RandomState(len(case))
    h, w = (37, 53) if case == "odd_canvas" else (512, 512)
    segs = {"inside": lambda: rng.randint(0, 512, (3, 200, 4)),
            "leaving": lambda: rng.randint(-800, 1300, (3, 200, 4)),
            "one_by_one": lambda: rng.randint(-300, 800, (400, 1, 4)),
            "edges": lambda: np.asarray(_EDGE_SEGMENTS)[:, None],
            "odd_canvas": lambda: rng.randint(-50, 90, (200, 1, 4))}[case]().astype(np.int64)
    want = np.zeros((len(segs), h, w), np.uint8)
    for canvas, row in zip(want, segs):
        for x1, y1, x2, y2 in row:
            cv2.line(canvas, (int(x1), int(y1)), (int(x2), int(y2)), 255, 1)
    t = torch.from_numpy(segs)
    mine = lines(t[..., :2], t[..., 2:], torch.ones(t.shape[:2], dtype=torch.bool), h, w)
    np.testing.assert_array_equal(mine.numpy(), want)


@pytest.mark.parametrize("hw", [(7, 5), (1, 1), (16, 24)])
def test_lineart_up2x_is_the_transposed_conv(hw):
    """`up2x` (a 2x2 conv to four phases, then a pixel shuffle) equals
    `ConvTranspose2d(3, stride 2, padding 1, output_padding 1)`, edges
    included."""
    from controlanimate_tpu_torch.models.annotators.edge_nets import up2x

    g = torch.Generator().manual_seed(sum(hw))
    up = torch.nn.ConvTranspose2d(6, 4, 3, stride=2, padding=1, output_padding=1)
    with torch.no_grad():
        up.weight.copy_(torch.randn(up.weight.shape, generator=g))
        up.bias.copy_(torch.randn(4, generator=g))
        x = torch.randn(2, 6, *hw, generator=g)
        want = up(x)
        got = up2x(x, up)
    assert got.shape == want.shape == (2, 4, 2 * hw[0], 2 * hw[1])
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
