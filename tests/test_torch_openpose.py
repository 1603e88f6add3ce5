"""The port's OpenPose annotator (body, hands and face) against the JAX
package on the CPU, on seeded synthetic `body_pose_model.pth`,
`hand_pose_model.pth` and `facenet.pth` files
(`annotators/seeded.py` `openpose_checkpoints`):

  * the three networks against the JAX `BodyPoseNet`, `HandPoseNet` and
    `FaceNet` on the same files within 1e-4 (64x64 inputs, as the JAX tests
    run them), and `from_jax`'s tables equal to the port's own reading;
  * the body decode and drawing bit for bit against the JAX `_find_peaks`,
    `_match_limbs`, `_assemble_people` and `draw_bodypose` on the JAX
    package's own cv2 resize of crafted stride-8 maps of two people
    (`seeded.pose_maps`), at three frame sizes; limbs whose pairs' priors
    tie or nearly tie; and an assembly in which a connection matches three
    people (JAX's `elif k < 17` then starts a new one);
  * one frame of one person (no left wrist: one hand, one face) through the
    JAX `openpose.run`, its body network's maps replaced by the crafted ones
    (a seeded body network finds no one), with OpenCV's own resize (IPP
    off, as `test_torch_cv_ops.py` holds the port to it; IPP's 8-bit crops
    differ by 1 on a few per cent of the pixels, which moved one face dot of
    the seeded face network's nearly flat maps by a pixel): the canvas after
    the body, after `detect_and_draw_hands` and after
    `detect_and_draw_faces` each equal to the port's, and `run`'s maps
    against the port's annotator, the share of differing pixels gated
    against the pixels drawn;
  * a tiny facade window with an openpose ControlNet and the three files
    read from disk against the JAX facade's on the same files."""

import dataclasses
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.config import RunConfig as JaxRunConfig
from controlanimate_tpu.models.annotators import openpose as jop
from controlanimate_tpu.models.annotators import openpose_face as jface
from controlanimate_tpu.models.annotators import openpose_hand_face as jhand
from controlanimate_tpu.models.controlnet import ControlNetModel as JaxControlNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.pipelines import facade as jfacade
from controlanimate_tpu.weights import ingest as jax_ingest
from controlanimate_tpu.weights.controlnet_weights import controlnet_params_from_torch
from controlanimate_tpu_torch.config import RunConfig
from controlanimate_tpu_torch.models import annotators
from controlanimate_tpu_torch.models.annotators import openpose, seeded
from controlanimate_tpu_torch.models.annotators.openpose_face import (
    FaceNet, face_regions_from_body, face_shapes, face_state_dict_from_torch)
from controlanimate_tpu_torch.models.annotators.openpose_hand_face import (
    HandPoseNet, crop_peaks, hand_regions_from_body, hand_shapes)
from controlanimate_tpu_torch.models.controlnet import ControlNetModel, controlnet_config_from_json
from controlanimate_tpu_torch.ops.warp import fp32_convs
from controlanimate_tpu_torch.pipelines import facade as tfacade
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import JaxDraws
from test_torch_facade_from_disk import (CN_JSON, D_CTX, REPO, SIZE, V1, _cfg, _save_component,
                                         _seed_, zoo)  # noqa: F401 (the zoo fixture)

NETS = {"body": ("body_pose_model.pth", jop.BodyPoseNet, jop.body_params_from_torch,
                 openpose.BodyPoseNet, from_jax.openpose_body_state_dict),
        "hand": ("hand_pose_model.pth", jhand.HandPoseNet, jhand.hand_params_from_torch,
                 HandPoseNet, from_jax.openpose_hand_state_dict),
        "face": ("facenet.pth", jface.FaceNet, jface.face_params_from_torch, FaceNet,
                 from_jax.openpose_face_state_dict)}


@pytest.fixture(scope="module")
def pose_files(tmp_path_factory):
    """The three seeded files in a fresh directory, and their state dicts."""
    root = tmp_path_factory.mktemp("openpose")
    sds = seeded.openpose_checkpoints(torch.Generator().manual_seed(21))
    for fname, sd in sds.items():
        torch.save(sd, root / fname)
    return {"root": root, "sds": sds}


@pytest.fixture
def fresh_jax_caches(monkeypatch):
    """The JAX networks are cached by weight path: each test starts empty."""
    for module in (jop, jhand, jface):
        monkeypatch.setattr(module, "_CACHE", {})


@pytest.mark.parametrize("which", list(NETS))
def test_nets_match_jax(pose_files, which):
    """Each network on the same file at 64x64, within 1e-4; `from_jax`
    carries the JAX tree back to the port's state dict exactly."""
    fname, jmodule, jconvert, module, carry = NETS[which]
    sd = torch.load(pose_files["root"] / fname)
    params = jconvert({k: v.numpy() for k, v in sd.items()})
    net = openpose.load_fp32(module, pose_files["root"] / fname, which, "cpu",
                             face_state_dict_from_torch if which == "face" else dict)
    mine_sd = net.state_dict()
    carried = carry(params)
    assert set(carried) == set(mine_sd)
    assert all(torch.equal(carried[k], v) for k, v in mine_sd.items())
    x = (np.random.RandomState(3).rand(1, 64, 64, 3) - 0.5).astype(np.float32)
    want = jmodule().apply({"params": params}, jnp.asarray(x))
    with torch.no_grad(), fp32_convs():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    want, got = (want, got) if which == "body" else ((want,), (got,))
    for w, g in zip(want, got):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape and w.std() > 0.01
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_face_file_with_model_prefix_loads(pose_files, tmp_path):
    """A `facenet.pth` whose keys carry `model.` reads as the JAX loader
    reads it."""
    sd = pose_files["sds"]["facenet.pth"]
    torch.save({f"model.{k}": v for k, v in sd.items()}, tmp_path / "facenet.pth")
    net = openpose.load_fp32(FaceNet, tmp_path / "facenet.pth", "face", "cpu",
                             face_state_dict_from_torch)
    assert all(torch.equal(net.state_dict()[k], v) for k, v in sd.items())


def _jax_decode(heat8, paf8, H, W):
    heat = cv2.resize(heat8, (W, H), interpolation=cv2.INTER_CUBIC)
    paf = cv2.resize(paf8, (W, H), interpolation=cv2.INTER_CUBIC)
    peaks = jop._find_peaks(heat)
    conns, special = jop._match_limbs(paf, peaks, H)
    candidate, subset = jop._assemble_people(peaks, conns, special)
    return peaks, (conns, special), candidate, subset


def _assert_same_peaks(mine, theirs):
    assert [len(p) for p in mine] == [len(p) for p in theirs]
    for a, b in zip(mine, theirs):
        for p, q in zip(a, b):
            assert (int(p[0]), int(p[1]), int(p[3])) == (int(q[0]), int(q[1]), int(q[3]))
            assert np.float32(p[2]) == np.float32(q[2])


@pytest.mark.parametrize("hw", [(768, 512), (384, 256), (200, 300)])
def test_body_decode_and_drawing_is_jax(hw):
    """Crafted maps of two people: the peaks (positions, unsmoothed values,
    ids), every limb's connections (ids, priors, order), the people and the
    drawn skeletons, all equal."""
    H, W = hw
    h8, w8 = openpose.body_input_size(H, W)
    heat8, paf8 = seeded.pose_maps(H, W, h8 // 8, w8 // 8)
    peaks, conns, candidate, subset = _jax_decode(heat8, paf8, H, W)
    want = jop.draw_bodypose(np.zeros((H, W, 3), np.uint8), candidate, subset)
    mine_peaks = openpose.peak_lists(torch.from_numpy(heat8[None]), H, W)[0]
    _assert_same_peaks(mine_peaks, peaks)
    mine_conns = openpose.limb_connections(torch.from_numpy(paf8[None]), [mine_peaks], H, W)[0]
    assert repr(mine_conns) == repr(conns)
    mine_candidate, mine_subset = openpose.assemble_people(mine_peaks, *mine_conns)
    np.testing.assert_array_equal(mine_candidate, candidate)
    np.testing.assert_array_equal(mine_subset, subset)
    assert len(subset) == 2
    got = openpose.paint_shapes([openpose.body_shapes(candidate, subset)], H, W, "cpu")[0]
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want > 0).any(-1).mean() > 0.02


def test_tied_priors_keep_jax_order():
    """Peaks of a 2 x 2 grid under a PAF pointing down everywhere: the two
    vertical pairs' priors tie (and the diagonals' nearly do), so the
    stable descending sort decides which pair each peak joins."""
    H, W = 160, 96
    paf8 = np.zeros((H // 8, W // 8, 38), np.float32)
    paf8[..., 31 - 19], paf8[..., 32 - 19] = 0.0, 1.0  # limb 0 (neck -> right shoulder)
    paf8[..., 39 - 19], paf8[..., 40 - 19] = 0.01, 0.9999  # limb 1, nearly so
    peaks = [[] for _ in range(18)]
    grid = [(20, 30), (60, 30), (20, 100), (60, 100), (21, 100)]
    for part, pts in ((1, grid[:2]), (2, grid[2:4]), (5, grid[2:])):
        peaks[part] = [(x, y, np.float32(0.9), 0) for x, y in pts]
    n = 0
    for part in peaks:
        for i, p in enumerate(part):
            part[i] = (*p[:3], n)
            n += 1
    paf = cv2.resize(paf8, (W, H), interpolation=cv2.INTER_CUBIC)
    want = jop._match_limbs(paf, peaks, H)
    got = openpose.limb_connections(torch.from_numpy(paf8[None]), [peaks], H, W)[0]
    assert repr(got) == repr(want)
    assert len(want[0][0]) == 2 and want[0][0][0][2] == want[0][0][1][2]  # a tie


# a connection list under which limb 12's third connection matches three
# people (found by search); JAX then starts a fourth
_THREE_MATCHES = {1: [[1, 4, 0.9, 0, 0]], 2: [[3, 5, 0.9, 0, 0]], 4: [[3, 5, 0.9, 0, 0]],
                  6: [[0, 2, 0.9, 0, 0]], 15: [[0, 3, 0.9, 0, 0]],
                  12: [[5, 1, 0.9, 0, 0], [0, 1, 0.9, 0, 0], [1, 1, 0.9, 0, 0]]}


def test_assembly_with_three_matching_people_is_jax():
    peaks = [[(i, i, np.float32(0.5), i)] if i < 6 else [] for i in range(18)]
    conns = [_THREE_MATCHES.get(k, []) for k in range(19)]
    special = [k for k in range(19) if k not in _THREE_MATCHES]
    want = jop._assemble_people(peaks, conns, special)
    got = openpose.assemble_people(peaks, conns, special)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


H1, W1 = 384, 256  # one person, 307 px tall: hand and face boxes of 60-70 px


@pytest.fixture(scope="module")
def one_person(pose_files):
    """One frame of one person without a left wrist, the JAX `openpose.run`
    of it with its body network's maps replaced by the crafted ones, and
    the canvases it drew after the body, the hands and the faces."""
    h8, w8 = openpose.body_input_size(H1, W1)
    heat8, paf8 = seeded.pose_maps(H1, W1, h8 // 8, w8 // 8, people=1)
    heat8[..., 7] = 0.0  # no left wrist: one hand
    yy, xx = np.mgrid[0:H1, 0:W1]
    rng = np.random.RandomState(9)
    frame = np.stack([xx * 0.9, yy * 0.6, (xx + yy) * 0.4], -1) + rng.randint(0, 40, (H1, W1, 3))
    frames = np.clip(frame, 0, 255).astype(np.uint8)[None]
    root = pose_files["root"]
    seen = {}

    def capture(name, fn):
        def wrapped(canvas, *args):
            seen[f"before_{name}"] = canvas.copy()
            out = fn(canvas, *args)
            seen[name] = out.copy()
            return out
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        for module in (jop, jhand, jface):
            mp.setattr(module, "_CACHE", {})
        mp.setitem(jop._CACHE, str(root / "body_pose_model.pth"),
                   (lambda p, x: (paf8[None], heat8[None]), None))
        mp.setattr(jhand, "detect_and_draw_hands", capture("hands", jhand.detect_and_draw_hands))
        mp.setattr(jface, "detect_and_draw_faces", capture("faces", jface.detect_and_draw_faces))
        cv2.setUseOptimized(False)
        try:
            want_map = jop.run(frames, root)
        finally:
            cv2.setUseOptimized(True)
    annotator = openpose.OpenPoseAnnotator.from_files(
        *(root / n for n in openpose.WEIGHT_NAMES), device="cpu")
    annotator.body_maps = lambda f: (torch.from_numpy(paf8[None]), torch.from_numpy(heat8[None]))
    got_map = annotator(torch.from_numpy(frames))
    return {"frames": frames, "heat8": heat8, "paf8": paf8, "seen": seen, "want": want_map,
            "got": got_map, "annotator": annotator, "stats": dict(annotator.stats)}


def test_hands_and_face_are_jax(one_person):
    """The port's canvas after the body, after the one hand's lines and dots
    and after the face's dots, each equal to JAX's (IPP off)."""
    frames, seen, ann = one_person["frames"], one_person["seen"], one_person["annotator"]
    peaks = openpose.peak_lists(torch.from_numpy(one_person["heat8"][None]), H1, W1)[0]
    conns = openpose.limb_connections(torch.from_numpy(one_person["paf8"][None]), [peaks],
                                      H1, W1)[0]
    candidate, subset = openpose.assemble_people(peaks, *conns)
    body = openpose.body_shapes(candidate, subset)
    hand_boxes = hand_regions_from_body(candidate, subset, H1, W1)
    face_boxes = face_regions_from_body(candidate, subset, H1, W1)
    assert len(subset) == 1 and len(hand_boxes) == 1 and len(face_boxes) == 1
    frames_t = torch.from_numpy(frames)
    hands = crop_peaks(ann.hand, frames_t, [(0, *b) for b in hand_boxes], 21).numpy()
    faces = crop_peaks(ann.face, frames_t, [(0, *b, False) for b in face_boxes], 70).numpy()
    hand = hand_shapes(hands[0], hand_boxes[0])
    face = face_shapes(faces[0], face_boxes[0])
    assert any(s[0] == "line" for s in hand) and len(face) > 5
    for shapes, key in ((body, "before_hands"), (body + hand, "hands"),
                        (body + hand + face, "faces")):
        got = openpose.paint_shapes([shapes], H1, W1, "cpu")[0].numpy()
        np.testing.assert_array_equal(got, seen[key])


def test_run_matches_jax(one_person):
    """The whole annotator against `openpose.run` on the same files and
    maps: (F, H, W, 3) float32 maps of k / 255. The networks' float
    rounding (1e-7 here) could move a part's maximum where the smoothed map
    is nearly flat (a seeded head's is); gate: the differing pixels are at
    most 1% of the pixels either map draws (0 measured)."""
    want, got = one_person["want"], one_person["got"].numpy()
    assert got.shape == want.shape == (1, H1, W1, 3) and got.dtype == np.float32
    drawn = int(((got > 0) | (want > 0)).any(-1).sum())
    differ = int((got != want).any(-1).sum())
    assert drawn > 0.05 * H1 * W1 and differ <= 0.01 * drawn, (differ, drawn)
    assert one_person["stats"]["people"] == 1
    assert one_person["stats"]["hands"] == one_person["stats"]["faces"] == 1


def test_openpose_through_the_dispatch(pose_files, monkeypatch):
    """`resolve_annotator` reads the three files from
    CONTROLANIMATE_ANNOTATOR_DIR; maps with no peak draw a black frame."""
    monkeypatch.setenv(annotators.ANNOTATOR_ENV, str(pose_files["root"]))
    ann = annotators.resolve_annotator("lllyasviel/control_v11p_sd15_openpose", "cpu")
    assert isinstance(ann, openpose.OpenPoseAnnotator)
    for net, fname in ((ann.hand, "hand_pose_model.pth"), (ann.face, "facenet.pth")):
        sd = pose_files["sds"][fname]
        assert all(torch.equal(v, sd[k]) for k, v in net.state_dict().items())
    frames = torch.full((2, 48, 40, 3), 120, dtype=torch.uint8)
    out = ann.draw(frames, torch.zeros(2, 23, 20, 38), torch.zeros(2, 23, 20, 19))
    assert out.shape == (2, 48, 40, 3) and not out.any() and ann.stats["people"] == 0


OPENPOSE_CN = "lllyasviel/control_v11p_sd15_openpose"


def test_openpose_controlnet_from_disk_matches_jax(zoo, pose_files, tmp_path,  # noqa: F811
                                                   monkeypatch):
    """A tiny window with an openpose ControlNet (models/ControlNet/
    control_v11p_sd15_openpose) and the three OpenPose files under
    models/annotators/ from the working directory: the port's build from
    disk against the JAX facade on the same files. The seeded body network
    finds no one, so both condition maps are black; the windows agree
    within 1 LSB."""
    cn_json = {**CN_JSON, "conditioning_embedding_out_channels": [16, 32, 96, 256]}
    cfg, cond = controlnet_config_from_json(cn_json)
    _save_component(tmp_path / "models" / "ControlNet", OPENPOSE_CN.split("/")[-1], cn_json,
                    _seed_(ControlNetModel(cfg, cond), 12).state_dict(),
                    "diffusion_pytorch_model.safetensors")
    (tmp_path / "models" / "annotators").mkdir(parents=True)
    for fname in openpose.WEIGHT_NAMES:
        (tmp_path / "models" / "annotators" / fname).symlink_to(pose_files["root"] / fname)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv(annotators.ANNOTATOR_ENV, raising=False)
    for module in (jop, jhand, jface):
        monkeypatch.setattr(module, "_CACHE", {})
    # the JAX body network's maps: those of the seeded file, which has no
    # peak (the port runs the file's network; `test_nets_match_jax` holds
    # the two networks together), without compiling it at 184x184
    monkeypatch.setitem(jop._CACHE, str(Path("models/annotators/body_pose_model.pth")), (
        lambda p, x: (np.zeros((*x.shape[:3], 38), np.float32),
                      np.full((*x.shape[:3], 19), -0.5, np.float32)), None))
    init = jfacade.ControlAnimatePipeline._init_unet_params
    monkeypatch.setattr(jfacade.ControlAnimatePipeline, "_init_unet_params", staticmethod(
        lambda unet, ucfg: jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                                  jax.eval_shape(lambda: init(unet, ucfg)))))
    kw = _cfg(zoo, controlnets=(OPENPOSE_CN,), cond_scale=(1.0,),
              inference_config_path=str(REPO / V1), frame_count=2, overlap_length=1)
    tpipe = tfacade.ControlAnimatePipeline(RunConfig(**kw), device="cpu")
    jbase = jfacade.ControlAnimatePipeline(JaxRunConfig(**{**kw, "controlnets": (),
                                                           "cond_scale": ()}))
    jcfg = JaxUNetConfig(block_out_channels=(8, 8, 16, 16), layers_per_block=1,
                         attention_heads=2, cross_attention_dim=D_CTX, norm_num_groups=4,
                         use_motion_module=False)
    jparams = [controlnet_params_from_torch(jax_ingest.load_hf_component(
        Path("models/ControlNet") / OPENPOSE_CN.split("/")[-1], "")[1], jcfg)]
    jpipe = jfacade.ControlAnimatePipeline(
        JaxRunConfig(**kw), text_stack=jbase.text, models=dataclasses.replace(
            jbase.models, controlnets=[JaxControlNet(jcfg)], controlnet_params=jparams,
            cond_scales=[1.0]))
    frames = np.random.RandomState(13).randint(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    (map_t,) = tpipe.prepare_cond_images(frames)
    (map_j,) = jpipe.prepare_cond_images(frames)
    assert map_t.shape == np.asarray(map_j).shape == (1, 2, SIZE, SIZE, 3)
    np.testing.assert_array_equal(map_t.numpy(), np.asarray(map_j))
    out_j = jpipe.animate(frames, None, seed=5)
    out_t = tpipe.animate(frames, None, seed=5, noise=JaxDraws(jax.random.PRNGKey(5)))
    assert np.abs(out_t.numpy().astype(int) - np.asarray(out_j).astype(int)).max() <= 1
