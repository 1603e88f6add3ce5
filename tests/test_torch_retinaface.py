"""The port's RetinaFace-ResNet50 (`models/retinaface.py`) against the JAX
package's on the CPU: the weight loaders (the facexlib checkpoint with and
without a `module.` prefix, each BN folded) against the JAX loader carried
across by `weights/from_jax.py`, which must cover every leaf of the JAX
tree; the network's three outputs; `detect_faces` end to end on frames
whose stride-8 map has an odd size; the anchors, decode and NMS helpers;
and a missing file.

Gates: the folded weights within 1e-6 of the JAX loader's (both fold in
float32); the network's outputs at atol 1e-4, rtol 1e-4 (fp32); the
detections' rows equal in number and order, boxes and landmarks within
1e-3 px, scores within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models import retinaface as jrf
from controlanimate_tpu_torch.models import retinaface as trf
from controlanimate_tpu_torch.weights import from_jax
from test_retinaface import _leaf_items, synth_retinaface_sd


@pytest.fixture(scope="module")
def weights():
    """(facexlib state dict, JAX params, port network) from one synthetic
    checkpoint, its conv weights rescaled to std 1 / sqrt(fan-in) so the
    activations stay near 1 through the 50 layers; the class head's bias
    pushes some anchors over 0.5."""
    sd = synth_retinaface_sd(seed=4)
    for k, v in sd.items():
        if v.ndim == 4:
            sd[k] = (v / (0.05 * np.sqrt(v[0].size))).astype(np.float32)
    for i in range(3):
        sd[f"ClassHead.{i}.conv1x1.bias"][1::2] += 0.3
    params = jrf.retinaface_params_from_torch(sd)
    net = trf.RetinaFaceNet().eval()
    net.load_state_dict(trf.retinaface_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}))
    return sd, params, net


def test_mapping_covers_the_jax_tree_and_the_port():
    shapes = jax.eval_shape(lambda: jrf.RetinaFaceNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))["params"]
    entries = list(from_jax.retinaface_mapping())
    assert {f for _, f, _ in entries} == {p for p, _ in _leaf_items(shapes)}
    assert len({t for t, _, _ in entries}) == len(entries)
    assert {t for t, _, _ in entries} == set(trf.RetinaFaceNet().state_dict())


@pytest.mark.parametrize("prefix", ["", "module."])
def test_loader_folds_as_the_jax_loader(weights, prefix):
    """The checkpoint through the port's loader equals the JAX loader's tree
    carried across; a `module.` prefix is stripped."""
    sd, params, _ = weights
    got = trf.retinaface_state_dict({prefix + k: torch.from_numpy(v) for k, v in sd.items()})
    want = from_jax.retinaface_state_dict(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, err_msg=k)


def test_bn_fold_matches_batchnorm(weights):
    sd = {k: torch.from_numpy(v) for k, v in weights[0].items()}
    bn = torch.nn.BatchNorm2d(64).eval()
    with torch.no_grad():
        for p in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, p).copy_(sd[f"body.bn1.{p}"])
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 3, 16, 16).astype(np.float32))
    want = bn(torch.nn.functional.conv2d(x, sd["body.conv1.weight"], stride=2, padding=3))
    folded = trf.retinaface_state_dict(sd)
    got = torch.nn.functional.conv2d(x, folded["body.conv1.weight"], folded["body.conv1.bias"],
                                     stride=2, padding=3)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(40, 56), (72, 48)])
def test_network_matches_jax(weights, hw):
    """(72, 48): a stride-8 map of 9 rows, so the FPN's nearest resizes go
    from odd sizes (3 -> 5 -> 9 rows)."""
    _, params, net = weights
    x = np.random.RandomState(hw[0]).randn(1, *hw, 3).astype(np.float32)
    want = jax.jit(lambda p, v: jrf.RetinaFaceNet().apply({"params": p}, v))(params,
                                                                              jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(trf.priors_for(*hw)) == got[0].shape[1]
    for g, w in zip(got, want):
        assert 0.1 < np.abs(np.asarray(w)).max() < 100  # well-scaled outputs
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("hw", [(40, 56), (72, 48)])
def test_detect_faces_matches_jax(tmp_path, weights, hw):
    """The same rows through both detectors (written to a file, read by each
    package's loader), at a threshold some anchors pass. The heads' weights
    are scaled by 1 / 100, as the frame's values are about 100 times the
    network test's, so the box offsets stay near 1."""
    sd = {k: v / 100 if ("Head" in k and v.ndim == 4) else v for k, v in weights[0].items()}
    path = tmp_path / "detection_Resnet50_Final.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    frame = np.random.RandomState(sum(hw)).randint(0, 256, (*hw, 3)).astype(np.uint8)
    want = jrf.RetinaFaceDetector(str(path)).detect_faces(frame, conf_threshold=0.55)
    got = trf.RetinaFaceDetector(str(path), device="cpu").detect_faces(
        torch.from_numpy(frame), conf_threshold=0.55)
    assert len(want) > 1 and got.shape == want.shape
    np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5)
    np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
    np.testing.assert_allclose(got[:, 5:], want[:, 5:], atol=1e-3)
    assert trf.RetinaFaceDetector(str(path), device="cpu").detect_faces(
        torch.from_numpy(frame), conf_threshold=1.1).shape == (0, 15)


@pytest.mark.parametrize("hw", [(64, 64), (100, 52)])
def test_anchor_helpers_match_jax(hw):
    np.testing.assert_array_equal(trf.priors_for(*hw), jrf.priors_for(*hw))
    rs = np.random.RandomState(1)
    p = trf.priors_for(*hw)
    loc, ldm = rs.randn(len(p), 4).astype(np.float32), rs.randn(len(p), 10).astype(np.float32)
    np.testing.assert_array_equal(trf.decode_boxes(loc, p), jrf.decode_boxes(loc, p))
    np.testing.assert_array_equal(trf.decode_landmarks(ldm, p), jrf.decode_landmarks(ldm, p))
    boxes = np.sort(rs.rand(40, 4).astype(np.float32) * 60, axis=1)[:, [0, 1, 2, 3]]
    boxes[:, 2:] += boxes[:, :2]
    scores = rs.rand(40).astype(np.float32)
    assert trf.nms(boxes, scores, 0.4) == jrf.nms(boxes, scores, 0.4)


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="RetinaFace"):
        trf.RetinaFaceDetector(str(tmp_path / "absent.pth"), device="cpu")
