"""The port's GFPGANv1Clean (`models/gfpgan.py`) against the JAX package's on
the CPU, at a tiny width (out_size 32, style 16, narrow 1/16 and 1/8; the
`FaceEnhancer(model_kwargs=...)` seam of the JAX tests): the whole network
on weights carried by `weights/from_jax.py`, with the JAX decoder's own
noise draws fed through the port's `FaceNoise`; the antialiased "down" and
the 2x "up" resizes of a `ResBlock` at their borders; the checkpoint loader
(`params_ema` nested or flattened, or bare; the style MLP and `toRGB` keys
dropped; modulated weights of shape (1, O, C, k, k)) against the JAX
loader; and the mapping, which must cover every leaf of the JAX tree.

Gates: the network and the blocks at atol 1e-4, rtol 1e-4 in fp32, on
weights scaled so every activation stays near 1; the loaders exactly."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models import gfpgan as jg
from controlanimate_tpu_torch.models import gfpgan as tg
from controlanimate_tpu_torch.weights import from_jax
from test_retinaface import _leaf_items

SIZE = 32
KW = [dict(num_style_feat=16, narrow=1 / 16), dict(num_style_feat=16, narrow=1 / 8)]


class JaxFaceNoise:
    """The JAX decoder's draws as a port `FaceNoise`: normal(fold_in(
    PRNGKey(0), number), (B, H, W, 1)), as (B, 1, H, W)."""

    def draw(self, number, shape):
        B, _, H, W = shape
        z = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), number), (B, H, W, 1))
        return torch.from_numpy(np.array(z)).permute(0, 3, 1, 2)


def _set(tree, path, value):
    *head, last = path.split("/")
    for part in head:
        tree = tree[part]
    tree[last] = value


def gfpgan_params(shapes, seed: int) -> dict:
    """Seeded JAX GFPGAN parameters with every activation near 1: conv and
    dense kernels N(0, 1 / fan-in), modulated weights N(0, 1 / (C k k)),
    biases N(0, 0.05^2), the modulations' biases 1 + N(0, 0.1^2), noise
    weights 0.1 + N(0, 0.02^2)."""
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    for path, leaf in _leaf_items(shapes):
        shape, name = tuple(leaf.shape), path.rsplit("/", 1)[-1]
        if name == "kernel":
            val = rs.randn(*shape) / math.sqrt(np.prod(shape[:-1]))
        elif name == "weight":  # modulated conv (O, C, k, k)
            val = rs.randn(*shape) / math.sqrt(np.prod(shape[1:]))
        elif name == "noise_weight":
            val = 0.1 + rs.randn(*shape) * 0.02
        elif name == "constant_input":
            val = rs.randn(*shape)
        elif path.endswith("modulation/bias"):
            val = 1.0 + rs.randn(*shape) * 0.1
        else:
            val = rs.randn(*shape) * 0.05
        _set(params, path, np.asarray(val, np.float32))
    return params


def gfpgan_pair(kw, seed: int = 0):
    """(JAX model, JAX params, port model) on the same weights."""
    jmodel = jg.GFPGANv1Clean(out_size=SIZE, **kw)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, SIZE, SIZE, 3))))["params"]
    params = gfpgan_params(shapes, seed)
    tmodel = tg.GFPGANv1Clean(out_size=SIZE, **kw).eval()
    tmodel.load_state_dict(from_jax.gfpgan_state_dict(params, SIZE))
    return jmodel, params, tmodel


@pytest.mark.parametrize("kw", KW, ids=["narrow16", "narrow8"])
def test_network_matches_jax(kw):
    jmodel, params, tmodel = gfpgan_pair(kw)
    x = np.random.RandomState(1).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: jmodel.apply({"params": p}, v))(params,
                                                                           jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2), JaxFaceNoise())
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    assert 0.1 < np.abs(want).max() < 100
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    # the noise is part of the result: other draws move it
    with torch.no_grad():
        other = tmodel(torch.from_numpy(x).permute(0, 3, 1, 2), tg.SeededNoise(0))
    assert not np.allclose(other.permute(0, 2, 3, 1).numpy(), want, atol=1e-3)


@pytest.mark.parametrize("mode", ["down", "up"])
@pytest.mark.parametrize("hw", [(8, 8), (10, 6)])
def test_resblock_resizes_match_jax(mode, hw):
    """The border rows and columns of the 0.5x antialiased and the 2x
    bilinear resizes, through one ResBlock at odd and even sizes."""
    jblock = jg.ResBlock(5, mode=mode)
    x = np.random.RandomState(2).randn(1, *hw, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jblock.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = gfpgan_params(shapes["params"], 3)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    block = tg.ResBlock(3, 5, mode)
    sd = {}
    for name in ("conv1", "conv2", "skip"):
        sd[f"{name}.weight"] = torch.from_numpy(np.transpose(params[name]["kernel"], (3, 2, 0, 1)))
        if name != "skip":
            sd[f"{name}.bias"] = torch.from_numpy(params[name]["bias"])
    block.load_state_dict(sd)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def test_mapping_covers_the_jax_tree_and_the_port():
    for size, kw in ((SIZE, KW[0]), (512, {})):
        shapes = jax.eval_shape(lambda: jg.GFPGANv1Clean(out_size=size, **kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3))))["params"]
        entries = list(from_jax.gfpgan_mapping(size))
        assert {f for _, f, _ in entries} == {p for p, _ in _leaf_items(shapes)}
        with torch.device("meta"):
            port = tg.GFPGANv1Clean(out_size=size, **kw).state_dict()
        assert {t for t, _, _ in entries} == set(port)


def _checkpoint(tmodel, rs):
    """A GFPGANv1.3-layout state dict of `tmodel`'s weights, with the style
    MLP and the training-only RGB heads an upstream checkpoint carries."""
    sd = {k: v.clone() for k, v in tmodel.state_dict().items()}
    style = tmodel.num_style_feat
    for i in range(1, 17, 2):
        sd[f"stylegan_decoder.style_mlp.{i}.weight"] = torch.from_numpy(
            rs.randn(style, style).astype(np.float32))
        sd[f"stylegan_decoder.style_mlp.{i}.bias"] = torch.zeros(style)
    sd["toRGB.0.weight"] = torch.from_numpy(rs.randn(3, 8, 1, 1).astype(np.float32))
    sd["toRGB.0.bias"] = torch.zeros(3)
    return sd


@pytest.mark.parametrize("layout", ["params_ema", "flat_params_ema", "bare"])
def test_loader_matches_the_jax_loader(tmp_path, layout):
    """A checkpoint written with torch.save: the port reads it into the
    network with plain load_state_dict, and what it reads equals the JAX
    loader's tree carried across."""
    _, _, tmodel = gfpgan_pair(KW[0], seed=5)
    sd = _checkpoint(tmodel, np.random.RandomState(6))
    obj = {  # params_ema is read before params, as GFPGAN's releases hold both
        "params_ema": {"params_ema": sd, "params": {k: 0 * v for k, v in sd.items()}},
        "flat_params_ema": {f"params_ema.{k}": v for k, v in sd.items()},
        "bare": sd,
    }[layout]
    path = tmp_path / "GFPGANv1.3.pth"
    torch.save(obj, path)
    model = tg.load_gfpgan(path, out_size=SIZE, **KW[0])
    jparams = jg.gfpgan_params_from_torch({k: v.numpy() for k, v in sd.items()}, out_size=SIZE)
    want = from_jax.gfpgan_state_dict(jparams, SIZE)
    got = model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k].reshape(got[k].shape), atol=0, rtol=0)
    assert tuple(got["stylegan_decoder.style_conv1.modulated_conv.weight"].shape)[0] == 1


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError, match="GFPGAN"):
        tg.load_gfpgan(tmp_path / "absent.pth", out_size=SIZE, **KW[0])
