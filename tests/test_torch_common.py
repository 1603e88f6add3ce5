"""Shared fixtures of the port's parity tests, and the weight-carrying tests.

The port (`controlanimate_tpu_torch`) is held against the JAX package on the
same inputs and weights: parameter shapes come from the JAX model
(`jax.eval_shape`, no init compile), values from a seeded numpy generator,
and `controlanimate_tpu_torch.weights.from_jax` carries them into the port's
modules. Everything runs in fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.config import MotionModuleConfig as JaxMotionConfig
from controlanimate_tpu.models.clip import CLIPTextConfig as JaxCLIPConfig
from controlanimate_tpu.models.clip import CLIPTextModel as JaxCLIP
from controlanimate_tpu.models.unet3d import UNet3DConditionModel as JaxUNet
from controlanimate_tpu.models.unet3d import UNet3DConfig as JaxUNetConfig
from controlanimate_tpu.models.upscaler import RRDBNet as JaxRRDBNet
from controlanimate_tpu.models.upscaler import Upscaler as JaxUpscaler
from controlanimate_tpu.models.vae import AutoencoderKL as JaxVAE
from controlanimate_tpu_torch.config import MotionModuleConfig
from controlanimate_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from controlanimate_tpu_torch.models.unet3d import UNet3DConditionModel, UNet3DConfig
from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler
from controlanimate_tpu_torch.models.vae import AutoencoderKL
from controlanimate_tpu_torch.weights import from_jax

# the tiny LCM UNet of tests/test_engine.py (LCM_UCFG), the tiny UNet of
# tests/test_unet3d.py, and the tiny VAE of tests/test_vae.py
LCM_UNET = dict(
    block_out_channels=(8, 16), layers_per_block=1,
    down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
    up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
    attention_heads=2, cross_attention_dim=16, norm_num_groups=4, time_cond_proj_dim=8,
)
LCM_MOTION = dict(num_attention_heads=2, temporal_position_encoding_max_len=8)
TINY_UNET = dict(
    block_out_channels=(32, 64), layers_per_block=1,
    down_block_types=("CrossAttnDownBlock3D", "DownBlock3D"),
    up_block_types=("UpBlock3D", "CrossAttnUpBlock3D"),
    attention_heads=4, cross_attention_dim=24, norm_num_groups=8,
)
TINY_MOTION = dict(num_attention_heads=4, temporal_position_encoding_max_len=8)
VAE_CH = (8, 16, 16, 16)
VAE_GROUPS = 4
CLIP = dict(vocab_size=514, hidden_size=16, num_layers=2, num_heads=2, intermediate_size=32,
            eos_token_id=513)


def random_params(shapes, seed: int, scale: float = 0.25):
    """Replace every leaf of a shape tree with seeded N(0, scale^2) values;
    norm scales get 1 + noise so activations stay well conditioned."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    leaves = []
    for path, s in flat:
        val = rng.randn(*s.shape).astype(np.float32) * scale
        if getattr(path[-1], "key", None) == "scale":
            val += 1.0
        leaves.append(val)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def unet_pair(kw=LCM_UNET, motion=LCM_MOTION, seed: int = 0):
    """(jax model, jax params, port model) with the same random weights."""
    jcfg = JaxUNetConfig(**kw, motion=JaxMotionConfig(**motion))
    jmodel = JaxUNet(jcfg)
    init_kw = {}
    if kw.get("time_cond_proj_dim"):
        init_kw["timestep_cond"] = jnp.zeros((1, kw["time_cond_proj_dim"]))
    shapes = jax.eval_shape(
        lambda: jmodel.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 2, 8, 8, 4)), jnp.asarray([1]),
            jnp.zeros((1, 7, kw["cross_attention_dim"])), **init_kw,
        )["params"]
    )
    params = random_params(shapes, seed)
    tcfg = UNet3DConfig(**kw, motion=MotionModuleConfig(**motion))
    tmodel = UNet3DConditionModel(tcfg).eval()
    tmodel.load_state_dict(from_jax.unet_state_dict(params, tcfg))
    return jmodel, params, tmodel


def vae_pair(seed: int = 1):
    jmodel = JaxVAE(block_out_channels=VAE_CH, groups=VAE_GROUPS)
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    )
    params = random_params(shapes, seed, scale=0.2)
    tmodel = AutoencoderKL(block_out_channels=VAE_CH, groups=VAE_GROUPS).eval()
    tmodel.load_state_dict(from_jax.vae_state_dict(params, VAE_CH))
    return jmodel, params, tmodel


def clip_pair(seed: int = 2, **overrides):
    kw = {**CLIP, **overrides}
    jmodel = JaxCLIP(JaxCLIPConfig(**kw))
    shapes = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32))["params"]
    )
    params = random_params(shapes, seed)
    tcfg = CLIPTextConfig(**kw)
    tmodel = CLIPTextModel(tcfg).eval()
    tmodel.load_state_dict(from_jax.clip_text_state_dict(params, tcfg))
    return jmodel, params, tmodel


@pytest.mark.parametrize("kw,motion", [(LCM_UNET, LCM_MOTION), (TINY_UNET, TINY_MOTION)])
def test_unet_mapping_is_the_port_state_dict(kw, motion):
    """The carried-over keys and shapes are exactly the port's state_dict
    (load_state_dict above is strict; this also pins the shapes)."""
    cfg = UNet3DConfig(**kw, motion=MotionModuleConfig(**motion))
    sd = UNet3DConditionModel(cfg).state_dict()
    _, params, _ = unet_pair(kw, motion)
    carried = from_jax.unet_state_dict(params, cfg)
    assert set(carried) == set(sd)
    for k, v in carried.items():
        assert tuple(v.shape) == tuple(sd[k].shape), k


def test_vae_and_clip_mapping_is_the_port_state_dict():
    _, vparams, _ = vae_pair()
    vsd = AutoencoderKL(block_out_channels=VAE_CH, groups=VAE_GROUPS).state_dict()
    carried = from_jax.vae_state_dict(vparams, VAE_CH)
    assert set(carried) == set(vsd)
    assert all(tuple(v.shape) == tuple(vsd[k].shape) for k, v in carried.items())

    _, cparams, _ = clip_pair()
    csd = CLIPTextModel(CLIPTextConfig(**CLIP)).state_dict()
    carried = from_jax.clip_text_state_dict(cparams, CLIPTextConfig(**CLIP))
    assert set(carried) == set(csd)
    assert all(tuple(v.shape) == tuple(csd[k].shape) for k, v in carried.items())


def test_full_width_unet_mapping_matches_port_keys():
    """At SD1.5 width (no weights materialised: meta device) the table yields
    every key of the port's UNet with the LCM cond projection."""
    cfg = UNet3DConfig(time_cond_proj_dim=256)
    with torch.device("meta"):
        sd = UNet3DConditionModel(cfg).state_dict()
    keys = [t for t, _, _ in from_jax.unet_mapping(cfg)]
    assert len(keys) == len(set(keys))
    assert set(keys) == set(sd)


def test_rrdbnet_mapping_is_the_port_state_dict():
    keys = [t for t, _, _ in from_jax.rrdbnet_mapping(2)]
    assert len(keys) == len(set(keys))
    assert set(keys) == set(RRDBNet(num_feat=16, num_block=2).state_dict())


def seeded_rrdbnet(num_feat: int = 16, num_block: int = 1, seed: int = 0) -> RRDBNet:
    """A port RRDBNet with seeded weights whose uint8 output is rarely
    clipped: lecun-normal conv weights, biases N(0, 0.05^2), and conv_last's
    bias 0.5 (outputs about 0.4 +- 0.1 on smooth frames)."""
    net = RRDBNet(num_feat=num_feat, num_block=num_block)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in net.parameters():
            std = 1.0 / np.sqrt(p[0].numel()) if p.ndim == 4 else 0.05
            p.copy_(torch.randn(p.shape, generator=g) * std)
        net.conv_last.bias.fill_(0.5)
    return net.eval()


def upscaler_pair(path, scale: float = 4.0, num_feat: int = 16, num_block: int = 1,
                  seed: int = 0):
    """(JAX Upscaler, port Upscaler) on the same seeded weights, fp32 on the
    CPU. The weights go through a basicsr-layout checkpoint written to
    `path` with torch.save, which the JAX Upscaler reads; it builds a
    64-feature RRDBNet, so at another width it is given the network its
    weights are for. The port's Upscaler takes the network itself."""
    net = seeded_rrdbnet(num_feat, num_block, seed)
    torch.save({"params_ema": net.state_dict()}, path)
    jup = JaxUpscaler(scale, model_path=str(path), num_block=num_block)
    if num_feat != 64:
        jup.model = JaxRRDBNet(num_feat=num_feat, num_block=num_block, form=jup.model.form,
                               dtype=jup.model.dtype)
    return jup, Upscaler(scale, model=net, dtype=torch.float32, device="cpu")


class JaxDraws:
    """The JAX engine's own draws as a port `NoiseSource`: (k_prep, k_loop) =
    split(key), (k_noise, k_in, k_out) = split(k_prep, 3), fold_in(k_loop, i)
    per step (the key tree of tests/test_engine.py)."""

    def __init__(self, key):
        k_prep, self.k_loop = jax.random.split(key)
        self.k_noise, self.k_in, self.k_out = jax.random.split(k_prep, 3)

    @staticmethod
    def _draw(key, shape):
        return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape), jnp.float32)))

    def initial(self, shape):
        return self._draw(self.k_noise, shape)

    def encode(self, shape):
        return self._draw(self.k_in, shape)

    def last_output(self, shape):
        return self._draw(self.k_out, shape)

    def step(self, i, shape):
        return self._draw(jax.random.fold_in(self.k_loop, i), shape)
