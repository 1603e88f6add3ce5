"""The port's RealESRGAN upscaler against the JAX package's on the CPU:
`RRDBNet` on weights carried by `weights/from_jax.py`, loading a basicsr
checkpoint, the `Upscaler`'s uint8 output against the JAX `Upscaler` (its
XLA path and its Pallas-tail path), the scale range and a missing file, and
the Lanczos4 resize against OpenCV.

Gates: the network at atol 1e-4, rtol 1e-3 (tests/test_upscaler.py's gate
against its torch mirror); uint8 frames within 1 LSB (a value at a .5
boundary of y * 255 + 0.5 may truncate the other way after a summation in
another order); the resize within 1 LSB of cv2, with the share of exact
values recorded."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlanimate_tpu.models.upscaler import RRDBNet as JaxRRDBNet
from controlanimate_tpu_torch.models.upscaler import RRDBNet, Upscaler, realesrgan_state_dict
from controlanimate_tpu_torch.ops.resize import resize_lanczos4
from controlanimate_tpu_torch.weights import from_jax
from test_torch_common import random_params, seeded_rrdbnet, upscaler_pair


def _frames(n, h, w, seed):
    """Smooth uint8 frames with noise: gradients the network does not clip."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    out = []
    for i in range(n):
        base = np.stack([128 + 90 * np.sin((xx + 2 * i) / 5.0), 60 + 2.0 * yy,
                         128 + 80 * np.cos((xx + yy - i) / 7.0)], axis=-1)
        out.append(np.clip(base + rs.randn(h, w, 3) * 6, 0, 255))
    return np.stack(out).astype(np.uint8)


def _assert_u8_close(a, b):
    diff = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("num_feat,num_block,form", [(16, 1, "sum"), (16, 2, "s2d"),
                                                     (64, 1, "concat")])
def test_rrdbnet_matches_jax(num_feat, num_block, form):
    """The JAX RRDBNet's whole network (XLA convs) against the port's (body
    on F.conv2d, tail on K4's plain version), on weights carried across."""
    jnet = JaxRRDBNet(num_feat=num_feat, num_block=num_block, form=form)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    params = random_params(shapes["params"], seed=num_feat + num_block, scale=0.05)
    x = np.random.RandomState(1).rand(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(x)))
    net = RRDBNet(num_feat=num_feat, num_block=num_block)
    net.load_state_dict(from_jax.rrdbnet_state_dict(params, num_block))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 32, 24, 3)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_rrdbnet_tail_matches_jax_pallas_tail():
    """The port's tail (K4's plain version) against the JAX `_tail` (the
    Pallas kernels in interpret mode) on the same body features."""
    jnet = JaxRRDBNet(num_feat=32, num_block=1, form="sum")
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    params = random_params(shapes["params"], seed=9, scale=0.05)
    feat = np.random.RandomState(2).randn(1, 8, 16, 32).astype(np.float32)
    want = np.asarray(jnet.apply({"params": params}, jnp.asarray(feat), mode="tail"))
    net = RRDBNet(num_feat=32, num_block=1)
    net.load_state_dict(from_jax.rrdbnet_state_dict(params, 1))
    with torch.no_grad():
        got = net.tail(torch.from_numpy(feat)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("layout", ["params_ema", "params", "flat_params_ema", "bare"])
def test_loads_a_basicsr_checkpoint(tmp_path, layout):
    """A RealESRGAN-layout `.pth` written with torch.save loads with plain
    `load_state_dict` after the basicsr unwrapping; the Upscaler reading it
    computes what the network it was written from computes."""
    net = seeded_rrdbnet(num_feat=64, num_block=1, seed=3)
    sd = net.state_dict()
    layouts = {
        # params_ema is read before params, as RealESRGAN's releases hold both
        "params_ema": {"params_ema": sd, "params": {k: 0 * v for k, v in sd.items()}},
        "params": {"params": sd},
        "flat_params_ema": {f"params_ema.{k}": v for k, v in sd.items()},
        "bare": sd,
    }
    path = tmp_path / "RealESRGAN_tiny.pth"
    torch.save(layouts[layout], path)
    assert realesrgan_state_dict(torch.load(path, weights_only=True)).keys() == sd.keys()
    up = Upscaler(4.0, model_path=str(path), num_block=1, dtype=torch.float32, device="cpu")
    frames = _frames(2, 8, 8, seed=4)
    ref = Upscaler(4.0, model=net, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(up.upscale_batch(frames), ref.upscale_batch(frames))


@pytest.mark.parametrize("scale", [4.0, 2.0])
@pytest.mark.parametrize("up_kernel", ["0", "force"])
def test_upscaler_matches_jax(tmp_path, monkeypatch, up_kernel, scale):
    """uint8 frames of the port's Upscaler against the JAX Upscaler with its
    XLA network (CONTROLANIMATE_UP_KERNEL=0) and with its Pallas tail in
    interpret mode (=force), through the host and the device entries; at
    scale 2 the JAX side resizes with cv2's Lanczos4."""
    monkeypatch.setenv("CONTROLANIMATE_UP_KERNEL", up_kernel)
    jup, tup = upscaler_pair(tmp_path / "w.pth", scale=scale, num_feat=64, num_block=1, seed=5)
    frames = _frames(2, 8, 8, seed=6)
    want = jup.upscale_batch(frames)
    got = tup.upscale_batch(frames)
    assert got.shape == want.shape == (2, int(8 * scale), int(8 * scale), 3)
    assert got.dtype == np.uint8
    _assert_u8_close(got, want)
    dev = tup.upscale_batch_device(torch.from_numpy(frames))
    assert dev.dtype == torch.uint8
    np.testing.assert_array_equal(dev.numpy(), got)
    _assert_u8_close(tup(frames[0]), want[0])
    if scale == 4.0:
        _assert_u8_close(got, np.asarray(jup.upscale_batch_device(jnp.asarray(frames))))


def test_upscaler_scale_range_and_missing_file(tmp_path):
    net = seeded_rrdbnet()
    for bad in (1.0, 8.0, 0.5):
        with pytest.raises(ValueError, match="within"):
            Upscaler(bad, model=net, device="cpu")
    for ok in (1.5, 7.9):
        assert Upscaler(ok, model=net, device="cpu").scale == ok
    with pytest.raises(FileNotFoundError, match="RealESRGAN"):
        Upscaler(4.0, model_path=str(tmp_path / "absent.pth"), device="cpu")


def test_chunks_cover_every_frame():
    up = Upscaler(4.0, model=seeded_rrdbnet(), dtype=torch.float32, device="cpu")
    assert up.chunk_sizes(5, 8, 8) == [5]  # the CPU takes every frame at once
    up.chunk_frames = lambda n, h, w: 2
    assert up.chunk_sizes(5, 8, 8) == [2, 2, 1]
    frames = _frames(5, 8, 8, seed=7)
    whole = Upscaler(4.0, model=up.model, dtype=torch.float32, device="cpu")
    # the convs may sum in another order at another batch size
    _assert_u8_close(up.upscale_batch(frames), whole.upscale_batch(frames))


@pytest.mark.parametrize("scale", [2, 3, 6])
def test_resize_lanczos4_matches_cv2(scale, record_property):
    """The x4 output resized to `scale` (0.5x, 0.75x and 1.5x of it), as
    the JAX `_post_resize` does with cv2: within 1 LSB; the exact share is
    recorded (seen: 1.0)."""
    src = np.concatenate([_frames(2, 64, 48, seed=8),
                          np.random.RandomState(9).randint(0, 256, (1, 64, 48, 3), np.uint8)])
    h, w = int(16 * scale), int(12 * scale)
    want = np.stack([cv2.resize(f, (w, h), interpolation=cv2.INTER_LANCZOS4) for f in src])
    got = resize_lanczos4(torch.from_numpy(src), h, w).numpy()
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    record_property("exact_share", float((diff == 0).mean()))
    assert diff.max() <= 1, (diff.max(), (diff > 0).mean())


def test_tail_folds_k4_weights_once_per_parameter_version(monkeypatch):
    """The tail hands K4 weights folded and cast once per parameter version
    and dtype: a second forward folds nothing; an in-place update of one
    conv's weight (its `_version` moves, its address does not) refolds that
    conv alone, and the new weights are the fold of the updated ones; a new
    dtype folds again."""
    from controlanimate_tpu_torch.models import upscaler as up_mod
    from controlanimate_tpu_torch.ops import upconv_kernel as uk

    folds = []

    def counting(weight, dtype, upsample):
        folds.append((dtype, upsample))
        return uk.kernel_weights(weight, dtype, upsample)

    monkeypatch.setattr(up_mod, "kernel_weights", counting)
    net = RRDBNet(num_feat=32, num_block=1)
    feat = torch.from_numpy(np.random.RandomState(2).randn(1, 4, 5, 32).astype(np.float32))
    with torch.no_grad():
        first = net.tail(feat)
        assert len(folds) == 3
        packed = net.k4_weights("conv_up2", True, torch.float32)
        assert net.tail(feat).equal(first) and len(folds) == 3
        ptr = net.conv_up2.weight.data_ptr()
        net.conv_up2.weight.mul_(0.5)
    assert net.conv_up2.weight.data_ptr() == ptr
    with torch.no_grad():
        net.tail(feat)
    assert folds[3:] == [(torch.float32, True)]
    refolded = net.k4_weights("conv_up2", True, torch.float32)
    assert refolded is not packed
    torch.testing.assert_close(refolded, uk.kernel_weights(
        net.conv_up2.weight.permute(2, 3, 1, 0), torch.float32, True), rtol=0, atol=0)
    torch.testing.assert_close(refolded, 0.5 * packed, rtol=0, atol=0)
    net.k4_weights("conv_hr", False, torch.bfloat16)
    assert folds[4:] == [(torch.bfloat16, False)]
