"""RealESRGAN x4 (RRDBNet, the anime_6B variant) and the `Upscaler` facade.

Counterpart of `controlanimate_tpu/models/upscaler.py` without the face
enhancer. `RRDBNet` keeps basicsr's module names (`conv_first`,
`body.{i}.rdb{r}.conv{c}`, `conv_body`, `conv_up1`, `conv_up2`, `conv_hr`,
`conv_last`), so a RealESRGAN `.pth` loads with plain `load_state_dict`. The
body runs the torch-literal concat dataflow of the dense blocks on
`F.conv2d` (the JAX package's `sum` and `s2d` forms are TPU layout choices);
the x4 tail (nearest-2x + conv_up1, nearest-2x + conv_up2, conv_hr, each with
leaky ReLU) runs on K4 (`ops/upconv_kernel.py`), as the JAX `RRDBNet._tail`
runs on its Pallas kernel, and `conv_last` on `F.conv2d`.

Parameters stay in fp32 and are cast at use: the network computes in the
dtype of its input, which the `Upscaler` sets to the run dtype (the flax
policy the JAX package follows), so K4's folded weights are bf16(w1 + w2) of
the fp32 weights. `RRDBNet` folds and casts them once per parameter version
and dtype, not once per call.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_lanczos4
from ..ops.upconv_kernel import conv3x3_lrelu, kernel_weights, upsample2x_conv3x3_lrelu

DEFAULT_MODEL_PATH = "models/Upscalers/RealESRGAN_x4plus_anime_6B.pth"
NET_SCALE = 4


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv3x3 (stride 1, padding 1) in x's dtype, on (B, C, H, W) views of
    any memory format."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), padding=1)


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def _hwio(conv: nn.Conv2d) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO, a view


class ResidualDenseBlock(nn.Module):
    """Five 3x3 convs, each reading the concat of the block input and every
    earlier output (basicsr `ResidualDenseBlock`); x + 0.2 * conv5."""

    def __init__(self, num_feat: int = 64, growth: int = 32):
        super().__init__()
        self.conv1 = nn.Conv2d(num_feat, growth, 3, 1, 1)
        self.conv2 = nn.Conv2d(num_feat + growth, growth, 3, 1, 1)
        self.conv3 = nn.Conv2d(num_feat + 2 * growth, growth, 3, 1, 1)
        self.conv4 = nn.Conv2d(num_feat + 3 * growth, growth, 3, 1, 1)
        self.conv5 = nn.Conv2d(num_feat + 4 * growth, num_feat, 3, 1, 1)

    def forward(self, x):
        feats = [x]
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats.append(_lrelu(_conv(conv, torch.cat(feats, 1))))
        return x + 0.2 * _conv(self.conv5, torch.cat(feats, 1))


class RRDB(nn.Module):
    def __init__(self, num_feat: int = 64, growth: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, growth)
        self.rdb2 = ResidualDenseBlock(num_feat, growth)
        self.rdb3 = ResidualDenseBlock(num_feat, growth)

    def forward(self, x):
        return x + 0.2 * self.rdb3(self.rdb2(self.rdb1(x)))


class RRDBNet(nn.Module):
    """x4 RRDBNet: (B, H, W, 3) in [0, 1] -> (B, 4H, 4W, 3), computed in the
    input's dtype. `num_block` 6 is RealESRGAN_x4plus_anime_6B."""

    def __init__(self, num_feat: int = 64, num_block: int = 6, growth: int = 32):
        super().__init__()
        self.conv_first = nn.Conv2d(3, num_feat, 3, 1, 1)
        self.body = nn.ModuleList([RRDB(num_feat, growth) for _ in range(num_block)])
        self.conv_body = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up1 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_up2 = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_hr = nn.Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv_last = nn.Conv2d(num_feat, 3, 3, 1, 1)
        # K4's weights by (conv name, dtype): ((data_ptr, _version, device) of
        # the weight they were made from, that weight, the packed weights)
        self._k4_weights: dict = {}

    def k4_weights(self, name: str, upsample: bool, dtype: torch.dtype) -> torch.Tensor:
        """The tail conv `name`'s weights in K4's layout and `dtype`
        (`kernel_weights`: folded in fp32 and rounded once when upsample),
        made once and kept until the weight is replaced, moved or changed in
        place. The entry holds the weight it was made from, so no new tensor
        can take its address while the entry lives."""
        w = getattr(self, name).weight
        stamp = (w.data_ptr(), w._version, w.device)
        hit = self._k4_weights.get((name, dtype))
        if hit is None or hit[0] != stamp:
            hit = (stamp, w.detach(), kernel_weights(_hwio(getattr(self, name)), dtype, upsample))
            self._k4_weights[(name, dtype)] = hit
        return hit[2]

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """conv_first, the RRDB trunk and conv_body with the residual:
        (B, H, W, 3) -> (B, H, W, num_feat). The convs run channels_last, so
        the NHWC result is a view that K4 reads without a copy."""
        h = x.permute(0, 3, 1, 2)  # NHWC memory as a channels_last NCHW view
        feat = _conv(self.conv_first, h)
        body = feat
        for block in self.body:
            body = block(body)
        return (feat + _conv(self.conv_body, body)).permute(0, 2, 3, 1)

    def tail(self, feat: torch.Tensor) -> torch.Tensor:
        """The x4 up-stage on K4, then conv_last: (B, H, W, num_feat) ->
        (B, 4H, 4W, 3)."""
        for name in ("conv_up1", "conv_up2"):
            conv = getattr(self, name)
            feat = upsample2x_conv3x3_lrelu(feat, _hwio(conv), conv.bias, "lrelu",
                                            packed=self.k4_weights(name, True, feat.dtype))
        feat = conv3x3_lrelu(feat, _hwio(self.conv_hr), self.conv_hr.bias, "lrelu",
                             packed=self.k4_weights("conv_hr", False, feat.dtype))
        return _conv(self.conv_last, feat.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tail(self.features(x))


def realesrgan_state_dict(obj) -> dict:
    """A basicsr checkpoint's state dict: `{"params_ema": sd}` (RealESRGAN's
    releases), `{"params": sd}`, the same flattened to `params_ema.` /
    `params.` prefixes, or a bare state dict; params_ema first, as the JAX
    `rrdbnet_params_from_torch` reads it."""
    for key in ("params_ema", "params"):
        if isinstance(obj.get(key), dict):
            return dict(obj[key])
        prefix = key + "."
        flat = {k[len(prefix):]: v for k, v in obj.items() if k.startswith(prefix)}
        if flat:
            return flat
    return dict(obj)


class Upscaler:
    """RealESRGAN x4 on uint8 frames, then a Lanczos4 resize to `scale` when
    it is not 4 (reference: modules/upscaler.py; the JAX `Upscaler` without
    the face enhancer, which is not ported).

    `model` is an `RRDBNet` to use as it is (moved to `device`); without one,
    the network is read from `model_path` (RealESRGAN_x4plus_anime_6B by
    default) with `torch.load(weights_only=True)`, and a missing file raises
    FileNotFoundError. `dtype` is the compute dtype (the run dtype); the
    parameters stay fp32 on `device`."""

    def __init__(self, scale: float, model: Optional[RRDBNet] = None,
                 model_path: Optional[str] = None, num_block: int = 6,
                 dtype: torch.dtype = torch.bfloat16, device="cuda"):
        if not (1 < scale < 8):
            raise ValueError("upscale must be within (1, 8) (reference: upscaler.py:64)")
        self.scale = float(scale)
        self.dtype = dtype
        self.device = torch.device(device)
        if model is None:
            path = Path(model_path or DEFAULT_MODEL_PATH)
            if not path.exists():
                raise FileNotFoundError(f"RealESRGAN weights not found at {path}")
            model = RRDBNet(num_block=num_block)
            sd = torch.load(str(path), map_location="cpu", weights_only=True)
            model.load_state_dict(realesrgan_state_dict(sd))
        self.model = model.to(self.device).eval()

    def chunk_frames(self, n: int, h: int, w: int) -> int:
        """Frames a pass through the network takes. The tail holds two
        (4H, 4W, num_feat) activations at once (up2's output while conv_hr
        writes its own; 537 MB a frame each at 2048^2 x 64 in bf16), and
        after them the 3-channel output in the compute dtype, fp32 and
        uint8. A chunk may use a sixth of the card's memory (8 frames of
        512^2 on an 80 GB H100), so the pipeline's models and the loop's
        buffers keep the rest. On the CPU every frame goes at once."""
        if self.device.type != "cuda":
            return n
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        nf = self.model.conv_hr.out_channels
        per_frame = 16 * h * w * (2 * nf * itemsize + 3 * (itemsize + 4 + 1))
        budget = torch.cuda.get_device_properties(self.device).total_memory // 6
        return max(1, min(n, budget // per_frame))

    def chunk_sizes(self, n: int, h: int, w: int) -> list[int]:
        """The frame counts of the passes `upscale_batch_device` makes over n
        frames of h x w; each pass launches K4 three times."""
        c = self.chunk_frames(n, h, w)
        return [min(c, n - i) for i in range(0, n, c)]

    @torch.no_grad()
    def upscale_batch_device(self, frames: torch.Tensor) -> torch.Tensor:
        """(F, H, W, 3) uint8 -> (F, int(H * scale), int(W * scale), 3) uint8
        on the upscaler's device, with no host round trip: x / 255 in fp32,
        the network in the compute dtype, clip(y * 255 + 0.5, 0, 255)
        truncated to uint8 (the JAX `_jit_tail_u8` formula, here in fp32; the
        JAX package evaluates it in the compute dtype, which in bf16 rounds
        y * 255 to 1 LSB steps above 128), then Lanczos4 when the scale is
        not 4."""
        frames = torch.as_tensor(frames).to(self.device)
        n, h, w = (int(s) for s in frames.shape[:3])
        out, i = [], 0
        for c in self.chunk_sizes(n, h, w):
            x = (frames[i:i + c].float() / 255.0).to(self.dtype)
            i += c
            y = self.model(x).float()
            u8 = torch.clamp(y * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
            if abs(self.scale - NET_SCALE) > 1e-6:
                u8 = resize_lanczos4(u8, int(h * self.scale), int(w * self.scale))
            out.append(u8)
        return out[0] if len(out) == 1 else torch.cat(out)

    def upscale_batch(self, frames: np.ndarray) -> np.ndarray:
        """(F, H, W, 3) uint8 on the host -> upscaled uint8 on the host."""
        frames = torch.from_numpy(np.asarray(frames, np.uint8))
        return self.upscale_batch_device(frames).cpu().numpy()

    def process_batch(self, frames: np.ndarray) -> np.ndarray:
        """The JAX `process_batch` without a face enhancer: `upscale_batch`."""
        return self.upscale_batch(frames)

    def __call__(self, frame: np.ndarray) -> np.ndarray:
        return self.process_batch(np.asarray(frame)[None])[0]
