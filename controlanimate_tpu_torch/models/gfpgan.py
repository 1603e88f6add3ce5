"""GFPGAN v1.3 / v1.4 (clean architecture) and the `FaceEnhancer`.

Counterpart of `controlanimate_tpu/models/gfpgan.py`: a U-Net encoder that
yields per-resolution SFT conditions (scale, shift) and a style code, and
a clean StyleGAN2 decoder modulated by them. The modules keep the torch
checkpoint's key names, so `gfpgan_state_dict` (take `params_ema`, drop the
style MLP and the training-only `toRGB` heads) gives a plain
`load_state_dict`; a modulated conv's weight keeps its (1, O, C, k, k)
shape. Where the JAX package departs from upstream GFPGAN, the port follows
the JAX package:

- `conv_body_first` has ch[512] outputs whatever `out_size` is;
- the encoder's "down" resize is `jax.image.resize(..., "bilinear")`, which
  antialiases: weights 1/8, 3/8, 3/8, 1/8, renormalised at the edges
  (`F.interpolate(antialias=True)`), not upstream's plain bilinear;
- `final_linear` reads the 4x4 feature flattened in (h, w, c) order with
  the checkpoint's weight as it is (upstream flattens (c, h, w));
- the decoder's noise: the JAX decoder draws it with `PRNGKey(0)` folded
  with 0, conv_idx + 1 and 1000 + conv_idx, the same draws for every face.
  Here a `FaceNoise` gives it, by that fold-in number and shape; the
  default `SeededNoise` draws once per (number, shape) from a seeded
  `torch.Generator` on the model's device. That is not JAX's stream; the
  tests feed the JAX draws.

The networks compute in fp32 with TF32 off (`fp32_convs`), as the JAX
package computes them in fp32 whatever the run dtype.

`FaceEnhancer` is facexlib's FaceRestoreHelper as the JAX package runs it:
RetinaFace 5-point landmarks (faces with eyes under 5 px apart skipped),
FFHQ alignment at `face_size`, GFPGAN on each crop, and the paste through
the scaled inverse affine under the soft mask (`models/face_align.py`), all
on the frame's device. JAX behaviour not copied: without the RetinaFace
file the JAX enhancer falls back to OpenCV's Haar cascade and synthesised
landmarks; the port raises FileNotFoundError.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Protocol

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.resize import resize_lanczos4
from ..ops.warp import fp32_convs
from . import face_align
from .retinaface import RetinaFaceDetector

DEFAULT_PATH = "models/Upscalers/GFPGANv1.3.pth"
# checkpoint keys the inference network does not use: the style MLP
# (bypassed with input_is_latent) and the intermediate RGB heads of training
UNUSED_PREFIXES = ("stylegan_decoder.style_mlp.", "toRGB.")


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def channels(narrow: float = 1.0, cm: int = 2) -> dict[int, int]:
    return {
        4: int(512 * narrow), 8: int(512 * narrow), 16: int(512 * narrow),
        32: int(512 * narrow), 64: int(256 * cm * narrow), 128: int(128 * cm * narrow),
        256: int(64 * cm * narrow), 512: int(32 * cm * narrow),
    }


def _up2(x: torch.Tensor) -> torch.Tensor:
    return F.interpolate(x, scale_factor=2.0, mode="bilinear", align_corners=False)


class FaceNoise(Protocol):
    """The decoder's noise: a float32 tensor of `shape` (B, 1, H, W) for
    the StyleConv whose JAX key is fold_in(PRNGKey(0), `number`)."""

    def draw(self, number: int, shape) -> torch.Tensor: ...


class SeededNoise:
    """The default `FaceNoise`: N(0, 1) from a `torch.Generator` on
    `device` seeded with seed * 1_000_003 + number, drawn once per (number,
    shape) and kept, so every face gets the same draws (as in JAX)."""

    def __init__(self, seed: int = 0, device="cpu"):
        self.seed, self.device = int(seed), torch.device(device)
        self._cache: dict = {}

    def draw(self, number: int, shape) -> torch.Tensor:
        key = (number, tuple(shape))
        if key not in self._cache:
            g = torch.Generator(device=self.device)
            g.manual_seed(self.seed * 1_000_003 + number)
            self._cache[key] = torch.randn(key[1], generator=g, device=self.device)
        return self._cache[key]


class ResBlock(nn.Module):
    """conv1 -> lrelu -> bilinear resize (x0.5 antialiased or x2) -> conv2
    -> lrelu, plus a 1x1 skip of the resized input."""

    def __init__(self, cin: int, cout: int, mode: str = "down"):
        super().__init__()
        self.mode = mode
        self.conv1 = nn.Conv2d(cin, cin, 3, 1, 1)
        self.conv2 = nn.Conv2d(cin, cout, 3, 1, 1)
        self.skip = nn.Conv2d(cin, cout, 1, bias=False)

    def _resize(self, x):
        if self.mode == "down":
            size = (int(x.shape[2] * 0.5), int(x.shape[3] * 0.5))
            return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                                 antialias=True)
        return _up2(x)

    def forward(self, x):
        out = lrelu(self.conv2(self._resize(lrelu(self.conv1(x)))))
        return out + self.skip(self._resize(x))


class ModulatedConv(nn.Module):
    """Style-modulated conv, clean variant (no equalised-lr scale): one
    weight per sample, run as a grouped conv."""

    def __init__(self, cin: int, cout: int, k: int, num_style_feat: int, demodulate: bool = True,
                 upsample: bool = False, eps: float = 1e-8):
        super().__init__()
        self.k, self.demodulate, self.upsample, self.eps = k, demodulate, upsample, eps
        self.weight = nn.Parameter(torch.randn(1, cout, cin, k, k) / math.sqrt(cin * k * k))
        self.modulation = nn.Linear(num_style_feat, cin)
        nn.init.ones_(self.modulation.bias)

    def forward(self, x, style):
        B, C, H, W = x.shape
        w = self.weight * self.modulation(style)[:, None, :, None, None]  # (B, O, C, k, k)
        if self.demodulate:
            w = w * torch.rsqrt(w.pow(2).sum((2, 3, 4)) + self.eps)[:, :, None, None, None]
        if self.upsample:
            x = _up2(x)
        out = F.conv2d(x.reshape(1, B * C, *x.shape[2:]), w.reshape(-1, C, self.k, self.k),
                       padding=self.k // 2, groups=B)
        return out.reshape(B, -1, *out.shape[2:])


class StyleConv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, num_style_feat: int, upsample: bool = False):
        super().__init__()
        self.modulated_conv = ModulatedConv(cin, cout, k, num_style_feat, upsample=upsample)
        self.weight = nn.Parameter(torch.zeros(1))  # the noise's weight
        self.bias = nn.Parameter(torch.zeros(1, cout, 1, 1))

    def forward(self, x, style, noise):
        out = self.modulated_conv(x, style) + self.weight * noise
        return lrelu(out + self.bias) * math.sqrt(2)


class ToRGB(nn.Module):
    def __init__(self, cin: int, num_style_feat: int):
        super().__init__()
        self.modulated_conv = ModulatedConv(cin, 3, 1, num_style_feat, demodulate=False)
        self.bias = nn.Parameter(torch.zeros(1, 3, 1, 1))

    def forward(self, x, style, skip=None):
        out = self.modulated_conv(x, style) + self.bias
        return out if skip is None else out + _up2(skip)


class ConstantInput(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.randn(1, c, 4, 4))


class StyleGAN2GeneratorCSFT(nn.Module):
    """The clean StyleGAN2 decoder with spatial feature transforms on half
    the channels of each resolution's first conv (`sft_half`)."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512, channel_multiplier: int = 2,
                 narrow: float = 1.0, sft_half: bool = True):
        super().__init__()
        ch = channels(narrow, channel_multiplier)
        self.sft_half = sft_half
        self.log_size = int(math.log2(out_size))
        self.constant_input = ConstantInput(ch[4])
        self.style_conv1 = StyleConv(ch[4], ch[4], 3, num_style_feat)
        self.to_rgb1 = ToRGB(ch[4], num_style_feat)
        self.style_convs, self.to_rgbs = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for res_log in range(3, self.log_size + 1):
            c = ch[2**res_log]
            self.style_convs.append(StyleConv(cin, c, 3, num_style_feat, upsample=True))
            self.style_convs.append(StyleConv(c, c, 3, num_style_feat))
            self.to_rgbs.append(ToRGB(c, num_style_feat))
            cin = c

    def forward(self, latent, conditions, noise: FaceNoise):
        """latent: (B, num_latent, style); conditions: [scale0, shift0,
        scale1, shift1, ...], (B, C', H, W) a resolution."""
        B = latent.shape[0]
        out = self.constant_input.weight.expand(B, -1, -1, -1)
        out = self.style_conv1(out, latent[:, 0], noise.draw(0, (B, 1, 4, 4)))
        skip = self.to_rgb1(out, latent[:, 1])
        for j, res_log in enumerate(range(3, self.log_size + 1)):
            k, shape = 2 * j, (B, 1, 2**res_log, 2**res_log)  # k: conv_idx in JAX
            out = self.style_convs[k](out, latent[:, k + 1], noise.draw(k + 1, shape))
            if k + 1 < len(conditions):
                scale, shift = conditions[k], conditions[k + 1]
                if self.sft_half:
                    half = out.shape[1] // 2
                    out = torch.cat([out[:, :half], out[:, half:] * scale + shift], 1)
                else:
                    out = out * scale + shift
            out = self.style_convs[k + 1](out, latent[:, k + 2], noise.draw(1000 + k, shape))
            skip = self.to_rgbs[j](out, latent[:, k + 3], skip)
        return skip


class GFPGANv1Clean(nn.Module):
    """x: (B, 3, S, S) in [-1, 1] -> the restored (B, 3, S, S), S =
    `out_size`."""

    def __init__(self, out_size: int = 512, num_style_feat: int = 512, channel_multiplier: int = 2,
                 narrow: float = 1.0, sft_half: bool = True):
        super().__init__()
        ch = channels(narrow, channel_multiplier)
        self.out_size, self.num_style_feat = out_size, num_style_feat
        self.log_size = int(math.log2(out_size))
        self.num_latent = self.log_size * 2 - 2
        self.conv_body_first = nn.Conv2d(3, ch[512], 1)
        self.conv_body_down = nn.ModuleList()
        cin, res = ch[512], out_size
        for _ in range(self.log_size - 2):
            self.conv_body_down.append(ResBlock(cin, ch[res // 2], "down"))
            cin, res = ch[res // 2], res // 2
        self.final_conv = nn.Conv2d(ch[4], ch[4], 3, 1, 1)
        self.final_linear = nn.Linear(ch[4] * 16, self.num_latent * num_style_feat)
        self.conv_body_up = nn.ModuleList()
        self.condition_scale, self.condition_shift = nn.ModuleList(), nn.ModuleList()
        cin = ch[4]
        for i in range(self.log_size - 2):
            c = ch[2 ** (i + 3)]
            self.conv_body_up.append(ResBlock(cin, c, "up"))
            sft_out = c // 2 if sft_half else c
            for cond in (self.condition_scale, self.condition_shift):
                cond.append(nn.Sequential(nn.Conv2d(c, c, 3, 1, 1), nn.LeakyReLU(0.2),
                                          nn.Conv2d(c, sft_out, 3, 1, 1)))
            cin = c
        self.stylegan_decoder = StyleGAN2GeneratorCSFT(out_size, num_style_feat,
                                                       channel_multiplier, narrow, sft_half)

    def forward(self, x: torch.Tensor, noise: FaceNoise) -> torch.Tensor:
        B = x.shape[0]
        feat = lrelu(self.conv_body_first(x))
        skips = []
        for block in self.conv_body_down:
            feat = block(feat)
            skips.insert(0, feat)
        feat = lrelu(self.final_conv(feat))
        # (h, w, c) order, as the JAX package flattens its NHWC feature
        latent = self.final_linear(feat.permute(0, 2, 3, 1).reshape(B, -1))
        latent = latent.reshape(B, self.num_latent, self.num_style_feat)
        conditions = []
        for i, block in enumerate(self.conv_body_up):
            feat = block(feat + skips[i])
            conditions += [self.condition_scale[i](feat), self.condition_shift[i](feat)]
        return self.stylegan_decoder(latent, conditions, noise)


def gfpgan_state_dict(obj: dict) -> dict[str, torch.Tensor]:
    """A GFPGANv1.3 / v1.4 checkpoint (`{"params_ema": sd}`, the same
    flattened to `params_ema.` keys, or a bare state dict) -> the state dict
    of `GFPGANv1Clean`, without the style MLP and the `toRGB` heads."""
    if isinstance(obj.get("params_ema"), dict):
        sd = obj["params_ema"]
    elif any(k.startswith("params_ema.") for k in obj):
        sd = {k[len("params_ema."):]: v for k, v in obj.items() if k.startswith("params_ema.")}
    else:
        sd = obj
    return {k: torch.as_tensor(v).float() for k, v in sd.items()
            if not k.startswith(UNUSED_PREFIXES)}


def load_gfpgan(path, out_size: int = 512, **model_kwargs) -> GFPGANv1Clean:
    """A `GFPGANv1Clean` read from a checkpoint file; a missing file raises
    FileNotFoundError."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"GFPGAN weights not found at {path}")
    model = GFPGANv1Clean(out_size=out_size, **model_kwargs)
    model.load_state_dict(gfpgan_state_dict(
        torch.load(str(path), map_location="cpu", weights_only=True)))
    return model


class FaceEnhancer:
    """Landmark-aligned face restoration on the frame's device.

    `model` (a `GFPGANv1Clean`) and `detector` (a `RetinaFaceDetector`) are
    used as they are when given; otherwise they are read from `model_path`
    (GFPGANv1.3 by default, with `model_kwargs` for the architecture) and
    `detector_path`, and a missing file raises FileNotFoundError. `noise` is
    the decoder's `FaceNoise` (`SeededNoise(0)` on `device` by default).
    `faces_found` and `frames_searched` count the detector's work."""

    def __init__(self, model_path: Optional[str] = None, detector_path: Optional[str] = None,
                 face_size: int = 512, model_kwargs: Optional[dict] = None,
                 model: Optional[GFPGANv1Clean] = None,
                 detector: Optional[RetinaFaceDetector] = None,
                 noise: Optional[FaceNoise] = None, device="cuda"):
        self.device = torch.device(device)
        self.face_size = int(face_size)
        self.detector = detector or RetinaFaceDetector(detector_path, device=self.device)
        if model is None:
            model = load_gfpgan(model_path or DEFAULT_PATH, out_size=self.face_size,
                                **(model_kwargs or {}))
        self.model = model.to(self.device).eval()
        self.noise = noise or SeededNoise(0, self.device)
        self.faces_found = self.frames_searched = 0

    def detect_landmarks(self, frame: torch.Tensor, only_center_face: bool = False,
                         eye_dist_threshold: float = 5.0) -> list[np.ndarray]:
        """(H, W, 3) uint8 RGB -> a list of (5, 2) landmark arrays, in the
        detector's score order (FaceRestoreHelper.get_face_landmarks_5)."""
        lms = []
        for det in self.detector.detect_faces(frame, conf_threshold=0.97):
            lm = det[5:15].reshape(5, 2)
            if np.linalg.norm(lm[0] - lm[1]) < eye_dist_threshold:
                continue  # too small to restore usefully
            lms.append(lm)
        if only_center_face and len(lms) > 1:
            h, w = frame.shape[:2]
            center = np.array([w / 2.0, h / 2.0])
            lms = [lms[int(np.argmin([np.linalg.norm(lm.mean(0) - center) for lm in lms]))]]
        self.frames_searched += 1
        self.faces_found += len(lms)
        return lms

    @torch.no_grad()
    def restore_aligned(self, crop: torch.Tensor) -> torch.Tensor:
        """(face_size, face_size, 3) uint8 aligned crop -> the restored uint8
        crop (RGB in [-1, 1] in and out, GFPGANer's normalisation)."""
        x = (crop.to(self.device).float() / 127.5 - 1.0).permute(2, 0, 1)[None]
        with fp32_convs():
            y = self.model(x, self.noise)[0].permute(1, 2, 0)
        return ((y.clamp(-1.0, 1.0) + 1.0) * 127.5 + 0.5).to(torch.uint8)

    @torch.no_grad()
    def enhance(self, frame: torch.Tensor, background: Optional[torch.Tensor] = None,
                upscale: float = 1.0, only_center_face: bool = False) -> torch.Tensor:
        """Restore every face found in the (H, W, 3) uint8 `frame` and paste
        it into the `upscale`-times background: `background` as given (the
        upscaler's output), else the frame itself at 1x or its Lanczos4
        resize. A frame without faces returns the background."""
        frame = torch.as_tensor(frame).to(self.device)
        H, W = frame.shape[:2]
        if background is not None:
            bg = background.to(self.device).float()
        elif abs(upscale - 1.0) < 1e-6:
            bg = frame.float()
        else:
            bg = resize_lanczos4(frame[None], int(H * upscale), int(W * upscale))[0].float()
        for lm in self.detect_landmarks(frame, only_center_face=only_center_face):
            crop, affine = face_align.align_face(frame, lm, face_size=self.face_size)
            bg = face_align.paste_face(bg, self.restore_aligned(crop), affine,
                                       upscale_factor=upscale)
        return bg.clamp(0, 255).to(torch.uint8)
