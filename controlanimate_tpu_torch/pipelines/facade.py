"""ControlAnimatePipeline: the per-window `animate()` facade of the port.

Counterpart of `controlanimate_tpu/pipelines/facade.py` with injected models:
prompt encoding (Compel-style weights, cached per prompt pair, CFG padding),
the window configuration, and `animate()`, which runs one native-LCM window
through the engine and returns its (F, H, W, 3) uint8 frames on the device.
With `reuse_overlap_latents` the clean latents of a window's last
`overlap_length` input frames are cached, and the next window (`epoch + 1`,
`overlaps` = that length) encodes only its new frames.

The run dtype comes from `RunConfig.dtype` ("float16"/"fp16" mean bf16, as
in the JAX package); models are moved to `device` in that dtype.
`RunConfig.use_pallas_conv` turns K2 on or off on the VAE, and
CONTROLANIMATE_PALLAS_MOTION=1 (the JAX package's opt-in, read when the
pipeline is built) puts the UNet's motion modules on K3.
`RunConfig.use_pallas_attention` has no effect: K1 runs every unmasked
self-attention whatever it says, and the build warns so. Building models
from disk and every setting `config.require_ported` rejects (ControlNets,
IP-Adapter, meshes, upscaling, ...) raise.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import ArchConfig, RunConfig, require_ported, torch_dtype
from ..models.clip import CLIPTextModel
from ..models.tokenizer import CLIPTokenizer
from ..schedulers import make_schedule
from .engine import AnimationEngine, EngineModels, NoiseSource, TorchNoise, WindowStatic
from .prompt_weighting import encode_weighted_prompt

# the JAX package's opt-in for the fused motion module (K3)
MOTION_ENV = "CONTROLANIMATE_PALLAS_MOTION"


@dataclass
class TextStack:
    tokenizer: CLIPTokenizer
    model: CLIPTextModel

    @torch.no_grad()
    def encode(self, prompt: str, clip_skip: int = 0) -> torch.Tensor:
        """(1, L, D) fp32 prompt embeddings on the text model's device."""
        device = self.model.text_model.embeddings.token_embedding.weight.device

        def encode_fn(ids):
            return self.model(ids.to(device), clip_skip=clip_skip)["encoder_hidden_states"]

        return encode_weighted_prompt(self.tokenizer, encode_fn, prompt)


class ControlAnimatePipeline:
    """Build once per run config; drive per window with `animate()`."""

    def __init__(
        self,
        config: RunConfig,
        *,
        models: Optional[EngineModels] = None,
        text_stack: Optional[TextStack] = None,
        arch: Optional[ArchConfig] = None,
        device="cuda",
    ):
        if models is None or text_stack is None:
            raise NotImplementedError(
                "building the models from disk is not ported yet; pass models= and text_stack="
            )
        if not config.use_lcm:
            raise NotImplementedError("only the native-LCM window (use_lcm) is ported")
        require_ported(config)
        self.config = config
        self.arch = arch if arch is not None else ArchConfig()
        self.device = torch.device(device)
        self.dtype = torch_dtype(config.dtype)
        models.unet.to(device=self.device, dtype=self.dtype).eval()
        models.vae.to(device=self.device, dtype=self.dtype).eval()
        models.vae.set_conv_kernel(config.use_pallas_conv)
        models.unet.set_motion_kernel(os.environ.get(MOTION_ENV, "0") == "1")
        warnings.warn(
            f"RunConfig.use_pallas_attention={config.use_pallas_attention!r} has no effect in "
            "the PyTorch port: the flash-attention kernel (K1) runs every unmasked "
            "self-attention", stacklevel=2)
        text_stack.model.to(device=self.device, dtype=self.dtype).eval()
        self.models = models
        self.text = text_stack
        schedule = make_schedule(
            num_train_timesteps=self.arch.num_train_timesteps,
            beta_start=self.arch.beta_start,
            beta_end=self.arch.beta_end,
            beta_schedule=self.arch.beta_schedule,
        )
        self.engine = AnimationEngine(models, schedule)
        self._prompt_cache: dict = {}
        # (expected epoch, clean tail latents) from the previous window
        self._overlap_latent_cache: Optional[tuple] = None

    def _encode_prompts(self, prompt: str, n_prompt: str, clip_skip: int = 0):
        key = (prompt, n_prompt, clip_skip)
        if key not in self._prompt_cache:
            pos = self.text.encode(prompt, clip_skip)
            neg = self.text.encode(n_prompt, clip_skip)
            # a `.and()` conjunction makes one side longer: pad the shorter by
            # repeating its final token embedding (Compel's behaviour)
            L = max(pos.shape[1], neg.shape[1])

            def pad(e):
                if e.shape[1] == L:
                    return e
                return torch.cat([e, e[:, -1:].expand(-1, L - e.shape[1], -1)], dim=1)

            self._prompt_cache[key] = (pad(pos), pad(neg))
        return self._prompt_cache[key]

    def _reuse_overlap(self, has_input_frames: bool) -> bool:
        cfg = self.config
        return (
            cfg.use_lcm and cfg.reuse_overlap_latents and not cfg.loop_back_frames
            and has_input_frames
        )

    def window_static(self, *, strength: Optional[float] = None, has_input_frames: bool = True,
                      frame_count: Optional[int] = None) -> WindowStatic:
        """The window configuration `animate` runs for these call conditions.
        The JAX facade's decode-chunk rule was sized for a 16 GB TPU and does
        not carry over: the window decodes in one pass."""
        cfg = self.config
        return WindowStatic(
            steps=cfg.steps,
            strength=float(cfg.strength if strength is None else strength),
            guidance_scale=float(cfg.guidance_scale),
            use_lcm=cfg.use_lcm,
            lcm_origin_steps=cfg.lcm_origin_steps,
            frame_count=frame_count or cfg.frame_count,
            height=cfg.height,
            width=cfg.width,
            output_uint8=True,
            tail_latents=cfg.overlap_length if self._reuse_overlap(has_input_frames) else 0,
        )

    def _to_device(self, frames):
        """(F, H, W, 3) uint8 frames (numpy or tensor) -> (1, F, H, W, 3) on device."""
        if frames is None:
            return None
        t = torch.as_tensor(frames)
        if t.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {t.dtype}")
        return t.to(self.device)[None]

    def animate(
        self,
        input_frames,  # (F, H, W, 3) uint8, or None for txt2vid
        last_output_frames,  # (K, H, W, 3) uint8, or None
        *,
        overlaps: int = 0,
        strength: Optional[float] = None,
        seed: int = 0,
        epoch: int = 0,
        frame_count: Optional[int] = None,
        noise: Optional[NoiseSource] = None,
    ) -> torch.Tensor:
        """Generate one window; returns its (F, H, W, 3) uint8 frames on the
        device. Every call with the same seed draws the same noise (the
        reference re-seeds per window); `noise` overrides the default
        `TorchNoise(seed, device)`."""
        cfg = self.config
        pos, _neg = self._encode_prompts(cfg.prompt, cfg.n_prompt, cfg.clip_skip)

        reuse = self._reuse_overlap(input_frames is not None)
        head_latents = None
        if reuse and overlaps and self._overlap_latent_cache is not None:
            cache_epoch, cached_tail = self._overlap_latent_cache
            if cache_epoch == epoch and cached_tail.shape[1] == overlaps:
                head_latents = cached_tail

        st = self.window_static(strength=strength, has_input_frames=input_frames is not None,
                                frame_count=frame_count)
        out = self.engine.generate_window(
            st, pos, noise if noise is not None else TorchNoise(seed, self.device),
            input_frames=self._to_device(input_frames),
            last_output_frames=self._to_device(last_output_frames),
            head_latents=head_latents,
        )
        if st.tail_latents:
            out, tail = out
            self._overlap_latent_cache = (epoch + 1, tail)
        return out[0]
