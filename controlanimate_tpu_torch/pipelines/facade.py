"""ControlAnimatePipeline: the per-window `animate()` facade of the port.

Counterpart of `controlanimate_tpu/pipelines/facade.py`: builds the models
from an on-disk model zoo (`build_from_disk`) or takes injected ones, then
prompt encoding (Compel-style weights, cached per prompt pair, CFG padding),
the window configuration, and `animate()`, which runs one native-LCM window
through the engine and returns its (F, H, W, 3) uint8 frames on the device.
With `reuse_overlap_latents` the clean latents of a window's last
`overlap_length` input frames are cached, and the next window (`epoch + 1`,
`overlaps` = that length) encodes only its new frames.

The disk build follows the JAX `_build_from_disk`: the tokenizer, text
encoder (with textual-inversion rows), VAE (the snapshot's, a single-file
LDM `vae_path`, or a DreamBooth file's) and UNet (the snapshot's 2D weights,
or a DreamBooth file's, with LoRAs fused, plus the motion-module checkpoint
with motion LoRAs fused) of the snapshot at `pretrained_lcm_model_path`
under `use_lcm` (`pretrained_model_path` otherwise), with the architecture
from `inference_config_path`. Each module is made on the meta device and
takes its weights, cast to the run dtype on the target device, by
`load_state_dict(assign=True)`: no fp32 copy of a model is made on the card.
JAX behaviours not copied: every path the build reads must exist
(FileNotFoundError; JAX skips or falls back), a UNet with motion modules
needs a motion-module file (JAX initialises them at random), a missing
`inference_config_path` raises (JAX takes the default architecture), and
so does a LoRA file of which no layer matches (JAX fuses nothing). The
motion checkpoint's `module.` prefix is stripped before its LoRAs fuse
(JAX strips it after, so it drops a LoRA's deltas for prefixed blocks).

The run dtype comes from `RunConfig.dtype` ("float16"/"fp16" mean bf16, as
in the JAX package); models are moved to `device` in that dtype.
`RunConfig.use_pallas_conv` turns K2 on or off on the VAE, and
CONTROLANIMATE_PALLAS_MOTION=1 (the JAX package's opt-in, read when the
pipeline is built) puts the UNet's motion modules on K3.
`RunConfig.use_pallas_attention` has no effect: K1 runs every unmasked
self-attention whatever it says, and the build warns so. Every setting
`config.require_ported` rejects (ControlNets, IP-Adapter, meshes, the face
enhancer, ...) raises, and so does a run without `use_lcm`.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import torch
from torch import nn

from ..config import ArchConfig, RunConfig, require_ported, torch_dtype
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.tokenizer import CLIPTokenizer
from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.vae import AutoencoderKL
from ..schedulers import make_schedule
from ..weights import ingest
from ..weights.clip_weights import text_state_dict_from_torch
from ..weights.ldm_conversion import convert_ldm_vae, split_ldm_checkpoint
from ..weights.lora import fuse_lora, split_lora_by_component
from ..weights.textual_inversion import register_textual_inversions
from ..weights.unet_weights import strip_module_prefix, unet_state_dict_from_torch
from ..weights.vae_weights import vae_state_dict_from_torch
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
        if not config.use_lcm:
            raise NotImplementedError("only the native-LCM window (use_lcm) is ported")
        require_ported(config)
        if (models is None) != (text_stack is None):
            raise ValueError("pass both models= and text_stack=, or neither for a disk build")
        if models is None:
            if arch is None:
                arch = ArchConfig.from_yaml(
                    _existing(config.inference_config_path, "inference_config_path"))
            models, text_stack = build_from_disk(config, arch, device, torch_dtype(config.dtype))
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


def _existing(path, key: str) -> Path:
    """`path` (the RunConfig's `key`), which must exist."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"RunConfig.{key}: {p} not found")
    return p


def _require_fused(count: int, path) -> None:
    """A LoRA file of which no layer matched a weight of the model (the JAX
    build fuses nothing and goes on)."""
    if not count:
        raise ValueError(f"LoRA {path}: no layer matches a weight of the model")


def _load(make: Callable[[], nn.Module], state: dict[str, torch.Tensor], device,
          dtype: torch.dtype, convert: Callable) -> nn.Module:
    """`make()` on the meta device, given `convert(state, its keys)` cast to
    `dtype` on `device` (integer tensors keep theirs); its non-persistent
    buffers (made on the host at construction) then move to `device`."""
    with torch.device("meta"):
        module = make()
    sd = convert(state, module.state_dict().keys())
    sd = {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
          for k, v in sd.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device)


def build_from_disk(cfg: RunConfig, arch: ArchConfig, device="cuda",
                    dtype: torch.dtype = torch.bfloat16) -> tuple[EngineModels, TextStack]:
    """The pipeline's models from the model zoo named by `cfg`, on `device` in
    `dtype` (the JAX `_build_from_disk`, without ControlNets, IP-Adapter
    tokens and token merging, which `require_ported` rejects)."""
    base = Path(cfg.pretrained_lcm_model_path if cfg.use_lcm else cfg.pretrained_model_path)
    if not base.is_dir():
        raise FileNotFoundError(f"model snapshot {base} not found")

    # DreamBooth single-file overrides, without LCM only (as in JAX)
    db = None
    if cfg.dreambooth_path and not cfg.use_lcm:
        db = split_ldm_checkpoint(ingest.load_state_dict(
            _existing(cfg.dreambooth_path, "dreambooth_path")))

    tokenizer = CLIPTokenizer.from_pretrained(base / "tokenizer")
    extra = register_textual_inversions(tokenizer, cfg.textual_inversion_paths)
    te_json, te_sd = ingest.load_hf_component(base, "text_encoder")
    if db and db["clip"]:
        te_sd = db["clip"]

    if cfg.vae_path:
        vae_sd = convert_ldm_vae(ingest.load_state_dict(_existing(cfg.vae_path, "vae_path")))
        vae_json: dict = {}
    elif db and db["vae"]:
        vae_sd, vae_json = db["vae"], {}
    else:
        vae_json, vae_sd = ingest.load_hf_component(base, "vae")

    unet_json, unet_sd = ingest.load_hf_component(base, "unet")
    if db and db["unet"]:
        unet_sd = db["unet"]

    # LoRAs fuse without LCM only; motion LoRAs in both modes (as in JAX)
    lora_paths = () if cfg.use_lcm else cfg.lora_model_paths
    for lp, lw in zip(lora_paths, cfg.lora_weights or [1.0] * len(lora_paths)):
        parts = split_lora_by_component(ingest.load_state_dict(
            _existing(lp, "lora_model_paths")))
        unet_sd, fused = fuse_lora(unet_sd, parts["unet"], scale=float(lw))
        if parts["text_encoder"]:
            te_sd, fused_te = fuse_lora(te_sd, parts["text_encoder"], scale=float(lw))
            fused += fused_te
        _require_fused(fused, lp)

    ucfg = UNet3DConfig.from_arch(arch, unet_json)
    motion_sd = None
    if cfg.motion_module:
        # the prefix goes before fusing, so LoRA keys match the prefixed blocks too
        motion_sd = strip_module_prefix(ingest.load_state_dict(
            _existing(cfg.motion_module, "motion_module")))
        alphas = cfg.motion_lora_alphas or [1.0] * len(cfg.motion_lora_paths)
        for mp, ma in zip(cfg.motion_lora_paths, alphas):
            motion_sd, fused = fuse_lora(motion_sd, ingest.load_state_dict(
                _existing(mp, "motion_lora_paths")), scale=float(ma))
            _require_fused(fused, mp)
    elif ucfg.use_motion_module:
        raise ValueError(f"{cfg.inference_config_path} puts motion modules in the UNet but "
                         "RunConfig.motion_module names no checkpoint for them")

    tcfg = CLIPTextConfig.from_json(te_json, num_extra_embeddings=0 if extra is None
                                    else len(extra))
    text_model = _load(lambda: CLIPTextModel(tcfg), te_sd, device, dtype,
                       lambda sd, keys: text_state_dict_from_torch(sd, keys, extra))
    vae = _load(lambda: AutoencoderKL(
        block_out_channels=tuple(vae_json.get("block_out_channels", (128, 256, 512, 512))),
        scaling_factor=vae_json.get("scaling_factor", 0.18215),
        groups=vae_json.get("norm_num_groups", 32)), vae_sd, device, dtype,
        vae_state_dict_from_torch)
    unet = _load(lambda: UNet3DConditionModel(ucfg), unet_sd, device, dtype,
                 lambda sd, keys: unet_state_dict_from_torch(sd, keys, motion_sd))
    return EngineModels(unet=unet, vae=vae), TextStack(tokenizer, text_model)
