"""ControlAnimatePipeline: the per-window `animate()` facade of the port.

Counterpart of `controlanimate_tpu/pipelines/facade.py`: builds the models
from an on-disk model zoo (`build_from_disk`) or takes injected ones, then
prompt encoding (Compel-style weights, cached per prompt pair, CFG padding),
the window configuration, and `animate()`, which runs one window through the
engine and returns its (F, H, W, 3) uint8 frames on the device: native LCM
under `use_lcm`, else the `scheduler` named by the config (the seven JAX
registry names; `LCMScheduler` then means the LCM-LoRA table with img2img
tail truncation), with classifier-free guidance over the stacked
[negative, positive] prompts when `guidance_scale` > 1. With
`reuse_overlap_latents` (native LCM only) the clean latents of a window's
last `overlap_length` input frames are cached, and the next window
(`epoch + 1`, `overlaps` = that length, the same batch) encodes only its new
frames.

Segment-parallel windows (`animate(..., segments=S)`, S > 1): S segments of
a video run as one batched window, the segment axis the engine's batch
axis: (S, F, H, W, 3) input and last-output frames in, (S, F, H, W, 3)
uint8 out; one prompt for every segment, each segment's own IP-Adapter
anchor, and draws shared across the batch, so that each segment gets what a
run of that segment alone with the same seed gets. The VAE decodes at most
24 frames a pass once a window's B*F frames reach 32 at 512x512 or more
(`decode_chunk`, the JAX facade's rule): frames decode independently, and a
pass of 16 frames holds a quarter of the one-pass decode's activations at
64 frames (`vae_chunk_probe.py`). The encode runs in one pass.

ControlNets (`controlnets`, `cond_scale`, `guess_mode`): `prepare_cond_images`
annotates a window's uint8 frames on the device (one annotator a net,
`models/annotators`), quantises each map to uint8 as the JAX facade does
(`map * 255 + 0.5`, truncated; the engine divides by 255), and with
`save_frames` dumps them as PNGs under
`<output_video_dir>/controlnet_outputs_<time>/<net>/`. `animate` stages them
itself when the caller passes none. An empty `cond_scale` means 1.0 for
every net; a `cond_scale` of another length than `controlnets` raises
ValueError (the JAX facade fails mid-trace).

The disk build follows the JAX `_build_from_disk`: the tokenizer, text
encoder (with textual-inversion rows), VAE (the snapshot's, a single-file
LDM `vae_path`, or a DreamBooth file's) and UNet (the snapshot's 2D weights,
or a DreamBooth file's, with LoRAs fused, plus the motion-module checkpoint
with motion LoRAs fused) of the snapshot at `pretrained_lcm_model_path`
under `use_lcm` (`pretrained_model_path` otherwise), with the architecture
from `inference_config_path`, and each ControlNet from
`models/ControlNet/<last part of its name>`, else its name as a path (a
diffusers folder: config.json and one weights file set). Each module is
made on the meta device and takes its weights, cast to the run dtype on the
target device, by `load_state_dict(assign=True)`: no fp32 copy of a model
is made on the card.
JAX behaviours not copied: every path the build reads must exist
(FileNotFoundError; JAX skips or falls back), a UNet with motion modules
needs a motion-module file (JAX initialises them at random), a missing
`inference_config_path` raises (JAX takes the default architecture), and
so does a LoRA file of which no layer matches (JAX fuses nothing). The
motion checkpoint's `module.` prefix is stripped before its LoRAs fuse
(JAX strips it after, so it drops a LoRA's deltas for prefixed blocks), and
a ControlNet's architecture comes from its config.json (JAX builds the SD1.5
defaults whatever the file says; they agree for every SD1.5 ControlNet), and
a `scheduler` that names no sampler raises KeyError when the pipeline is
built (JAX raises it at the first window).

IP-Adapter (`use_ipadapter`): the adapter is built first, from
`ipadapter_ckpt_path` and the image encoder at `ipadapter_image_encoder_path`
(`pipelines/ip_adapter.py`), since its checkpoint decides how many image
tokens the UNet's cross-attentions take; its `to_k_ip` / `to_v_ip` weights
go into the UNet, the disk-built one or an injected one (or pass
`ip_adapter=` an adapter whose weights the injected UNet already holds).
`animate` appends to the prompts the adapter's tokens of the first last
output, cond to the positive and uncond to the negative, or zeros when the
window has no last outputs. The SDXL-family checkpoints (xl, plus-xl) raise
NotImplementedError, as in JAX.

The run dtype comes from `RunConfig.dtype` ("float16"/"fp16" mean bf16, as
in the JAX package); models are moved to `device` in that dtype.
`RunConfig.use_pallas_conv` turns K2 on or off on the VAE, and
CONTROLANIMATE_PALLAS_MOTION=1 (the JAX package's opt-in, read when the
pipeline is built) puts the UNet's motion modules on K3.
`RunConfig.use_pallas_attention` has no effect: K1 runs every unmasked
self-attention whatever it says, and the build warns so. Every setting
`config.require_ported` rejects (meshes, M14's options, ...) raises; a
depth folder's network is checked when it is read.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

from ..config import ArchConfig, RunConfig, require_ported, torch_dtype
from ..models.annotators import resolve_annotator
from ..models.clip import CLIPTextConfig, CLIPTextModel
from ..models.controlnet import ControlNetModel, controlnet_config_from_json
from ..models.tokenizer import CLIPTokenizer
from ..models.unet3d import UNet3DConditionModel, UNet3DConfig
from ..models.vae import AutoencoderKL
from ..schedulers import available_schedulers, make_schedule
from ..weights import ingest
from ..weights.clip_weights import text_state_dict_from_torch
from ..weights.controlnet_weights import controlnet_state_dict_from_torch
from ..weights.ldm_conversion import convert_ldm_vae, split_ldm_checkpoint
from ..weights.lora import fuse_lora, split_lora_by_component
from ..weights.textual_inversion import register_textual_inversions
from ..weights.unet_weights import strip_module_prefix, unet_state_dict_from_torch
from ..weights.vae_weights import vae_state_dict_from_torch
from .engine import AnimationEngine, EngineModels, NoiseSource, TorchNoise, WindowStatic
from .ip_adapter import IPAdapter
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
        ip_adapter: Optional[IPAdapter] = None,
        arch: Optional[ArchConfig] = None,
        device="cuda",
    ):
        require_ported(config)
        if not config.use_lcm and config.scheduler not in available_schedulers():
            raise KeyError(f"RunConfig.scheduler {config.scheduler!r} names no sampler; "
                           f"have {available_schedulers()}")
        cond_scales = controlnet_scales(config)
        if (models is None) != (text_stack is None):
            raise ValueError("pass both models= and text_stack=, or neither for a disk build")
        # the adapter first: its checkpoint decides the UNet's image tokens
        adapter_from_disk = config.use_ipadapter and ip_adapter is None
        if adapter_from_disk:
            ip_adapter = IPAdapter.from_config(config, device, torch_dtype(config.dtype))
            if ip_adapter.variant in ("xl", "plus-xl"):
                raise NotImplementedError(
                    f"IP-Adapter checkpoint {config.ipadapter_ckpt_path} is the SDXL-family "
                    f"{ip_adapter.variant!r} variant; it needs an SDXL UNet, which is outside "
                    "the SD1.5 path. Use an sd15 checkpoint (base, plus or full)")
        if models is None:
            if arch is None:
                arch = ArchConfig.from_yaml(
                    _existing(config.inference_config_path, "inference_config_path"))
            models, text_stack = build_from_disk(config, arch, device, torch_dtype(config.dtype),
                                                 ip_adapter)
        elif adapter_from_disk:
            ip_adapter.inject(models.unet)
        self.config = config
        self.arch = arch if arch is not None else ArchConfig()
        self.device = torch.device(device)
        self.dtype = torch_dtype(config.dtype)
        models.unet.to(device=self.device, dtype=self.dtype).eval()
        models.vae.to(device=self.device, dtype=self.dtype).eval()
        models.vae.set_conv_kernel(config.use_pallas_conv)
        models.unet.set_motion_kernel(os.environ.get(MOTION_ENV, "0") == "1")
        if len(models.controlnets) != len(config.controlnets):
            raise ValueError(f"{len(models.controlnets)} ControlNet models for the "
                             f"{len(config.controlnets)} of RunConfig.controlnets")
        for net in models.controlnets:
            net.to(device=self.device, dtype=self.dtype).eval()
        annotators = list(models.annotators) or [
            resolve_annotator(name, self.device) for name in config.controlnets]
        if len(annotators) != len(config.controlnets):
            raise ValueError(f"{len(annotators)} annotators for the "
                             f"{len(config.controlnets)} of RunConfig.controlnets")
        models = dataclasses.replace(models, cond_scales=cond_scales, annotators=annotators)
        warnings.warn(
            f"RunConfig.use_pallas_attention={config.use_pallas_attention!r} has no effect in "
            "the PyTorch port: the flash-attention kernel (K1) runs every unmasked "
            "self-attention", stacklevel=2)
        text_stack.model.to(device=self.device, dtype=self.dtype).eval()
        self.ip_adapter = (ip_adapter.to(self.device, self.dtype) if ip_adapter is not None
                           else None)
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
        self._cn_dump_root: Optional[Path] = None

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

    @staticmethod
    def pick_decode_chunk(total_frames: int, pixels: int) -> int:
        """Frames a VAE decode pass: 0 (one pass) below 32 frames or below
        512x512 pixels, else the largest divisor of `total_frames` up to 24
        (the JAX facade's rule)."""
        if total_frames < 32 or pixels < 512 * 512:
            return 0
        return next(c for c in range(min(24, total_frames), 0, -1) if total_frames % c == 0)

    def window_static(self, *, strength: Optional[float] = None,
                      has_input_frames: bool = True,
                      frame_count: Optional[int] = None, segments: int = 0,
                      window_frames: Optional[int] = None) -> WindowStatic:
        """The window configuration `animate` runs for these call conditions;
        `window_frames` (the input's frames a segment, else the window's
        frame count) and `segments` set the decode chunk."""
        cfg = self.config
        frames = window_frames or frame_count or cfg.frame_count
        return WindowStatic(
            scheduler_name=cfg.scheduler,
            steps=cfg.steps,
            strength=float(cfg.strength if strength is None else strength),
            guidance_scale=float(cfg.guidance_scale),
            use_lcm=cfg.use_lcm,
            lcm_origin_steps=cfg.lcm_origin_steps,
            guess_mode=cfg.guess_mode,
            use_img2img=cfg.use_img2img,
            ipa_scale=float(cfg.ipa_scale),
            ip_tokens=self.ip_adapter.num_tokens if self.ip_adapter is not None else 0,
            frame_count=frame_count or cfg.frame_count,
            height=cfg.height,
            width=cfg.width,
            output_uint8=True,
            decode_chunk=self.pick_decode_chunk(frames * max(int(segments), 1),
                                                cfg.height * cfg.width),
            tail_latents=cfg.overlap_length if self._reuse_overlap(has_input_frames) else 0,
        )

    def _to_device(self, frames):
        """(F, H, W, 3) uint8 frames (numpy or tensor) -> (1, F, H, W, 3) on
        device; (S, F, H, W, 3) segment frames keep their segment axis."""
        if frames is None:
            return None
        t = torch.as_tensor(frames)
        if t.dtype != torch.uint8:
            raise TypeError(f"frames must be uint8, got {t.dtype}")
        t = t.to(self.device)
        return t if t.ndim == 5 else t[None]

    def _dump_condition_maps(self, net_name: str, maps: torch.Tensor, epoch: int) -> None:
        """save_frames: a window's uint8 maps of one net as PNGs under
        controlnet_outputs_<time>/<last part of the net's name>/, named
        <epoch>_<frame>.png (the JAX facade's dumps)."""
        from PIL import Image

        if self._cn_dump_root is None:
            self._cn_dump_root = (Path(self.config.output_video_dir)
                                  / f"controlnet_outputs_{time.strftime('%Y%m%d-%H%M%S')}")
        d = self._cn_dump_root / net_name.split("/")[-1]
        d.mkdir(parents=True, exist_ok=True)
        for i, m in enumerate(maps.cpu().numpy()):
            Image.fromarray(m).save(d / f"{epoch:04d}_{i:02d}.png")

    @torch.no_grad()
    def prepare_cond_images(self, input_frames, epoch: int = 0) -> list[torch.Tensor]:
        """The window's condition maps, one (1, F, H, W, 3) uint8 tensor on the
        device a ControlNet, annotated on the device from the (F, H, W, 3)
        uint8 input frames (numpy or tensor); from (S, F, H, W, 3) segment
        frames the S*F frames are annotated as one stack and each map is (S,
        F, H, W, 3). [] without ControlNets. A map value outside [0, 1]
        (lineart_anime's cubic resize overshoots) goes to 0 or 255, where
        the JAX package's uint8 cast wraps it."""
        if not self.models.controlnets:
            return []
        if input_frames is None:
            raise ValueError("ControlNets need input frames to annotate")
        batch = self._to_device(input_frames)
        frames = batch.reshape(-1, *batch.shape[2:])
        cond_images = []
        for name, annotate in zip(self.config.controlnets, self.models.annotators):
            maps = annotate(frames)
            maps_u8 = (maps.float().clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
            if self.config.save_frames:
                self._dump_condition_maps(name, maps_u8, epoch)
            cond_images.append(maps_u8.reshape(*batch.shape[:2], *maps_u8.shape[1:]))
        return cond_images

    def animate(
        self,
        input_frames,  # (F, H, W, 3) uint8, (S, F, H, W, 3) with segments, or None
        last_output_frames,  # (K, H, W, 3) uint8, (S, K, H, W, 3) with segments, or None
        *,
        overlaps: int = 0,
        strength: Optional[float] = None,
        seed: int = 0,
        epoch: int = 0,
        frame_count: Optional[int] = None,
        noise: Optional[NoiseSource] = None,
        cond_images: Optional[list] = None,
        segments: int = 0,
    ) -> torch.Tensor:
        """Generate one window; returns its (F, H, W, 3) uint8 frames on the
        device, or with `segments` S > 1 the (S, F, H, W, 3) frames of S
        lockstep segments. Every call with the same seed draws the same noise
        (the reference re-seeds per window), shared by the segments; `noise`
        overrides the default `TorchNoise(seed, device)`. `cond_images` are
        the window's condition maps from `prepare_cond_images`, staged here
        when not given."""
        cfg = self.config
        S = max(int(segments), 0)
        batched = S > 1
        pos, neg = self._encode_prompts(cfg.prompt, cfg.n_prompt, cfg.clip_skip)
        if batched:
            # one prompt a segment, tiled before each segment's image tokens
            pos, neg = (e.expand(S, *e.shape[1:]) for e in (pos, neg))
        if self.ip_adapter is not None:
            # the image tokens of the first last output (of each segment), or
            # zeros without one
            if last_output_frames is not None and len(last_output_frames):
                if batched:
                    img_c, img_u = self.ip_adapter.embed_images(last_output_frames[:, 0])
                else:
                    img_c, img_u = self.ip_adapter.embed_image(last_output_frames[0])
            else:
                img_c = img_u = torch.zeros((pos.shape[0], self.ip_adapter.num_tokens,
                                             pos.shape[-1]), device=pos.device)
            pos = torch.cat([pos, img_c.to(pos.dtype)], dim=1)
            neg = torch.cat([neg, img_u.to(neg.dtype)], dim=1)

        reuse = self._reuse_overlap(input_frames is not None)
        head_latents = None
        if reuse and overlaps and self._overlap_latent_cache is not None:
            cache_epoch, cached_tail = self._overlap_latent_cache
            if (cache_epoch == epoch and cached_tail.shape[1] == overlaps
                    and cached_tail.shape[0] == (S if batched else 1)):
                head_latents = cached_tail

        if cond_images is None:
            cond_images = self.prepare_cond_images(input_frames, epoch)
        window_frames = None if input_frames is None else int(
            input_frames.shape[1] if input_frames.ndim == 5 else input_frames.shape[0])
        st = self.window_static(strength=strength,
                                has_input_frames=input_frames is not None,
                                frame_count=frame_count, segments=S,
                                window_frames=window_frames)
        text_embeds = torch.cat([neg, pos]) if st.do_cfg else pos
        out = self.engine.generate_window(
            st, text_embeds, noise if noise is not None else TorchNoise(seed, self.device),
            input_frames=self._to_device(input_frames),
            last_output_frames=self._to_device(last_output_frames),
            head_latents=head_latents,
            cond_images=cond_images,
        )
        if st.tail_latents:
            out, tail = out
            self._overlap_latent_cache = (epoch + 1, tail)
        return out if batched else out[0]


def controlnet_scales(cfg: RunConfig) -> list[float]:
    """One conditioning scale a ControlNet: `cond_scale`, or 1.0 for each net
    when it is empty; ValueError when its length differs."""
    n = len(cfg.controlnets)
    if not cfg.cond_scale:
        return [1.0] * n
    if len(cfg.cond_scale) != n:
        raise ValueError(f"RunConfig.cond_scale has {len(cfg.cond_scale)} values for "
                         f"{n} ControlNets")
    return [float(c) for c in cfg.cond_scale]


def controlnet_dir(name: str) -> Path:
    """A ControlNet's folder: models/ControlNet/<last part of the name>, else
    the name as a path (the JAX facade's rule); FileNotFoundError if neither
    exists."""
    path = Path("models/ControlNet") / name.split("/")[-1]
    if not path.exists():
        path = Path(name)
    if not path.exists():
        raise FileNotFoundError(f"ControlNet {name!r}: neither models/ControlNet/"
                                f"{name.split('/')[-1]} nor {name} exists")
    return path


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


def build_from_disk(cfg: RunConfig, arch: ArchConfig, device="cuda",
                    dtype: torch.dtype = torch.bfloat16,
                    ip_adapter: Optional[IPAdapter] = None) -> tuple[EngineModels, TextStack]:
    """The pipeline's models from the model zoo named by `cfg`, on `device` in
    `dtype` (the JAX `_build_from_disk`, without token merging, which
    `require_ported` rejects); with `ip_adapter`, the UNet's cross-attentions
    take its tokens and its `to_k_ip` / `to_v_ip` weights. The annotators
    are built by the pipeline."""
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

    ucfg = UNet3DConfig.from_arch(arch, unet_json,
                                  ip_tokens=0 if ip_adapter is None else ip_adapter.num_tokens)
    if ip_adapter is not None:
        unet_sd = {**unet_sd, **ip_adapter.unet_weights(ucfg)}
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
    text_model = ingest.build_module(lambda: CLIPTextModel(tcfg), te_sd, device, dtype,
                                     lambda sd, keys: text_state_dict_from_torch(sd, keys, extra))
    vae = ingest.build_module(lambda: AutoencoderKL(
        block_out_channels=tuple(vae_json.get("block_out_channels", (128, 256, 512, 512))),
        scaling_factor=vae_json.get("scaling_factor", 0.18215),
        groups=vae_json.get("norm_num_groups", 32)), vae_sd, device, dtype,
        vae_state_dict_from_torch)
    unet = ingest.build_module(lambda: UNet3DConditionModel(ucfg), unet_sd, device, dtype,
                               lambda sd, keys: unet_state_dict_from_torch(sd, keys, motion_sd))
    controlnets = []
    for name in cfg.controlnets:
        cn_json, cn_sd = ingest.load_hf_component(controlnet_dir(name), "")
        cn_cfg, cond_channels = controlnet_config_from_json(cn_json)
        controlnets.append(ingest.build_module(
            lambda: ControlNetModel(cn_cfg, cond_channels), cn_sd, device, dtype,
            lambda sd, keys: controlnet_state_dict_from_torch(sd, cn_cfg, len(cond_channels))))
    return (EngineModels(unet=unet, vae=vae, controlnets=controlnets),
            TextStack(tokenizer, text_model))
