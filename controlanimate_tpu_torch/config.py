"""Configuration for the port: architecture, run settings and stitch state.

A copy of `controlanimate_tpu/config.py` (`MotionModuleConfig`, `ArchConfig`,
every `RunConfig` field, `StitchState`), kept here so the port never imports
the JAX package, plus `require_ported`, which rejects the settings the port
cannot run yet. `yaml` is imported only inside the loaders.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import torch


def _as_bool(v: Any) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "y")
    return bool(v)


def _parse_hms(s: Optional[str]) -> Optional[float]:
    """'HH:MM:SS' -> seconds."""
    if not s:
        return None
    t = time.strptime(str(s), "%H:%M:%S")
    return t.tm_hour * 3600 + t.tm_min * 60 + t.tm_sec


def _load_yaml(path: str | Path) -> dict:
    import yaml

    return yaml.safe_load(Path(path).read_text()) or {}


@dataclass(frozen=True)
class MotionModuleConfig:
    """Motion-module topology (inference-v2.yaml `motion_module_kwargs`)."""

    num_attention_heads: int = 8
    num_transformer_block: int = 1
    attention_block_types: tuple[str, ...] = ("Temporal_Self", "Temporal_Self")
    temporal_position_encoding: bool = True
    temporal_position_encoding_max_len: int = 32
    temporal_attention_dim_div: int = 1
    attention_band: int = 0  # banded temporal attention; the port runs 0 only


@dataclass(frozen=True)
class ArchConfig:
    """UNet inflation architecture and noise schedule (inference-v2.yaml)."""

    use_inflated_groupnorm: bool = True
    unet_use_cross_frame_attention: bool = False
    unet_use_temporal_attention: bool = False
    use_motion_module: bool = True
    motion_module_resolutions: tuple[int, ...] = (1, 2, 4, 8)
    motion_module_mid_block: bool = True
    motion_module_decoder_only: bool = False
    motion_module_type: str = "Vanilla"
    motion_module: MotionModuleConfig = field(default_factory=MotionModuleConfig)
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    num_train_timesteps: int = 1000
    steps_offset: int = 1
    clip_sample: bool = False

    def __post_init__(self):
        if self.use_motion_module and self.motion_module_type != "Vanilla":
            raise NotImplementedError(
                f"motion_module_type={self.motion_module_type!r}: only 'Vanilla' exists"
            )

    @staticmethod
    def from_yaml(path: str | Path) -> "ArchConfig":
        raw = _load_yaml(path)
        uak = dict(raw.get("unet_additional_kwargs") or {})
        nsk = dict(raw.get("noise_scheduler_kwargs") or {})
        mm_kwargs = dict(uak.pop("motion_module_kwargs", {}) or {})
        mm = MotionModuleConfig(
            num_attention_heads=int(mm_kwargs.get("num_attention_heads", 8)),
            num_transformer_block=int(mm_kwargs.get("num_transformer_block", 1)),
            attention_block_types=tuple(
                mm_kwargs.get("attention_block_types", ("Temporal_Self", "Temporal_Self"))
            ),
            temporal_position_encoding=_as_bool(
                mm_kwargs.get("temporal_position_encoding", True)
            ),
            temporal_position_encoding_max_len=int(
                mm_kwargs.get("temporal_position_encoding_max_len", 24)
            ),
            temporal_attention_dim_div=int(mm_kwargs.get("temporal_attention_dim_div", 1)),
            attention_band=int(mm_kwargs.get("attention_band", 0)),
        )
        return ArchConfig(
            use_inflated_groupnorm=_as_bool(uak.get("use_inflated_groupnorm", False)),
            unet_use_cross_frame_attention=_as_bool(
                uak.get("unet_use_cross_frame_attention", False)
            ),
            unet_use_temporal_attention=_as_bool(uak.get("unet_use_temporal_attention", False)),
            use_motion_module=_as_bool(uak.get("use_motion_module", True)),
            motion_module_resolutions=tuple(uak.get("motion_module_resolutions", (1, 2, 4, 8))),
            motion_module_mid_block=_as_bool(uak.get("motion_module_mid_block", False)),
            motion_module_decoder_only=_as_bool(uak.get("motion_module_decoder_only", False)),
            motion_module_type=str(uak.get("motion_module_type", "Vanilla")),
            motion_module=mm,
            beta_start=float(nsk.get("beta_start", 0.00085)),
            beta_end=float(nsk.get("beta_end", 0.012)),
            beta_schedule=str(nsk.get("beta_schedule", "linear")),
            num_train_timesteps=int(nsk.get("num_train_timesteps", 1000)),
            steps_offset=int(nsk.get("steps_offset", 1)),
            clip_sample=_as_bool(nsk.get("clip_sample", False)),
        )


@dataclass(frozen=True)
class RunConfig:
    """The run settings, one field per key of `configs/prompts/*.yaml`, with
    the JAX package's names, defaults and `from_dict` coercions (a copy of
    `controlanimate_tpu/config.py` `RunConfig`). Keys the JAX package does not
    know land in `extras`. Settings whose behaviour the port lacks raise in
    `require_ported`."""

    # inputs / outputs
    input_video_path: str = ""
    output_video_dir: str = "output"
    save_frames: bool = False
    width: int = 512
    height: int = 512
    prompt: str = ""
    n_prompt: str = ""
    start_time: Optional[str] = None
    end_time: Optional[str] = None

    # generation modes
    overlap_strength: float = 0.92
    use_lcm: bool = False
    use_img2img: bool = False
    reuse_overlap_latents: bool = True

    # models
    pretrained_model_path: str = ""
    vae_path: Optional[str] = None
    dreambooth_path: Optional[str] = None
    lora_model_paths: tuple[str, ...] = ()
    lora_weights: tuple[float, ...] = ()
    inference_config_path: str = "configs/inference/inference-v2.yaml"
    motion_module: Optional[str] = None
    motion_lora_paths: tuple[str, ...] = ()
    motion_lora_alphas: tuple[float, ...] = ()
    pretrained_lcm_model_path: str = "models/LCM_Dreamshaper_v7"

    # controlnets
    controlnets: tuple[str, ...] = ()
    cond_scale: tuple[float, ...] = ()
    guess_mode: bool = False
    loop_back_frames: bool = False

    # ip-adapter
    use_ipadapter: bool = False
    ipa_scale: float = 0.65
    do_initial_generation: bool = False
    ipadapter_image_encoder_path: Optional[str] = None
    ipadapter_ckpt_path: Optional[str] = None

    # upscaler
    upscale: float = 1.0
    use_face_enhancer: bool = False
    upscale_first: bool = False
    upscaler_model_path: Optional[str] = None
    face_enhancer_model_path: Optional[str] = None
    face_detector_model_path: Optional[str] = None

    # window geometry; total_frames is the txt2vid length (0 = one window)
    frame_count: int = 16
    overlap_length: int = 8
    total_frames: int = 0

    # sampling
    seed: int = -1
    steps: int = 30
    guidance_scale: float = 7.5
    strength: float = 1.0
    scheduler: str = "EulerDiscreteScheduler"
    lcm_origin_steps: int = 50
    clip_skip: int = 0
    encoder_reuse_every: int = 0
    temporal_band: int = 0
    token_merge_ratio: float = 0.0
    token_merge_motion: bool = False
    token_merge_min_tokens: int = 4096

    # media
    fps: int = 15
    fps_ffmpeg: int = 30
    crf: int = 23
    ffmpeg_path: str = "ffmpeg"

    # textual inversion
    textual_inversion_paths: tuple[str, ...] = ("models/TI/easynegative.safetensors",)

    # job checkpoint / resume, profiling
    checkpoint_interval: int = 4
    resume: bool = False
    trace_dir: Optional[str] = None

    # execution policy
    dtype: str = "bfloat16"
    mesh_shape: tuple[int, ...] = ()
    mesh_axes: tuple[str, ...] = ("data", "context")
    parallel_segments: int = 0
    use_pallas_attention: bool = False
    # K2 (ops/conv_kernel.py) on the VAE's GroupNorm -> SiLU -> conv3x3
    use_pallas_conv: bool = False
    overlap_host_work: bool = True
    use_native_framepipe: bool = True

    extras: dict = field(default_factory=dict, hash=False, compare=False)

    @property
    def start_seconds(self) -> Optional[float]:
        return _parse_hms(self.start_time)

    @property
    def end_seconds(self) -> Optional[float]:
        return _parse_hms(self.end_time)

    @staticmethod
    def from_yaml(path: str | Path) -> "RunConfig":
        return RunConfig.from_dict(_load_yaml(path))

    @staticmethod
    def from_dict(raw: dict) -> "RunConfig":
        known = {f.name: f for f in dataclasses.fields(RunConfig)}
        kwargs: dict[str, Any] = {}
        extras: dict[str, Any] = {}
        for k, v in raw.items():
            if k not in known:
                extras[k] = v
                continue
            if k in _BOOL_KEYS:
                v = _as_bool(v)
            elif k in _TUPLE_KEYS:
                v = tuple(v) if v is not None else ()
            elif v is not None and known[k].type in ("int", int):
                v = int(v)
            kwargs[k] = v
        kwargs["extras"] = extras
        return RunConfig(**kwargs)

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


_BOOL_KEYS = frozenset({
    "save_frames", "use_lcm", "use_img2img", "guess_mode", "loop_back_frames",
    "use_ipadapter", "do_initial_generation", "use_face_enhancer", "upscale_first",
    "use_pallas_attention", "use_pallas_conv", "overlap_host_work",
    "use_native_framepipe", "resume", "reuse_overlap_latents",
})
_TUPLE_KEYS = frozenset({
    "lora_model_paths", "lora_weights", "controlnets", "cond_scale", "motion_lora_paths",
    "motion_lora_alphas", "textual_inversion_paths", "mesh_shape", "mesh_axes",
})


def require_ported(cfg: RunConfig) -> None:
    """Raise NotImplementedError, naming the key, for any setting whose
    behaviour the port lacks (the facade and the vid2vid loop both call
    this); KeyError for a ControlNet name that selects no annotator. Names
    are checked only: a depth folder's network (DPT, DPT-hybrid or GLPN)
    is checked when the pipeline reads it."""
    from .models.annotators import annotator_name

    for name in cfg.controlnets:
        annotator_name(name)
    unported = {
        "mesh_shape": (bool(cfg.mesh_shape), "device meshes (M15b)"),
        "temporal_band": (bool(cfg.temporal_band), "banded motion attention (M14)"),
        "token_merge_ratio": (bool(cfg.token_merge_ratio), "token merging (M14)"),
        "encoder_reuse_every": (bool(cfg.encoder_reuse_every), "encoder reuse (M14)"),
    }
    for key, (bad, what) in unported.items():
        if bad:
            raise NotImplementedError(
                f"RunConfig.{key}={getattr(cfg, key)!r}: {what} is not ported yet")


@dataclass
class StitchState:
    """Per-window generation state of the vid2vid loop (a copy of the JAX
    package's `StitchState`). The output-side frames are stacked uint8:
    CUDA (or CPU) tensors during a run, numpy arrays after a resume. Nothing
    writes into a tensor this state holds: the stitch returns fresh tensors,
    so a checkpoint snapshot may keep references."""

    epoch: int = 0
    seed: int = 0
    # previous window's output frames for the overlap slots: (K, H, W, 3)
    overlap_frames: Optional[Any] = None
    # previous window's input frames re-presented in the overlap slots
    overlap_input_frames: list = field(default_factory=list)
    # the previous window's last outputs, fed to the next window's prepare
    last_output_frames: Optional[Any] = None
    # color-match reference frame: (H, W, 3)
    last_output_frame: Optional[Any] = None

    @property
    def overlap_length(self) -> int:
        return 0 if self.overlap_frames is None else int(self.overlap_frames.shape[0])


# "float16"/"fp16" run as bf16, as in the JAX package's facade
_DTYPES = {
    "float32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.bfloat16, "fp16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The run dtype named by `RunConfig.dtype`."""
    try:
        return _DTYPES[str(name).lower()]
    except KeyError:
        raise ValueError(f"unknown RunConfig.dtype {name!r}") from None
