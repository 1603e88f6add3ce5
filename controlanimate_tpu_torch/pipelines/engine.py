"""AnimationEngine: one window, prepare -> denoise -> decode.

Counterpart of `controlanimate_tpu/pipelines/engine.py`:
  * prepare: the native-LCM window VAE-encodes its input frames (posterior
    sampled with injected noise; the overlap frames' clean latents may come
    from the previous window, `head_latents`) and noises them to the first
    timestep. A window of a multi-step sampler starts from pure noise times
    `init_noise_sigma`, unless it has last outputs and `strength` < 1: then
    the overlap slots take the last outputs' latents and the other frames
    the last of them (the input frames' latents under `use_img2img`),
    noised to the first step (x0 + sigma * eps for Euler and LMS). An encode
    whose result JAX discards is skipped; the draws come from the same
    streams.
  * denoise: the sampler's loop over `UNet3DConditionModel` as a Python loop.
    Under native LCM the guidance scale enters as the w-embedding. Otherwise,
    with guidance_scale > 1 (`do_cfg`), the latents run doubled as
    [uncond, cond] against the stacked [negative, positive] text, and the
    guided output uncond + g * (cond - uncond) goes to the sampler's `step`
    with its history state. The latents, the guidance combination and the
    sampler arithmetic stay fp32; only the model inputs take the run dtype.
  * decode: VAE decode of the whole window in one pass, quantised to uint8.

Every random draw comes from one `NoiseSource`, whose key tree follows the JAX
engine's: (k_prep, k_loop) = split(key); (k_noise, k_in, k_out) =
split(k_prep, 3); step i draws from fold_in(k_loop, i). `TorchNoise` draws
each stream from its own seeded `torch.Generator` on the run's device; the
tests pass the JAX engine's own draws instead.

ControlNets run as in the JAX engine: the window's condition maps (one
(B, F, H, W, 3) tensor a net, uint8 divided by 255 on the device) go with
the step's input, its timestep and the text through each net, each net
applies its own conditioning scale and the window's guess mode, and the
residuals summed over the nets enter the UNet. Under native LCM, without
CFG, or in guess mode (cond-only) the nets take the single scaled latents
and the positive text, and under CFG their residuals serve both halves;
otherwise they take the doubled latents, both texts and the maps twice.
With IP-Adapter tokens (`ip_tokens`) at the text's tail, the UNet's
cross-attentions take them at `ipa_scale` and the ControlNets see the text
without them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, Sequence

import torch

from ..models.controlnet import ControlNetModel, sum_controlnet_residuals
from ..models.unet3d import UNet3DConditionModel
from ..models.vae import AutoencoderKL
from ..schedulers import DiffusionSchedule, Scheduler, make_scheduler


def get_w_embedding(w: torch.Tensor, embedding_dim: int = 256) -> torch.Tensor:
    """Sinusoidal guidance-scale embedding for LCM UNets, [sin, cos] order."""
    w = w.float() * 1000.0
    half = embedding_dim // 2
    emb = math.log(10000.0) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=w.device) * -emb)
    emb = w[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


class NoiseSource(Protocol):
    """Where a window's Gaussian draws come from; each method returns a
    float32 tensor of exactly `shape` on the run's device."""

    def initial(self, shape) -> torch.Tensor: ...  # k_noise: the latent noise
    def encode(self, shape) -> torch.Tensor: ...  # k_in: input-frame posterior
    def last_output(self, shape) -> torch.Tensor: ...  # k_out: last-output posterior
    def step(self, i: int, shape) -> torch.Tensor: ...  # fold_in(k_loop, i)


class TorchNoise:
    """The default `NoiseSource`: stream s of seed n draws from a
    `torch.Generator` on `device` seeded with n * 1_000_003 + s (initial 0,
    encode 1, last_output 2, step i 3 + i). Every call of a stream restarts
    it, as a JAX key draws the same numbers each time it is used."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def _draw(self, stream: int, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (2**63))
        return torch.randn(tuple(shape), generator=g, device=self.device, dtype=torch.float32)

    def initial(self, shape):
        return self._draw(0, shape)

    def encode(self, shape):
        return self._draw(1, shape)

    def last_output(self, shape):
        return self._draw(2, shape)

    def step(self, i, shape):
        return self._draw(3 + int(i), shape)


@dataclass
class EngineModels:
    """The modules the engine drives; `cond_scales` and `annotators` (an
    annotator maps (F, H, W, 3) uint8 frames to float maps in [0, 1]) go
    with `controlnets`, one each."""

    unet: UNet3DConditionModel
    vae: AutoencoderKL
    controlnets: Sequence[ControlNetModel] = ()
    cond_scales: Sequence[float] = ()
    annotators: Sequence[Callable[[torch.Tensor], torch.Tensor]] = ()


@dataclass(frozen=True)
class WindowStatic:
    """Window configuration: the fields of the JAX engine's `WindowStatic`
    that its windows read, with its defaults."""

    scheduler_name: str = "EulerDiscreteScheduler"  # unused under use_lcm
    steps: int = 30
    strength: float = 1.0
    guidance_scale: float = 7.5  # the LCM w-embedding, else CFG's scale
    use_lcm: bool = False
    lcm_origin_steps: int = 50
    guess_mode: bool = False  # ControlNet residuals scaled by logspace(-1, 0)
    use_img2img: bool = False  # non-overlap frames from the input frames' latents
    ipa_scale: float = 1.0  # the UNet's image stream (IP-Adapter)
    ip_tokens: int = 0  # IP-Adapter image tokens at the text's tail
    frame_count: int = 16  # txt2vid geometry (no input frames to infer it from)
    height: int = 512
    width: int = 512
    output_uint8: bool = False
    tail_latents: int = 0  # also return this many clean tail latents (LCM only)

    @property
    def do_cfg(self) -> bool:
        return self.guidance_scale > 1.0 and not self.use_lcm


class AnimationEngine:
    def __init__(self, models: EngineModels, schedule: DiffusionSchedule):
        self.m = models
        self.schedule = schedule

    def build_scheduler(self, st: WindowStatic) -> Scheduler:
        if st.use_lcm:
            return make_scheduler(
                "LCMScheduler", self.schedule, st.steps, strength=st.strength,
                lcm_origin_steps=st.lcm_origin_steps, strength_mode="origin",
            )
        kw = {}
        if st.scheduler_name == "LCMScheduler":
            # LCM-LoRA profiles: the full LCM table, then img2img tail truncation
            kw = {"lcm_origin_steps": st.lcm_origin_steps, "strength_mode": "tail"}
        return make_scheduler(st.scheduler_name, self.schedule, st.steps,
                              strength=st.strength, **kw)

    # -- VAE -----------------------------------------------------------------
    def encode_frames(self, frames: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """(B, F, H, W, 3) uint8 or [-1, 1] float -> (B, F, h, w, 4) scaled
        latents; `noise` (F, h, w, 4) is shared by every batch element."""
        if frames.dtype == torch.uint8:
            frames = frames.float() / 127.5 - 1.0
        B, F_ = frames.shape[:2]
        flat = frames.reshape(B * F_, *frames.shape[2:])
        lat = self.m.vae.encode(flat, noise.repeat(B, 1, 1, 1))
        return lat.reshape(B, F_, *lat.shape[1:])

    def decode_latents(self, latents: torch.Tensor, to_uint8: bool = False) -> torch.Tensor:
        """(B, F, h, w, 4) -> (B, F, H, W, 3) in [0, 1], or uint8 [0, 255]."""
        B, F_ = latents.shape[:2]
        img = self.m.vae.decode(latents.reshape(B * F_, *latents.shape[2:]))
        img = (img / 2 + 0.5).clamp(0.0, 1.0)
        if to_uint8:
            img = (img.float() * 255.0 + 0.5).to(torch.uint8)
        return img.reshape(B, F_, *img.shape[1:])

    # -- prepare -------------------------------------------------------------
    def prepare_latents(self, st: WindowStatic, sched: Scheduler, noise: NoiseSource,
                        latent_shape: tuple, input_frames: Optional[torch.Tensor],
                        last_output_frames: Optional[torch.Tensor],
                        head_latents: Optional[torch.Tensor] = None):
        """The noised latents, plus the clean tail latents when
        st.tail_latents > 0 (native LCM only)."""
        B = latent_shape[0]
        base = noise.initial((1, *latent_shape[1:])).expand(latent_shape)
        if not st.use_lcm:
            if st.tail_latents or head_latents is not None:
                raise ValueError("overlap-latent reuse is for the native-LCM window only")
            return self._prepare_multistep(st, sched, noise, latent_shape, base, input_frames,
                                           last_output_frames)
        if st.tail_latents and input_frames is None:
            raise ValueError("tail latents need input frames")

        if input_frames is None:
            if last_output_frames is None:
                return base * sched.init_noise_sigma
            # txt2vid overlap window: last outputs' latents fill the overlap
            # slots, the last one pads the rest
            K = last_output_frames.shape[1]
            last_latents = self.encode_frames(
                last_output_frames, noise.last_output((K, *latent_shape[2:]))
            )
            anchor = last_latents[:, -1:].expand(B, latent_shape[1] - K, *latent_shape[2:])
            return sched.add_noise(torch.cat([last_latents, anchor], dim=1), base, 0)

        if head_latents is not None:
            K = head_latents.shape[1]
            F_new = input_frames.shape[1] - K
            novel = self.encode_frames(
                input_frames[:, K:], noise.encode((F_new, *latent_shape[2:]))
            )
            frames_latents = torch.cat([head_latents.to(novel.dtype), novel], dim=1)
        else:
            frames_latents = self.encode_frames(
                input_frames, noise.encode((input_frames.shape[1], *latent_shape[2:]))
            )
        noised = sched.add_noise(frames_latents, base, 0)
        if st.tail_latents:
            return noised, frames_latents[:, -st.tail_latents:]
        return noised

    def _prepare_multistep(self, st: WindowStatic, sched: Scheduler, noise: NoiseSource,
                           latent_shape: tuple, base: torch.Tensor,
                           input_frames: Optional[torch.Tensor],
                           last_output_frames: Optional[torch.Tensor]) -> torch.Tensor:
        """A multi-step sampler's first latents: pure noise times
        `init_noise_sigma`, unless the window has last outputs and
        strength < 1; then the overlap slots take the last outputs' latents,
        the other frames the last of them (under `use_img2img` the input
        frames' latents), noised to the first step."""
        if last_output_frames is None or not st.strength < 1.0:
            return base * sched.init_noise_sigma
        K = last_output_frames.shape[1]
        last_latents = self.encode_frames(
            last_output_frames, noise.last_output((K, *latent_shape[2:])))
        if st.use_img2img and input_frames is not None:
            rest = self.encode_frames(
                input_frames, noise.encode((input_frames.shape[1], *latent_shape[2:])))[:, K:]
        else:
            rest = last_latents[:, -1:].expand(latent_shape[0], latent_shape[1] - K,
                                               *latent_shape[2:])
        return sched.add_noise(torch.cat([last_latents, rest], dim=1).float(), base, 0)

    # -- denoise -------------------------------------------------------------
    def controlnet_residuals(self, st: WindowStatic, latents: torch.Tensor, t: torch.Tensor,
                             text_embeds: torch.Tensor, cond_images: Sequence[torch.Tensor]):
        """Each net on the step's input with its text, its own scale and the
        window's guess mode; the residuals summed over the nets ((None, None)
        without nets)."""
        return sum_controlnet_residuals([
            net(latents, t, text_embeds, cond, conditioning_scale=float(scale),
                guess_mode=st.guess_mode)
            for net, scale, cond in zip(self.m.controlnets, self.m.cond_scales, cond_images)])

    def denoise(self, st: WindowStatic, sched: Scheduler, text_embeds: torch.Tensor,
                latents: torch.Tensor, noise: NoiseSource,
                cond_images: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        n_cn = len(self.m.controlnets)
        if st.ip_tokens != self.m.unet.config.ip_tokens:
            raise ValueError(f"the window has {st.ip_tokens} IP-Adapter tokens, the UNet takes "
                             f"{self.m.unet.config.ip_tokens}")
        if len(cond_images) != n_cn or len(self.m.cond_scales) != n_cn:
            raise ValueError(f"{n_cn} ControlNets, {len(self.m.cond_scales)} conditioning "
                             f"scales and {len(cond_images)} condition maps")
        # condition maps arrive as uint8 (the annotators' quantised output)
        cond_images = [c.float() / 255.0 if c.dtype == torch.uint8 else c for c in cond_images]
        B = latents.shape[0]
        cfg = st.do_cfg
        # the nets take the single latents and the positive text unless CFG
        # runs without guess mode
        cn_cond_only = st.use_lcm or st.guess_mode or not cfg
        cn_text = text_embeds[B:] if cfg and cn_cond_only else text_embeds
        if st.ip_tokens:
            # the ControlNets are text-only: the image tokens stay the UNet's
            cn_text = cn_text[:, :-st.ip_tokens]
        if not cn_cond_only:
            cond_images = [torch.cat([c, c]) for c in cond_images]
        w_emb = None
        if st.use_lcm:
            w_dim = self.m.unet.config.time_cond_proj_dim or 256
            w_emb = get_w_embedding(
                torch.full((B,), st.guidance_scale, dtype=torch.float32, device=latents.device),
                w_dim)
        ts = torch.as_tensor(sched.timesteps.round().astype("int64"), device=latents.device)
        state = sched.init_state(latents.shape, latents.device)
        for i in range(sched.num_steps):
            scaled = sched.scale_model_input(i, latents)
            model_in = torch.cat([scaled, scaled]) if cfg else scaled
            down_res, mid_res = self.controlnet_residuals(
                st, scaled if cn_cond_only else model_in, ts[i], cn_text, cond_images)
            if cfg and cn_cond_only and down_res is not None:
                # guess mode under CFG: the residuals serve both halves
                down_res = [torch.cat([d, d]) for d in down_res]
                mid_res = torch.cat([mid_res, mid_res])
            model_out = self.m.unet(model_in, ts[i], text_embeds, timestep_cond=w_emb,
                                    down_block_additional_residuals=down_res,
                                    mid_block_additional_residual=mid_res,
                                    ip_scale=st.ipa_scale).float()
            if cfg:
                uncond, cond = model_out.chunk(2)
                model_out = uncond + st.guidance_scale * (cond - uncond)
            step_noise = None
            if sched.needs_noise(i):
                step_noise = noise.step(i, (1, *latents.shape[1:])).expand(latents.shape)
            latents, state = sched.step(i, model_out, latents, state, step_noise)
        return latents

    # -- window --------------------------------------------------------------
    @torch.no_grad()
    def generate_window(
        self,
        st: WindowStatic,
        text_embeds: torch.Tensor,
        noise: NoiseSource,
        input_frames: Optional[torch.Tensor] = None,
        last_output_frames: Optional[torch.Tensor] = None,
        head_latents: Optional[torch.Tensor] = None,
        cond_images: Sequence[torch.Tensor] = (),
    ):
        """One window: (B, F, H, W, 3) frames in [0, 1] (uint8 when
        st.output_uint8), plus the clean tail latents when st.tail_latents.
        `text_embeds` is (2B, L, D), [negative, positive], under CFG
        (st.do_cfg), else (B, L, D); `cond_images` holds one (B, F, H, W, 3)
        condition map a ControlNet."""
        sched = self.build_scheduler(st)
        if sched.num_steps == 0:
            raise ValueError(
                f"steps*strength truncated to zero denoise steps "
                f"(steps={st.steps}, strength={st.strength}); raise either value"
            )
        B = text_embeds.shape[0] // 2 if st.do_cfg else text_embeds.shape[0]
        if input_frames is not None:
            F_, H, W = input_frames.shape[1:4]
        else:
            F_, H, W = st.frame_count, st.height, st.width
        latent_shape = (B, F_, H // 8, W // 8, 4)
        latents = self.prepare_latents(
            st, sched, noise, latent_shape, input_frames, last_output_frames, head_latents
        )
        tail = None
        if st.tail_latents:
            latents, tail = latents
        latents = self.denoise(st, sched, text_embeds, latents, noise, cond_images)
        out = self.decode_latents(latents, st.output_uint8)
        return (out, tail) if st.tail_latents else out
