"""Latent Consistency Model (LCM) sampler.

Counterpart of `controlanimate_tpu/schedulers/lcm.py`: timesteps strided out of
the `lcm_origin_steps * strength` training steps, consistency boundary
scalings c_skip / c_out (sigma_data 0.5, timestep scaling x10), and
multi-step re-noising to the next timestep with noise the caller draws.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, register
from .common import DiffusionSchedule, truncate_for_strength


@register("LCMScheduler")
class LCMScheduler(Scheduler):
    def __init__(
        self,
        schedule: DiffusionSchedule,
        num_inference_steps: int,
        strength: float = 1.0,
        lcm_origin_steps: int = 50,
        prediction_type: str = "epsilon",
        sigma_data: float = 0.5,
        timestep_scaling: float = 10.0,
        strength_mode: str = "origin",
    ):
        """strength_mode 'origin' scales the origin-step count before striding
        (the native-LCM path); 'tail' takes the full table then truncates the
        tail for img2img (LCM-LoRA profiles)."""
        super().__init__(schedule)
        T = schedule.num_train_timesteps
        S = num_inference_steps
        c = T // lcm_origin_steps
        origin_strength = strength if strength_mode == "origin" else 1.0
        origin = np.arange(1, int(lcm_origin_steps * origin_strength) + 1) * c - 1
        skipping = max(len(origin) // S, 1)
        ts = origin[::-skipping][:S].astype(np.int64).copy()  # descending, strided
        if strength_mode == "tail" and strength < 1.0:
            ts = truncate_for_strength(ts, S, strength)
        self.timesteps = ts
        self.num_steps = len(ts)
        self.init_noise_sigma = 1.0
        self.prediction_type = prediction_type

        abar = schedule.alphas_cumprod
        ts_next = np.concatenate([ts[1:], [0]])
        scaled_t = ts.astype(np.float64) * timestep_scaling
        self.abar_t = abar[ts].astype(np.float32)
        self.abar_next = abar[ts_next].astype(np.float32)
        self.c_skip = (sigma_data**2 / (scaled_t**2 + sigma_data**2)).astype(np.float32)
        self.c_out = (scaled_t / np.sqrt(scaled_t**2 + sigma_data**2)).astype(np.float32)

    def needs_noise(self, i: int) -> bool:
        # the last step emits the denoised estimate (JAX draws and drops it)
        return i < self.num_steps - 1

    def step(self, i: int, model_output, sample, state=(), noise=None):
        """Denoised estimate at step i, re-noised to the next timestep with
        `noise` unless i is the last step."""
        x0 = self.pred_original(model_output, sample, float(self.abar_t[i]), self.prediction_type)
        denoised = float(self.c_out[i]) * x0 + float(self.c_skip[i]) * sample
        if not self.needs_noise(i):
            return denoised, state
        a_n = self.abar_next[i]
        return (float(np.sqrt(a_n)) * denoised
                + float(np.sqrt(np.float32(1.0) - a_n)) * noise), state
