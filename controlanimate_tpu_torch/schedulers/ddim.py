"""Deterministic DDIM sampler (eta 0), table-driven.

Counterpart of `controlanimate_tpu/schedulers/ddim.py` at the defaults the
JAX engine builds it with: epsilon prediction, leading timesteps with
`steps_offset` 1, `set_alpha_to_one` (the final step uses alpha 1),
`clip_sample` off. The JAX engine never passes `ArchConfig.steps_offset` or
`clip_sample`; the port's engine does the same.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, register
from .common import DiffusionSchedule, leading_timesteps, truncate_for_strength


@register("DDIMScheduler")
class DDIMScheduler(Scheduler):
    def __init__(self, schedule: DiffusionSchedule, num_inference_steps: int,
                 strength: float = 1.0):
        super().__init__(schedule)
        T = schedule.num_train_timesteps
        ts = leading_timesteps(T, num_inference_steps, 1)
        ts = truncate_for_strength(ts, num_inference_steps, strength)
        self.timesteps = ts
        self.num_steps = len(ts)
        self.init_noise_sigma = 1.0

        abar = schedule.alphas_cumprod
        prev_ts = ts - T // num_inference_steps
        abar_prev = np.where(prev_ts >= 0, abar[np.clip(prev_ts, 0, None)], 1.0)
        self.abar_t = abar[ts].astype(np.float32)
        self.abar_prev = abar_prev.astype(np.float32)

    def step(self, i, model_output, sample, state=(), noise=None):
        a_t, a_prev = self.abar_t[i], self.abar_prev[i]
        one = np.float32(1.0)
        x0 = self.pred_original(model_output, sample, a_t)
        # the direction term re-derives epsilon from x0, as JAX does
        eps = (sample - float(np.sqrt(a_t)) * x0) / float(np.sqrt(one - a_t))
        return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps, state
