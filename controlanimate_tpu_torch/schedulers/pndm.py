"""PNDM (PLMS) sampler with skip_prk, table-driven.

Counterpart of `controlanimate_tpu/schedulers/pndm.py`: leading timesteps
with `steps_offset` 1, the second-highest one repeated for the warm-up
iteration (S + 1 model calls for S steps), img2img truncation slicing the
built sequence, `set_alpha_to_one` off, epsilon prediction (the defaults
the JAX engine builds it with). Iteration i runs Adams-Bashforth
of order min(i, 4) on the epsilon history; iteration 1 averages the first
two epsilons from the sample of iteration 0. The state is (the epsilon
history newest first, the sample of iteration 0).
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Scheduler, register
from .common import DiffusionSchedule, truncate_for_strength


@register("PNDMScheduler")
class PNDMScheduler(Scheduler):
    def __init__(self, schedule: DiffusionSchedule, num_inference_steps: int,
                 strength: float = 1.0):
        super().__init__(schedule)
        T = schedule.num_train_timesteps
        S = num_inference_steps
        step_ratio = T // S
        base = (np.arange(0, S) * step_ratio).round().astype(np.int64) + 1  # steps_offset
        plms = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
        if strength < 1.0:
            plms = truncate_for_strength(plms, S, strength).copy()
        self.timesteps = plms
        n = len(plms)
        self.num_steps = n
        self.init_noise_sigma = 1.0

        abar = schedule.alphas_cumprod
        t_eff = plms.copy()
        t_prev = plms - step_ratio
        if n >= 2:
            # iteration 1 evaluates the transition (t1 + ratio) -> t1
            t_eff[1] = plms[1] + step_ratio
            t_prev[1] = plms[1]
        a_t = abar[np.clip(t_eff, 0, T - 1)]
        a_prev = np.where(t_prev >= 0, abar[np.clip(t_prev, 0, None)], abar[0])
        denom = a_t * np.sqrt(1.0 - a_prev) + np.sqrt(a_t * (1.0 - a_t) * a_prev)
        self.sample_coeff = np.sqrt(a_prev / a_t).astype(np.float32)
        self.diff_coeff = ((a_prev - a_t) / denom).astype(np.float32)

    def init_state(self, shape, device=None):
        ets = torch.zeros((4, *shape), dtype=torch.float32, device=device)
        return ets, torch.zeros(tuple(shape), dtype=torch.float32, device=device)

    def step(self, i, model_output, sample, state=(), noise=None):
        ets, cur_sample = state
        e = model_output
        mode = min(i, 4)
        if mode == 1:
            combo = (e + ets[0]) / 2.0
            sample_eff = cur_sample
        else:
            ets = torch.cat([e[None], ets[:-1]])
            if mode == 0:
                combo = e
                cur_sample = sample
            elif mode == 2:
                combo = (3.0 * ets[0] - ets[1]) / 2.0
            elif mode == 3:
                combo = (23.0 * ets[0] - 16.0 * ets[1] + 5.0 * ets[2]) / 12.0
            else:
                combo = (55.0 * ets[0] - 59.0 * ets[1] + 37.0 * ets[2] - 9.0 * ets[3]) / 24.0
            sample_eff = sample
        prev = float(self.sample_coeff[i]) * sample_eff - float(self.diff_coeff[i]) * combo
        return prev, (ets, cur_sample)
