"""DPM-Solver++ (2M multistep) sampler, table-driven.

Counterpart of `controlanimate_tpu/schedulers/dpm.py`: the data-prediction
multistep solver of order 2 on epsilon prediction, first order at the
first step and at the last one when fewer than 15 steps run (JAX's
defaults, which its engine never changes). The state is the previous
step's x0 estimate.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import Scheduler, register
from .common import DiffusionSchedule, truncate_for_strength


@register("DPMSolverMultistepScheduler")
class DPMSolverMultistepScheduler(Scheduler):
    def __init__(self, schedule: DiffusionSchedule, num_inference_steps: int,
                 strength: float = 1.0):
        super().__init__(schedule)
        T = schedule.num_train_timesteps
        S = num_inference_steps
        ts = np.linspace(0, T - 1, S + 1).round()[::-1][:-1].astype(np.int64).copy()
        ts = truncate_for_strength(ts, S, strength)
        self.timesteps = ts
        n = len(ts)
        self.num_steps = n
        self.init_noise_sigma = 1.0

        abar = schedule.alphas_cumprod
        alpha = np.sqrt(abar)
        sigma = np.sqrt(1.0 - abar)
        lam = np.log(alpha) - np.log(sigma)
        t_prev = np.concatenate([ts[1:], [0]])
        t_prevprev = np.concatenate([[ts[0]], ts[:-1]])  # t_{i-1}, unused at i = 0
        h = lam[t_prev] - lam[ts]
        h_0 = lam[ts] - lam[t_prevprev]
        r0 = np.where(h != 0, h_0 / np.where(h == 0, 1.0, h), 1.0)
        self.a_t = alpha[ts].astype(np.float32)
        self.s_t = sigma[ts].astype(np.float32)
        self.sigma_ratio = (sigma[t_prev] / sigma[ts]).astype(np.float32)
        self.alpha_expm1 = (alpha[t_prev] * (np.exp(-h) - 1.0)).astype(np.float32)
        self.inv_r0 = np.where(r0 != 0, 1.0 / np.where(r0 == 0, 1.0, r0), 0.0).astype(np.float32)
        self.first_order = np.zeros(n, dtype=bool)
        if n:
            self.first_order[0] = True
            if n < 15:
                self.first_order[-1] = True

    def init_state(self, shape, device=None):
        return torch.zeros(tuple(shape), dtype=torch.float32, device=device)  # previous x0

    def step(self, i, model_output, sample, state=(), noise=None):
        a_t, s_t = float(self.a_t[i]), float(self.s_t[i])
        x0 = (sample - s_t * model_output) / a_t
        e = self.alpha_expm1[i]
        prev = float(self.sigma_ratio[i]) * sample - float(e) * x0
        if not self.first_order[i]:
            d1 = (x0 - state) * float(self.inv_r0[i])
            prev = prev - float(np.float32(0.5) * e) * d1
        return prev, x0
