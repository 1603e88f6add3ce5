"""Euler and Euler-ancestral discrete samplers, in sigma space.

Counterpart of `controlanimate_tpu/schedulers/euler.py` on epsilon
prediction (the JAX engine's default): linspace timesteps,
the sigma table interpolated at them (plus a final 0), `add_noise` as
x0 + sigma * eps, `scale_model_input` dividing by sqrt(sigma^2 + 1), and
`init_noise_sigma` the largest sigma. The default profile
(`configs/prompts/SampleConfig.yaml`) samples with Euler at 30 steps.
"""

from __future__ import annotations

import numpy as np

from .base import Scheduler, register
from .common import DiffusionSchedule, interp_sigmas, linspace_timesteps, truncate_for_strength


class _SigmaScheduler(Scheduler):
    """Shared machinery of the sigma-space samplers (Euler family, LMS)."""

    def __init__(self, schedule: DiffusionSchedule, num_inference_steps: int,
                 strength: float = 1.0):
        super().__init__(schedule)
        ts = linspace_timesteps(schedule.num_train_timesteps, num_inference_steps)
        ts = truncate_for_strength(ts, num_inference_steps, strength)
        self.timesteps = ts
        self.num_steps = len(ts)
        sig = interp_sigmas(ts, schedule.alphas_cumprod)
        self._sigmas_np = np.concatenate([sig, [0.0]])
        self.sigmas = self._sigmas_np.astype(np.float32)
        self.init_noise_sigma = float(sig.max()) if len(sig) else 1.0

    def scale_model_input(self, i, sample):
        sigma = self.sigmas[i]
        return sample / float(np.sqrt(sigma**2 + np.float32(1.0)))

    def add_noise(self, x0, noise, i):
        return x0 + float(self.sigmas[i]) * noise

    def _derivative(self, i, model_output, sample):
        # (sample - x0) / sigma with x0 = sample - sigma * eps, rounded as JAX rounds it
        sigma = float(self.sigmas[i])
        return (sample - (sample - sigma * model_output)) / sigma


@register("EulerDiscreteScheduler")
class EulerDiscreteScheduler(_SigmaScheduler):
    def step(self, i, model_output, sample, state=(), noise=None):
        d = self._derivative(i, model_output, sample)
        return sample + d * float(self.sigmas[i + 1] - self.sigmas[i]), state


@register("EulerAncestralDiscreteScheduler")
class EulerAncestralDiscreteScheduler(_SigmaScheduler):
    def __init__(self, schedule, num_inference_steps, strength=1.0):
        super().__init__(schedule, num_inference_steps, strength)
        s = self._sigmas_np
        s_from, s_to = s[:-1], s[1:]
        with np.errstate(divide="ignore", invalid="ignore"):
            up2 = s_to**2 * (s_from**2 - s_to**2) / np.where(s_from == 0, 1.0, s_from**2)
        sigma_up = np.sqrt(np.maximum(up2, 0.0))
        self.sigma_up = sigma_up.astype(np.float32)
        self.sigma_down = np.sqrt(np.maximum(s_to**2 - sigma_up**2, 0.0)).astype(np.float32)

    def needs_noise(self, i: int) -> bool:
        # JAX draws at every step; the last step's sigma_up is 0
        return bool(self.sigma_up[i] > 0)

    def step(self, i, model_output, sample, state=(), noise=None):
        d = self._derivative(i, model_output, sample)
        prev = sample + d * float(self.sigma_down[i] - self.sigmas[i])
        if self.needs_noise(i):
            prev = prev + noise * float(self.sigma_up[i])
        return prev, state
