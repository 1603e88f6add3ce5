"""Scheduler protocol and registry.

Counterpart of `controlanimate_tpu/schedulers/base.py`. A scheduler is built
per (schedule, num_steps, strength); its `step` is indexed by the inference
step and threads an explicit history `state` (LMS derivatives, PNDM's
epsilons, DPM-Solver's previous x0; `init_state` makes the first one), as in
the JAX package. The caller owns every random draw: a sampler that needs
fresh noise at step i says so by `needs_noise(i)`, and the caller passes the
draw to `step` (the engine takes it from `NoiseSource.step(i, (1, ...))`,
shared over the batch as JAX's `batch_shared_normal` shares it).

The tables are numpy fp32, as the JAX package keeps them on the device; a
step's scalar factors are computed in np.float32 and enter the tensor
arithmetic as Python floats (exact fp32 values).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .common import DiffusionSchedule


class Scheduler:
    """Base scheduler. Subclasses set `timesteps` (np.ndarray (S,)),
    `num_steps` and `init_noise_sigma` at construction."""

    timesteps: np.ndarray
    num_steps: int
    init_noise_sigma: float

    def __init__(self, schedule: DiffusionSchedule):
        self.schedule = schedule
        self.alphas_cumprod = np.asarray(schedule.alphas_cumprod, np.float32)

    def init_state(self, shape, device=None) -> Any:
        """The history carry before step 0; none by default."""
        return ()

    def scale_model_input(self, i: int, sample: torch.Tensor) -> torch.Tensor:
        return sample

    def needs_noise(self, i: int) -> bool:
        """Whether step `i` takes a fresh Gaussian draw (`step`'s `noise`)."""
        return False

    def step(self, i: int, model_output, sample, state=(), noise=None):
        """One denoise update at inference step `i`; returns (next sample,
        next state)."""
        raise NotImplementedError

    def add_noise_t(self, x0, noise, t: int):
        """DDPM forward: noise a clean latent to train timestep `t`."""
        abar = self.alphas_cumprod[int(t)]
        return float(np.sqrt(abar)) * x0 + float(np.sqrt(np.float32(1.0) - abar)) * noise

    def add_noise(self, x0, noise, i: int):
        """Noise a clean latent to the level of inference step `i` (the
        sigma-space samplers override this)."""
        return self.add_noise_t(x0, noise, int(np.round(self.timesteps[i])))

    def pred_original(self, model_output, sample, abar_t: float,
                      prediction_type: str = "epsilon"):
        """x0 from the model output (epsilon / v / sample prediction)."""
        abar_t = np.float32(abar_t)
        sqrt_ab = float(np.sqrt(abar_t))
        sqrt_1mab = float(np.sqrt(np.float32(1.0) - abar_t))
        if prediction_type == "epsilon":
            return (sample - sqrt_1mab * model_output) / sqrt_ab
        if prediction_type == "v_prediction":
            return sqrt_ab * sample - sqrt_1mab * model_output
        if prediction_type == "sample":
            return model_output
        raise ValueError(f"unknown prediction_type {prediction_type!r}")


_REGISTRY: dict[str, Callable[..., Scheduler]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def make_scheduler(
    name: str,
    schedule: DiffusionSchedule,
    num_inference_steps: int,
    strength: float = 1.0,
    **kwargs,
) -> Scheduler:
    """Build a scheduler by its diffusers-style registry name."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scheduler {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](schedule, num_inference_steps, strength=strength, **kwargs)


def available_schedulers() -> list[str]:
    return sorted(_REGISTRY)
