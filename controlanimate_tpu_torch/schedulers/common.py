"""Shared diffusion-schedule math (numpy, host side).

A copy of `controlanimate_tpu/schedulers/common.py`, kept in the port so it
never imports the JAX package: the beta schedules, the zero-terminal-SNR
rescale, the leading and linspace timestep spacings, the img2img truncation
and the sigma tables of the sigma-space samplers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np


def make_betas(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "linear",
) -> np.ndarray:
    """Beta schedule table (float64)."""
    if beta_schedule == "linear":
        return np.linspace(beta_start, beta_end, num_train_timesteps, dtype=np.float64)
    if beta_schedule == "scaled_linear":
        return (
            np.linspace(beta_start**0.5, beta_end**0.5, num_train_timesteps, dtype=np.float64)
            ** 2
        )
    if beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t: float) -> float:
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.array(
            [
                min(1 - alpha_bar((i + 1) / num_train_timesteps) / alpha_bar(i / num_train_timesteps), 0.999)
                for i in range(num_train_timesteps)
            ],
            dtype=np.float64,
        )
    raise ValueError(f"unknown beta schedule: {beta_schedule!r}")


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so that the terminal SNR is zero (arXiv:2305.08891)."""
    alphas_bar_sqrt = np.sqrt(np.cumprod(1.0 - betas))
    a0 = alphas_bar_sqrt[0].copy()
    aT = alphas_bar_sqrt[-1].copy()
    alphas_bar_sqrt = (alphas_bar_sqrt - aT) * a0 / (a0 - aT)
    alphas_bar = alphas_bar_sqrt**2
    alphas = np.concatenate([alphas_bar[0:1], alphas_bar[1:] / alphas_bar[:-1]])
    return 1.0 - alphas


class DiffusionSchedule(NamedTuple):
    """Host-side (numpy) training-schedule tables."""

    betas: np.ndarray
    alphas: np.ndarray
    alphas_cumprod: np.ndarray

    @property
    def num_train_timesteps(self) -> int:
        return int(self.betas.shape[0])


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    beta_schedule: str = "linear",
    rescale_betas_zero_snr: bool = False,
) -> DiffusionSchedule:
    betas = make_betas(num_train_timesteps, beta_start, beta_end, beta_schedule)
    if rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    alphas = 1.0 - betas
    return DiffusionSchedule(betas=betas, alphas=alphas, alphas_cumprod=np.cumprod(alphas))


def leading_timesteps(
    num_train_timesteps: int, num_inference_steps: int, steps_offset: int = 0
) -> np.ndarray:
    """'leading' timestep spacing (DDIM, PNDM), descending integers."""
    if num_inference_steps > num_train_timesteps:
        raise ValueError(
            f"num_inference_steps ({num_inference_steps}) exceeds the training "
            f"schedule length ({num_train_timesteps})"
        )
    step_ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * step_ratio).round()[::-1].astype(np.int64)
    return ts + steps_offset


def linspace_timesteps(num_train_timesteps: int, num_inference_steps: int) -> np.ndarray:
    """'linspace' timestep spacing (Euler, LMS), descending floats."""
    return np.linspace(0, num_train_timesteps - 1, num_inference_steps,
                       dtype=np.float64)[::-1].copy()


def truncate_for_strength(
    timesteps: np.ndarray, num_inference_steps: int, strength: float
) -> np.ndarray:
    """img2img truncation: keep the last `steps*strength` timesteps."""
    init_timestep = min(int(num_inference_steps * strength), num_inference_steps)
    t_start = max(num_inference_steps - init_timestep, 0)
    return timesteps[t_start:]


def sigmas_from_alphas_cumprod(alphas_cumprod: np.ndarray) -> np.ndarray:
    """sigma = sqrt((1 - abar) / abar), the sigma-space samplers' noise level."""
    return np.sqrt((1.0 - alphas_cumprod) / alphas_cumprod)


def interp_sigmas(timesteps_f: np.ndarray, alphas_cumprod: np.ndarray) -> np.ndarray:
    """The sigma table interpolated at (possibly fractional) timesteps."""
    sig = sigmas_from_alphas_cumprod(alphas_cumprod)
    return np.interp(timesteps_f, np.arange(len(sig)), sig)
