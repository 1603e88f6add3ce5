"""Linear multistep (LMS) sampler: Adams-Bashforth over the sigma ODE.

Counterpart of `controlanimate_tpu/schedulers/lms.py`. The Lagrange
coefficients of each step are the integrals of the basis polynomials over
[sigma_i, sigma_i+1]; JAX integrates them with `scipy.integrate.quad`, the
port exactly with `numpy.polynomial` (it takes no scipy). The state is the
derivative history, newest first.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.polynomial import Polynomial

from .base import register
from .euler import _SigmaScheduler


def lms_coefficients(sigmas: np.ndarray, steps: int, order: int) -> np.ndarray:
    """(steps, order) float64: coefficient j of step i integrates the
    Lagrange basis polynomial of node sigma[i - j] over the nodes
    sigma[i], ..., sigma[i - k + 1] (k = min(i + 1, order)) from sigma[i]
    to sigma[i + 1]."""
    coeffs = np.zeros((steps, order), dtype=np.float64)
    for i in range(steps):
        k = min(i + 1, order)
        for j in range(k):
            basis = Polynomial([1.0])
            for m in range(k):
                if m != j:
                    basis = basis * Polynomial([-sigmas[i - m], 1.0]) / (sigmas[i - j]
                                                                          - sigmas[i - m])
            integral = basis.integ()
            coeffs[i, j] = integral(sigmas[i + 1]) - integral(sigmas[i])
    return coeffs


@register("LMSDiscreteScheduler")
class LMSDiscreteScheduler(_SigmaScheduler):
    order = 4

    def __init__(self, schedule, num_inference_steps, strength=1.0):
        super().__init__(schedule, num_inference_steps, strength)
        self.coeffs = lms_coefficients(self._sigmas_np, self.num_steps,
                                       self.order).astype(np.float32)

    def init_state(self, shape, device=None):
        return torch.zeros((self.order, *shape), dtype=torch.float32, device=device)

    def step(self, i, model_output, sample, state=(), noise=None):
        d = self._derivative(i, model_output, sample)
        hist = torch.cat([d[None], state[:-1]])
        update = float(self.coeffs[i, 0]) * hist[0]
        for j in range(1, min(i + 1, self.order)):  # the other coefficients are 0
            update = update + float(self.coeffs[i, j]) * hist[j]
        return sample + update, hist
