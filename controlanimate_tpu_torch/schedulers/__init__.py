"""The port's samplers, registered under the JAX package's names (the
reference's diffusers scheduler names)."""

from .base import Scheduler, available_schedulers, make_scheduler
from .common import DiffusionSchedule, make_schedule
from .ddim import DDIMScheduler
from .dpm import DPMSolverMultistepScheduler
from .euler import EulerAncestralDiscreteScheduler, EulerDiscreteScheduler
from .lcm import LCMScheduler
from .lms import LMSDiscreteScheduler
from .pndm import PNDMScheduler

__all__ = [
    "Scheduler",
    "DiffusionSchedule",
    "make_schedule",
    "make_scheduler",
    "available_schedulers",
    "DDIMScheduler",
    "DPMSolverMultistepScheduler",
    "EulerDiscreteScheduler",
    "EulerAncestralDiscreteScheduler",
    "LCMScheduler",
    "LMSDiscreteScheduler",
    "PNDMScheduler",
]
