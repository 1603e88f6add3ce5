"""The ControlNet state dict from a diffusers ControlNet checkpoint.

Counterpart of `controlanimate_tpu/weights/controlnet_weights.py`
`controlnet_params_from_torch`. The port's `ControlNetModel` carries the
diffusers key names, so this is a key check, not a layout conversion: every
key of the port's copy of the JAX key table (`weights/from_jax.py`
`controlnet_mapping`) must be in the checkpoint (KeyError otherwise), and
the checkpoint's other keys are ignored.
"""

from __future__ import annotations

from ..models.unet3d import UNet3DConfig
from .from_jax import controlnet_mapping


def controlnet_keys(cfg: UNet3DConfig, cond_levels: int = 4) -> list[str]:
    """The diffusers keys of a ControlNet of architecture `cfg`."""
    return [t for t, _, _ in controlnet_mapping(cfg, cond_levels)]


def controlnet_state_dict_from_torch(sd: dict, cfg: UNet3DConfig,
                                     cond_levels: int = 4) -> dict:
    """The entries of `sd` that a ControlNet of architecture `cfg` loads."""
    keys = controlnet_keys(cfg, cond_levels)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"missing ControlNet weight: {missing[0]} ({len(missing)} in all)")
    return {k: sd[k] for k in keys}
