"""The UNet3D state dict from a diffusers 2D UNet state dict and an
AnimateDiff motion-module checkpoint.

Counterpart of `controlanimate_tpu/weights/unet_weights.py`
`unet_params_from_torch`. The port's modules carry the diffusers key names
(`weights/from_jax.py`), so this is key handling, not layout conversion:
  * every key the UNet has is looked up; a missing one raises KeyError (the
    JAX `strict_2d` rule for 2D keys; the JAX package initialises missing
    motion-module weights at random, the port does not);
  * motion-module keys come only from the motion file, with any `module.`
    prefix stripped; 2D keys absent from the 2D file are looked up in the
    motion file too;
  * keys the UNet does not have are ignored, among them the motion file's
    `pos_encoder.pe` tables: both packages compute the positional encoding.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch


def strip_module_prefix(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A motion-module checkpoint's keys without their `module.` prefix."""
    return {k.replace("module.", ""): v for k, v in sd.items()}


def unet_state_dict_from_torch(
    sd_2d: dict[str, torch.Tensor],
    keys: Iterable[str],
    motion_sd: Optional[dict[str, torch.Tensor]] = None,
) -> dict[str, torch.Tensor]:
    """The state dict over `keys` (the UNet's own state-dict keys)."""
    motion = strip_module_prefix(motion_sd or {})
    out: dict[str, torch.Tensor] = {}
    missing_2d, missing_motion = [], []
    for key in keys:
        if "motion_modules" in key:
            src = motion.get(key)
        else:
            src = sd_2d.get(key)
            if src is None:
                src = motion.get(key)
        if src is not None:
            out[key] = src
        elif "motion_modules" in key:
            missing_motion.append(key)
        else:
            missing_2d.append(key)
    if missing_2d:
        raise KeyError(f"missing UNet weight: {missing_2d[0]} ({len(missing_2d)} in all)")
    if missing_motion:
        raise KeyError(f"the motion-module checkpoint lacks {missing_motion[0]} "
                       f"({len(missing_motion)} keys in all)")
    return out
