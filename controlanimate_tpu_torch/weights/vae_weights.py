"""The VAE state dict from a diffusers AutoencoderKL state dict.

Counterpart of `controlanimate_tpu/weights/vae_weights.py`: the legacy
attention names of older exports (`query` / `key` / `value` / `proj_attn`)
become `to_q` / `to_k` / `to_v` / `to_out.0`, and their (C, C, 1, 1) conv
weights squeeze to (C, C). Every key the VAE has must be present (KeyError
otherwise); other keys are ignored.
"""

from __future__ import annotations

from typing import Iterable

import torch

_LEGACY_ATTN = {
    ".query.": ".to_q.",
    ".key.": ".to_k.",
    ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def normalize_vae_keys(sd: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        for old, new in _LEGACY_ATTN.items():
            if old in k:
                k = k.replace(old, new)
        # legacy attention projections may be (C, C, 1, 1) convs
        if any(t in k for t in (".to_q.", ".to_k.", ".to_v.", ".to_out.0.")):
            if k.endswith("weight") and v.ndim == 4:
                v = v[:, :, 0, 0]
        out[k] = v
    return out


def vae_state_dict_from_torch(sd: dict[str, torch.Tensor],
                              keys: Iterable[str]) -> dict[str, torch.Tensor]:
    """The state dict over `keys` (the VAE's own state-dict keys)."""
    sd = normalize_vae_keys(sd)
    out = {}
    for key in keys:
        if key not in sd:
            raise KeyError(f"missing VAE weight: {key}")
        out[key] = sd[key]
    return out
