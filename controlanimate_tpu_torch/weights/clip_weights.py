"""The CLIP text model's and vision tower's state dicts from HF CLIP state
dicts.

Counterpart of `controlanimate_tpu/weights/clip_weights.py`
`text_params_from_torch` and `vision_params_from_torch`: keys are read with
the `text_model.` (`vision_model.`) prefix, or without it when no key of the
file has it (`visual_projection.weight` has none in either layout), and
textual-inversion rows (`extra_embeddings`, (K, hidden)) are appended to the
token embedding table in its dtype. Every key the model has must be present
(KeyError otherwise); keys it lacks (`position_ids`) are not read.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

PREFIX = "text_model."
VISION_PREFIX = "vision_model."
TOKEN_EMBEDDING = "text_model.embeddings.token_embedding.weight"


def text_state_dict_from_torch(
    sd: dict[str, torch.Tensor],
    keys: Iterable[str],
    extra_embeddings: Optional[torch.Tensor] = None,
) -> dict[str, torch.Tensor]:
    """The state dict over `keys` (the text model's own state-dict keys,
    all under `text_model.`)."""
    pre = PREFIX if any(k.startswith(PREFIX) for k in sd) else ""
    out = {}
    for key in keys:
        src = pre + key[len(PREFIX):]
        if src not in sd:
            raise KeyError(f"missing text-encoder weight: {src}")
        out[key] = sd[src]
    tok = out[TOKEN_EMBEDDING]
    if extra_embeddings is not None and len(extra_embeddings):
        out[TOKEN_EMBEDDING] = torch.cat([tok, extra_embeddings.to(tok.dtype)], dim=0)
    return out


def vision_state_dict_from_torch(sd: dict[str, torch.Tensor],
                                 keys: Iterable[str]) -> dict[str, torch.Tensor]:
    """The state dict over `keys` (the vision tower's own state-dict keys)."""
    pre = VISION_PREFIX if any(k.startswith(VISION_PREFIX) for k in sd) else ""
    out = {}
    for key in keys:
        src = pre + key[len(VISION_PREFIX):] if key.startswith(VISION_PREFIX) else key
        if src not in sd:
            raise KeyError(f"missing image-encoder weight: {src}")
        out[key] = sd[src]
    return out
