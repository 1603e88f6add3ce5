"""Textual-inversion embeddings.

A copy of `controlanimate_tpu/weights/textual_inversion.py` on torch:
safetensors ({'emb_params': (K, D)}) and torch-pickle
({'string_to_param': {'*': (K, D)}}) files, else the first 2D tensor. JAX
behaviour not copied: a listed file that does not exist raises
FileNotFoundError (the JAX loader skips it).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

import torch

from .ingest import load_state_dict


def load_textual_inversion(path: str | Path) -> torch.Tensor:
    """The (K, D) float32 embedding matrix of a TI file."""
    sd = load_state_dict(path)
    if "emb_params" in sd:
        emb = sd["emb_params"]
    elif "string_to_param.*" in sd:
        emb = sd["string_to_param.*"]
    else:
        cands = [v for v in sd.values() if v.ndim == 2]
        if not cands:
            raise ValueError(f"unrecognized textual-inversion format: {list(sd)[:5]}")
        emb = cands[0]
    emb = emb.to(torch.float32)
    if emb.ndim == 1:
        emb = emb[None]
    return emb


def register_textual_inversions(tokenizer, paths: Iterable[str]) -> Optional[torch.Tensor]:
    """Load TI files, register their placeholder tokens (the file stem,
    lowercased) on the tokenizer, and return the stacked extra-embedding
    rows in registration order (row i is token id `vocab_size + i`), or None
    when `paths` is empty."""
    mats = []
    for p in map(Path, paths):
        if not p.is_file():
            raise FileNotFoundError(f"textual-inversion file {p} not found")
        emb = load_textual_inversion(p)
        tokenizer.add_multi_vector_token(p.stem.lower(), emb.shape[0])
        mats.append(emb)
    return torch.cat(mats, dim=0) if mats else None
