"""LoRA fusing into diffusers-layout state dicts (before loading).

A copy of `controlanimate_tpu/weights/lora.py` on torch state dicts. Key
formats:
  * Kohya/civitai: lora_unet_<path>_<to_q>.lora_up.weight / .lora_down.weight
    + .alpha scalars (underscored module paths)
  * peft/diffusers: unet.<path>.lora_A.weight / lora_B.weight
  * old diffusers attn-processor: <path>.processor.to_q_lora.up.weight
    (also the AnimateDiff motion-LoRA layout)

W += scale * (alpha / rank) * up @ down is computed in numpy float32 as the
JAX package computes it, so the fused weights are the same bits; a fused
weight comes back as a float32 tensor, every other one as it was.
"""

from __future__ import annotations

import re
from collections import defaultdict

import numpy as np
import torch


def _np32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(t, np.float32)


def _kohya_to_module_path(name: str, known_keys: set[str]) -> str | None:
    """lora_unet_down_blocks_0_attentions_1_..._to_q -> dotted module path,
    resolved against the state dict's keys (module names contain
    underscores)."""
    body = name.split(".", 1)[0]
    for prefix in ("lora_unet_", "lora_te_", "lora_te1_"):
        if body.startswith(prefix):
            body = body[len(prefix):]
            break
    candidates = {k.rsplit(".", 1)[0].replace(".", "_"): k.rsplit(".", 1)[0] for k in known_keys}
    return candidates.get(body)


def extract_lora_deltas(
    lora_sd: dict[str, torch.Tensor], target_sd_keys: set[str]
) -> dict[str, tuple[np.ndarray, np.ndarray, float]]:
    """Parse a LoRA state dict into {target_weight_key: (up, down, alpha/rank)}."""
    groups: dict[str, dict] = defaultdict(dict)
    alphas: dict[str, float] = {}

    for k, v in lora_sd.items():
        if k.endswith(".alpha"):
            alphas[k[: -len(".alpha")]] = float(_np32(v))
            continue
        m = re.match(r"(.*)\.lora_(up|down)\.weight$", k)
        if m:
            groups[m.group(1)]["up" if m.group(2) == "up" else "down"] = v
            continue
        m = re.match(r"(.*)\.lora_(A|B)\.weight$", k)
        if m:
            groups[m.group(1)]["down" if m.group(2) == "A" else "up"] = v
            continue
        m = re.match(r"(.*)\.processor\.(\w+)_lora\.(up|down)\.weight$", k)
        if m:
            base, attn_name = m.group(1), m.group(2)
            proj = attn_name.replace("to_out", "to_out.0")
            groups[f"{base}.{proj}"][m.group(3)] = v
            continue

    module_keys = {k[: -len(".weight")] for k in target_sd_keys if k.endswith(".weight")}
    out: dict[str, tuple[np.ndarray, np.ndarray, float]] = {}
    for name, uv in groups.items():
        if "up" not in uv or "down" not in uv:
            continue
        up, down = _np32(uv["up"]), _np32(uv["down"])
        rank = down.shape[0]
        alpha = alphas.get(name, float(rank))
        target = None
        if name in module_keys:
            target = name
        else:
            resolved = _kohya_to_module_path(name, target_sd_keys)
            if resolved is not None and resolved in module_keys:
                target = resolved
        if target is None:
            continue
        out[target + ".weight"] = (up, down, alpha / rank)
    return out


def fuse_lora(
    sd: dict[str, torch.Tensor],
    lora_sd: dict[str, torch.Tensor],
    scale: float = 1.0,
) -> tuple[dict[str, torch.Tensor], int]:
    """W += scale * (alpha/rank) * up @ down, on a copy of `sd`.

    Returns (fused_sd, num_fused_layers)."""
    deltas = extract_lora_deltas(lora_sd, set(sd.keys()))
    out = dict(sd)
    for key, (up, down, a) in deltas.items():
        w = _np32(out[key])
        if w.ndim == 4:  # conv: (O, I, kh, kw); lora usually rank-decomposed 1x1
            u = up.reshape(up.shape[0], -1)
            d = down.reshape(down.shape[0], -1)
            delta = (u @ d).reshape(w.shape)
        else:
            delta = up @ down
        out[key] = torch.from_numpy((w + scale * a * delta).astype(np.float32))
    return out, len(deltas)


def split_lora_by_component(
    lora_sd: dict[str, torch.Tensor],
) -> dict[str, dict[str, torch.Tensor]]:
    """Partition a combined LoRA file into unet / text-encoder parts by key
    prefix (diffusers 'unet.' / 'text_encoder.'; kohya 'lora_unet_' /
    'lora_te_'); a file with neither is a bare UNet LoRA."""
    unet, te, other = {}, {}, {}
    for k, v in lora_sd.items():
        if k.startswith("unet."):
            unet[k[len("unet."):]] = v
        elif k.startswith("text_encoder."):
            te[k[len("text_encoder."):]] = v
        elif k.startswith("lora_unet_"):
            unet[k] = v
        elif k.startswith(("lora_te_", "lora_te1_")):
            te[k] = v
        else:
            other[k] = v
    if other and not unet:
        unet = other
    return {"unet": unet, "text_encoder": te}
