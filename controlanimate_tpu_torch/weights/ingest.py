"""Checkpoint ingestion: the weight files of the model zoo, read into flat
state dicts of torch tensors on the CPU, in the file's dtype.

Counterpart of `controlanimate_tpu/weights/ingest.py`:
  * `.safetensors` is read from the format itself (an 8-byte little-endian
    header length, a JSON header of `dtype`, `shape` and `data_offsets`,
    then the raw bytes), so the port needs no `safetensors` package;
  * `.bin` / `.ckpt` / `.pt` go through `torch.load(weights_only=True)`, with
    LDM `{"state_dict": ...}` nesting unwrapped and nested dicts flattened
    to dotted keys (only tensor leaves are kept);
  * `load_hf_component` reads one component of an HF-layout snapshot:
    `config.json` and ONE weight file set, chosen in this order: a sharded
    `*.safetensors.index.json`; `diffusion_pytorch_model.safetensors` /
    `model.safetensors` (diffusers / transformers); the same names as
    `.bin`, and transformers' `pytorch_model.bin`; a single remaining
    weights file. More than one candidate at the deciding step raises
    ValueError naming them; a missing directory, `config.json` or weight
    file raises FileNotFoundError;
  * `build_module` makes a module on the meta device and gives it such a
    state dict on the target device in the run dtype.

JAX behaviour not copied: the JAX `load_hf_component` loads every
`*.safetensors`, then every `*.bin`, then every `*.ckpt` of the directory and
merges them key by key, so a `.bin` overrides a `.safetensors` and in a
snapshot that also ships `*.fp16.*` / `*.non_ema.*` variants the last file in
sort order wins.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

# safetensors dtype -> numpy dtype of the stored words (BF16 read as 16-bit
# words and viewed as torch.bfloat16)
_SAFETENSORS_DTYPES = {
    "F64": np.dtype("<f8"), "F32": np.dtype("<f4"), "F16": np.dtype("<f2"),
    "BF16": np.dtype("<u2"), "I64": np.dtype("<i8"), "I32": np.dtype("<i4"),
    "I16": np.dtype("<i2"), "I8": np.dtype("i1"), "U8": np.dtype("u1"), "BOOL": np.dtype("?"),
}
WEIGHT_SUFFIXES = (".safetensors", ".bin", ".ckpt", ".pt", ".pth")
# the weight file names of diffusers and transformers components
WEIGHT_STEMS = ("diffusion_pytorch_model", "model", "pytorch_model")


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        base = 8 + n
        for key, info in header.items():
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: tensor {key} has unsupported dtype {info['dtype']}")
            start, end = info["data_offsets"]
            shape = tuple(info["shape"])
            count = int(np.prod(shape, dtype=np.int64))
            if end - start != count * dtype.itemsize:
                raise ValueError(f"{path}: tensor {key} spans {end - start} bytes, "
                                 f"its shape {shape} needs {count * dtype.itemsize}")
            f.seek(base + start)
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{path}: tensor {key} is truncated")
            t = torch.from_numpy(arr.reshape(shape))
            out[key] = t.view(torch.bfloat16) if info["dtype"] == "BF16" else t
    return out


def save_safetensors(path: str | Path, sd: dict[str, torch.Tensor]) -> int:
    """Write `sd` in the safetensors format (an 8-byte little-endian header
    length, the JSON header padded to 8 bytes, then each tensor's bytes),
    which `load_safetensors` reads; returns the bytes written."""
    names = {torch.from_numpy(np.zeros(0, d)).dtype: n for n, d in _SAFETENSORS_DTYPES.items()
             if n != "BF16"}
    names[torch.bfloat16] = "BF16"
    header, offset = {}, 0
    for key, t in sd.items():
        n = t.numel() * t.element_size()
        header[key] = {"dtype": names[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in sd.values():
            f.write(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy())
    return 8 + len(blob) + offset


def load_torch_pickle(path: str | Path) -> dict[str, torch.Tensor]:
    """torch.load a .ckpt/.bin/.pt state dict on the CPU: LDM-style
    {'state_dict': ...} nesting unwrapped, nested dicts flattened to dotted
    keys, tensor leaves kept."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("state_dict"), dict):
        obj = obj["state_dict"]
    flat: dict[str, torch.Tensor] = {}

    def walk(prefix: str, d: Any):
        if isinstance(d, dict):
            for k, v in d.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(d, torch.Tensor):
            flat[prefix] = d

    walk("", obj)
    return flat


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """Load any single-file checkpoint by extension."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"weights file {path} not found")
    if path.suffix == ".safetensors":
        return load_safetensors(path)
    return load_torch_pickle(path)


def component_weight_files(d: Path) -> list[Path]:
    """The one file set `load_hf_component` reads from directory `d`."""
    indexes = sorted(d.glob("*.safetensors.index.json"))
    if len(indexes) > 1:
        raise ValueError(f"{d}: more than one sharded index: {[p.name for p in indexes]}")
    if indexes:
        weight_map = json.loads(indexes[0].read_text())["weight_map"]
        return [d / name for name in sorted(set(weight_map.values()))]
    for suffix in (".safetensors", ".bin"):
        named = [d / f"{stem}{suffix}" for stem in WEIGHT_STEMS
                 if (d / f"{stem}{suffix}").is_file()]
        if len(named) > 1:
            raise ValueError(f"{d}: more than one weights file: {[p.name for p in named]}")
        if named:
            return named
    rest = sorted(p for p in d.iterdir() if p.is_file() and p.suffix in WEIGHT_SUFFIXES)
    if not rest:
        raise FileNotFoundError(f"no weight files under {d}")
    if len(rest) > 1:
        raise ValueError(f"{d}: cannot choose among weights files {[p.name for p in rest]}")
    return rest


def load_hf_component(snapshot: str | Path, component: str) -> tuple[dict, dict[str, torch.Tensor]]:
    """(config.json, state dict) of one component of an HF-layout snapshot
    directory (`component` "" reads the directory itself)."""
    d = Path(snapshot) / component
    if not d.is_dir():
        raise FileNotFoundError(f"snapshot component directory {d} not found")
    cfg_path = d / "config.json"
    if not cfg_path.is_file():
        raise FileNotFoundError(f"{cfg_path} not found")
    state: dict[str, torch.Tensor] = {}
    for path in component_weight_files(d):
        state.update(load_state_dict(path))
    return json.loads(cfg_path.read_text()), state


def build_module(make: Callable[[], nn.Module], state: dict[str, torch.Tensor], device,
                 dtype: torch.dtype, convert: Callable) -> nn.Module:
    """`make()` on the meta device, given `convert(state, its keys)` cast to
    `dtype` on `device` (integer tensors keep theirs); its non-persistent
    buffers (made on the host at construction) then move to `device`. No
    copy of the module is made in another dtype on the device."""
    with torch.device("meta"):
        module = make()
    sd = convert(state, module.state_dict().keys())
    sd = {k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
          for k, v in sd.items()}
    module.load_state_dict(sd, strict=True, assign=True)
    return module.to(device)
