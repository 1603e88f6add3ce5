"""The port's checkpoint reader (`controlanimate_tpu_torch/weights/ingest.py`)
against the `safetensors` library and the JAX package's loader on the same
files: values equal, dtypes kept; the one-file-set rule of
`load_hf_component`, against the JAX loader's merge; missing files raise."""

import json

import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import load_file as load_torch
from safetensors.torch import save_file as save_torch

from controlanimate_tpu.weights import ingest as jingest
from controlanimate_tpu_torch.weights import ingest


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, 2, generator=g).half(),
        "bf16": torch.randn(7, generator=g).bfloat16(),
        "i64": torch.randint(-2**40, 2**40, (2, 3), generator=g),
        "f64": torch.randn(2, generator=g).double(),
        "i32": torch.randint(-9, 9, (4,), generator=g, dtype=torch.int32),
        "i16": torch.randint(-9, 9, (4,), generator=g, dtype=torch.int16),
        "i8": torch.randint(-9, 9, (1, 4), generator=g, dtype=torch.int8),
        "u8": torch.randint(0, 255, (4,), generator=g, dtype=torch.uint8),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_reader_matches_the_library(tmp_path):
    sd = _tensors()
    path = tmp_path / "all.safetensors"
    save_torch(sd, str(path), metadata={"format": "pt"})
    mine, theirs = ingest.load_state_dict(path), load_torch(str(path))
    assert set(mine) == set(theirs) == set(sd)
    for k, v in theirs.items():
        assert mine[k].dtype == v.dtype and mine[k].shape == v.shape, k
        assert torch.equal(mine[k], v), k


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16", "int64"])
def test_safetensors_reader_matches_jax_loader(tmp_path, dtype):
    """The JAX loader reads the same file into numpy (bf16 as float32)."""
    g = torch.Generator().manual_seed(1)
    sd = {"a.weight": torch.randn(6, 3, generator=g) * 100,
          "b.bias": torch.randn(5, generator=g)}
    sd = {k: v.to(getattr(torch, dtype)) for k, v in sd.items()}
    path = tmp_path / "w.safetensors"
    save_torch(sd, str(path))
    mine, theirs = ingest.load_state_dict(path), jingest.load_state_dict(path)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert mine[k].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(mine[k].float().numpy() if dtype == "bfloat16"
                                      else mine[k].numpy(), v)


def test_sharded_index_is_read_whole(tmp_path):
    sd = _tensors(2)
    names = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": names[:5],
              "model-00002-of-00002.safetensors": names[5:]}
    comp = tmp_path / "text_encoder"
    comp.mkdir()
    for fname, keys in shards.items():
        save_torch({k: sd[k] for k in keys}, str(comp / fname))
    (comp / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: f for f, ks in shards.items() for k in ks}}))
    (comp / "config.json").write_text("{}")
    cfg, mine = ingest.load_hf_component(tmp_path, "text_encoder")
    assert cfg == {} and set(mine) == set(sd)
    for k, v in sd.items():
        assert torch.equal(mine[k], v), k
    _, theirs = jingest.load_hf_component(tmp_path, "text_encoder")
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].float().numpy() if mine[k].dtype == torch.bfloat16
                                      else mine[k].numpy(), v)


def test_torch_pickles_unnest_and_flatten_as_jax(tmp_path):
    """`{"state_dict": {...}}` nesting unwrapped and nested dicts flattened to
    dotted keys (an LDM checkpoint, a TI pickle), as in the JAX loader."""
    g = torch.Generator().manual_seed(3)
    obj = {"state_dict": {"first_stage_model.encoder.conv_in.weight": torch.randn(4, 3, 3, 3,
                                                                                 generator=g),
                          "nested": {"a": torch.randn(2, generator=g).half(),
                                     "b": {"c": torch.arange(3)}}},
           "global_step": 7}
    path = tmp_path / "x.ckpt"
    torch.save(obj, path)
    mine, theirs = ingest.load_state_dict(path), jingest.load_state_dict(path)
    assert set(mine) == set(theirs) == {"first_stage_model.encoder.conv_in.weight", "nested.a",
                                        "nested.b.c"}
    for k, v in theirs.items():
        np.testing.assert_array_equal(mine[k].numpy(), v)
    assert mine["nested.a"].dtype == torch.float16 and mine["nested.b.c"].dtype == torch.int64


def _component(tmp_path, files: dict) -> str:
    comp = tmp_path / "unet"
    comp.mkdir()
    (comp / "config.json").write_text(json.dumps({"in_channels": 4}))
    for name, value in files.items():
        sd = {"w": np.full((2, 2), value, np.float32)}
        if name.endswith(".safetensors"):
            save_numpy(sd, str(comp / name))
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, comp / name)
    return "unet"


def test_safetensors_wins_over_bin_where_jax_merges(tmp_path):
    """One file set: `diffusion_pytorch_model.safetensors` over the `.bin`
    of the same name. The JAX loader merges every file of the directory, a
    `.bin` after the `.safetensors`, so there the `.bin`'s value wins."""
    comp = _component(tmp_path, {"diffusion_pytorch_model.safetensors": 1.0,
                                 "diffusion_pytorch_model.bin": 2.0})
    cfg, mine = ingest.load_hf_component(tmp_path, comp)
    assert cfg == {"in_channels": 4}
    assert float(mine["w"][0, 0]) == 1.0
    _, theirs = jingest.load_hf_component(tmp_path, comp)
    assert float(theirs["w"][0, 0]) == 2.0


@pytest.mark.parametrize("files,want", [
    ({"diffusion_pytorch_model.safetensors": 1.0,
      "diffusion_pytorch_model.fp16.safetensors": 2.0,
      "diffusion_pytorch_model.non_ema.safetensors": 3.0}, 1.0),
    ({"diffusion_pytorch_model.bin": 4.0, "diffusion_pytorch_model.fp16.bin": 5.0}, 4.0),
    ({"diffusion_pytorch_model.fp16.safetensors": 6.0}, 6.0),
    ({"pytorch_model.bin": 7.0, "pytorch_model.fp16.bin": 8.0}, 7.0),  # transformers' names
])
def test_named_file_then_single_remaining_file(tmp_path, files, want):
    comp = _component(tmp_path, files)
    _, sd = ingest.load_hf_component(tmp_path, comp)
    assert float(sd["w"][0, 0]) == want


def test_variants_are_never_merged(tmp_path):
    comp = _component(tmp_path, {"diffusion_pytorch_model.fp16.safetensors": 1.0,
                                 "diffusion_pytorch_model.non_ema.safetensors": 2.0})
    with pytest.raises(ValueError, match="fp16.*non_ema|non_ema.*fp16"):
        ingest.load_hf_component(tmp_path, comp)


def test_missing_component_parts_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        ingest.load_hf_component(tmp_path, "vae")
    (tmp_path / "vae").mkdir()
    with pytest.raises(FileNotFoundError, match="config.json"):
        ingest.load_hf_component(tmp_path, "vae")
    (tmp_path / "vae" / "config.json").write_text("{}")
    with pytest.raises(FileNotFoundError, match="no weight files"):
        ingest.load_hf_component(tmp_path, "vae")
    with pytest.raises(FileNotFoundError):
        ingest.load_state_dict(tmp_path / "absent.safetensors")


def test_truncated_safetensors_raises(tmp_path):
    path = tmp_path / "t.safetensors"
    save_torch({"w": torch.ones(64)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-8])
    with pytest.raises(ValueError, match="truncated"):
        ingest.load_safetensors(path)
