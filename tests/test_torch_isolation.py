"""The port stands alone: no file of controlanimate_tpu_torch/, nor
chip_smoke.py or k4_split.py, imports jax, flax, the JAX package, cv2 (the
card's machine has no OpenCV) or safetensors (the port reads the format
itself), nor yaml at module level; and the package imports in a process
where none of them can be imported."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "controlanimate_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                   ROOT / "k4_split.py"]
FORBIDDEN = {"jax", "jaxlib", "flax", "controlanimate_tpu", "cv2", "safetensors"}


def _imports(tree):
    """(module name, at module level) for every import in a parsed file."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module, id(node) in top


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, top_level in _imports(tree):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"
        assert not (root == "yaml" and top_level), f"{path.name} imports yaml at module level"


def test_package_imports_without_jax():
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'yaml', 'controlanimate_tpu', 'cv2',\n"
        "             'safetensors'):\n"
        "    sys.modules[name] = None  # any import of these now raises\n"
        "import importlib, pkgutil, controlanimate_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_the_controlnet_slice_is_checked():
    """The ControlNet slice's modules are among the files checked above."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"controlanimate_tpu_torch/{m}" for m in (
        "models/controlnet.py", "ops/canny.py", "models/annotators/__init__.py",
        "models/annotators/edge_nets.py", "weights/controlnet_weights.py")} <= names


def test_the_ip_adapter_slice_is_checked():
    """The IP-Adapter slice's modules are among the files checked above."""
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {f"controlanimate_tpu_torch/{m}" for m in (
        "pipelines/ip_adapter.py", "models/clip.py", "weights/clip_weights.py",
        "models/layers.py")} <= names
