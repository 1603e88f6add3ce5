"""Build the port's CUDA kernels with one nvcc call and load them with ctypes.

Every `csrc/*.cu` source (K1 `flash_attention.cu`, K2 `conv3x3_fused.cu`,
K3 `motion_module.cu`, K4 `upconv3x3.cu`) exports plain C functions and
includes no PyTorch header, so one `nvcc -shared` call builds them all in
seconds. The library lands in `build/torch_kernels/` at the root of the
checkout (listed in `.gitignore`), named by a hash of the sources and flags,
so an unchanged tree reuses it and a changed one rebuilds. A failed build
raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (the -Xptxas -v resource report)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p] + [i] * 17 + [ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.conv3x3_fused_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.conv3x3_fused_fwd.restype = i
    lib.conv3x3_fused_error_string.argtypes = [i]
    lib.conv3x3_fused_error_string.restype = ctypes.c_char_p
    lib.motion_module_fwd.argtypes = [ctypes.POINTER(p)] + [i] * 6 + [p]
    lib.motion_module_fwd.restype = i
    lib.motion_module_error_string.argtypes = [i]
    lib.motion_module_error_string.restype = ctypes.c_char_p
    ll = ctypes.c_longlong
    lib.upconv3x3_fwd.argtypes = [p, ll, ll, ll, p, p, p] + [i] * 8 + [p]
    lib.upconv3x3_fwd.restype = i
    lib.upconv3x3_error_string.argtypes = [i]
    lib.upconv3x3_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernels' shared library."""
    sources = _sources()
    out = BUILD_DIR / f"libcontrolanimate_kernels_{_digest(sources)}.so"
    log_path = out.with_suffix(".log")
    seconds = 0.0
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    log = log_path.read_text() if log_path.is_file() else ""
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
