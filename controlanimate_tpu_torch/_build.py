"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every `csrc/*.cu` source (K1 `flash_attention.cu`, K2 `conv3x3_fused.cu`,
K3 `motion_module.cu`, K4 `upconv3x3.cu`) exports plain C functions and
includes no PyTorch header. One `nvcc -c` a source, all started together,
compiles them in parallel, and one `nvcc -shared` links the objects. The
library lands in `build/torch_kernels/` at the root of the
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's output (the -Xptxas -v resource report), source by source


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
    lib.flash_attention_bf16_smem_bytes.argtypes = [i]
    lib.flash_attention_bf16_smem_bytes.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.conv3x3_fused_fwd.argtypes = [p] * 7 + [i] * 7 + [p]
    lib.conv3x3_fused_fwd.restype = i
    lib.conv3x3_fused_error_string.argtypes = [i]
    lib.conv3x3_fused_error_string.restype = ctypes.c_char_p
    lib.motion_module_fwd.argtypes = [ctypes.POINTER(p)] + [i] * 6 + [p]
    lib.motion_module_fwd.restype = i
    lib.motion_module_fwd_timed.argtypes = ([ctypes.POINTER(p)] + [i] * 6
                                            + [p, ctypes.POINTER(ctypes.c_float), i, i])
    lib.motion_module_fwd_timed.restype = i
    lib.motion_attention_plan.argtypes = [i] * 5 + [ctypes.POINTER(i)]
    lib.motion_attention_plan.restype = i
    lib.motion_module_error_string.argtypes = [i]
    lib.motion_module_error_string.restype = ctypes.c_char_p
    ll = ctypes.c_longlong
    lib.upconv3x3_fwd.argtypes = [p, ll, ll, ll, p, p, p] + [i] * 8 + [p]
    lib.upconv3x3_fwd.restype = i
    lib.upconv3x3_bf16_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
    lib.upconv3x3_bf16_plan.restype = i
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
        objs = [out.with_name(f"{src.stem}.{os.getpid()}.o") for src in sources]
        nvcc = _nvcc()
        t0 = time.perf_counter()
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        steps = [(cmd, proc.communicate()[0], proc.returncode)
                 for cmd, proc in zip(compiles, procs)]
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        if all(rc == 0 for _, _, rc in steps):
            proc = subprocess.run(link, capture_output=True, text=True)
            steps.append((link, proc.stdout + proc.stderr, proc.returncode))
        seconds = time.perf_counter() - t0
        log = "".join(text for _, text, _ in steps)
        for obj in objs:
            obj.unlink(missing_ok=True)
        failed = [(cmd, text, rc) for cmd, text, rc in steps if rc != 0]
        if failed:
            tmp.unlink(missing_ok=True)
            cmd, text, rc = failed[0]
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
        log_path.write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    lib = ctypes.CDLL(str(out))
    _declare(lib)
    log = log_path.read_text() if log_path.is_file() else ""
    return KernelLibrary(lib=lib, path=out, build_seconds=seconds, log=log)
