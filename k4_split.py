"""Split K4's time on an H100 into its parts, and time its persistent blocks
against non-persistent ones.

Builds variants of `controlanimate_tpu_torch/csrc/upconv3x3.cu`, each by an
exact edit of the source (the script fails if the source no longer holds
the text it edits), one `nvcc` a variant, all started together:

  all               the source as it is
  staging           the patch and weight copies alone (no products, no stores)
  staging_products  no output stores
  staging_stores    no products (the output is leaky ReLU of the bias)
  walk8             blocks of 8 consecutive tiles in place of persistent
                    blocks (the weights restaged every 8 tiles)

and times each, by CUDA events, at the three shapes the x4 upscaler
launches K4 with at batch 8 (bf16, 64 -> 64, the weights folded once, as
the upscaler passes them); beside them the shipped kernel through its
wrapper with the weights folded in each call. `all` and `walk8` must give
the wrapper's output bit for bit. The output of the other variants is not
the function and is not read. The products and the stores are skipped
behind a condition the compiler cannot decide (`lrelu == 7`, never true at
run time): left out at compile time, ptxas would also drop the products
whose results no store reads. Each variant's tensor-core (HMMA)
instructions are counted from its SASS, and the script fails if a variant
that runs the products has none.

    python3 k4_split.py [--iters N]

Prints the HMMA counts, one JSON line a shape, then the card's name and power limit as
`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives them.
Builds into `build/k4_split/` (ignored by git).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke
from controlanimate_tpu_torch import _build
from controlanimate_tpu_torch.ops import upconv_kernel as uk

SOURCE = _build.CSRC_DIR / "upconv3x3.cu"
OUT_DIR = _build.BUILD_DIR.parent / "k4_split"
# (B, H, W, Ci, Co, upsample): up1, up2 and conv_hr of a 512-px frame's x4 tail
SHAPES = [(8, 512, 512, 64, 64, True), (8, 1024, 1024, 64, 64, True),
          (8, 2048, 2048, 64, 64, False)]
_NO_PRODUCTS = ("    mma_step<kUp, BN>(acc, slot,",
                "    if (p.lrelu == 7) mma_step<kUp, BN>(acc, slot,")
_NO_STORES = ("    if (c != nck - 1) continue;",
              "    if (c != nck - 1 || p.lrelu != 7) continue;")
_WALK8 = [
    ("  t0 = blockIdx.x;\n  stride = gridDim.x;\n  return (ntiles - t0 + stride - 1) / stride;",
     "  t0 = blockIdx.x * 8;\n  stride = 1;\n  return min(8, ntiles - t0);"),
    ("  if (blocks > ntiles) blocks = ntiles;", "  blocks = (ntiles + 7) / 8;"),
]
VARIANTS = {
    "all": [],
    "staging": [_NO_PRODUCTS, _NO_STORES],
    "staging_products": [_NO_STORES],
    "staging_stores": [_NO_PRODUCTS],
    "walk8": _WALK8,
}


def variant_source(edits) -> str:
    src = SOURCE.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{SOURCE.name} holds {src.count(old)} copies of {old!r}, not 1")
        src = src.replace(old, new)
    return src


def build_variants() -> dict[str, ctypes.CDLL]:
    """One shared library a variant, compiled in parallel; print the HMMA
    instructions of each variant's bf16 kernels."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build._nvcc(), {}
    for name, edits in VARIANTS.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(variant_source(edits))
        procs[name] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                                        str(cu)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.upconv3x3_fwd.argtypes = [p, ll, ll, ll, p, p, p] + [i] * 8 + [p]
        lib.upconv3x3_fwd.restype = i
        libs[name] = lib
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    hmma = {name: sum(n for kernel, n in chip_smoke.sass_counts(
        OUT_DIR / f"{name}.so", cuobjdump, ("HMMA",))["HMMA"].items() if "upconv_bf16" in kernel)
        for name in VARIANTS}
    print(json.dumps({"hmma": hmma}), flush=True)
    if not all(hmma[name] for name in VARIANTS if name not in ("staging", "staging_stores")):
        raise AssertionError(f"a variant that runs the products has no HMMA: {hmma}")
    return libs


def cuda_ms(fn, iters: int) -> float:
    """Mean ms a call by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_split.py needs a CUDA card", file=sys.stderr)
        return 1
    libs = build_variants()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for B, H, W, Ci, Co, upsample in SHAPES:
        x = torch.randn((B, H, W, Ci), generator=gen, device="cuda").bfloat16()
        w = torch.randn((3, 3, Ci, Co), generator=gen, device="cuda") / (9 * Ci) ** 0.5
        bias = 0.1 * torch.randn((Co,), generator=gen, device="cuda")
        packed = uk.kernel_weights(w, x.dtype, upsample)
        want = uk.upconv3x3(x, w, bias, upsample=upsample, act="lrelu", packed=packed)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            err = lib.upconv3x3_fwd(x.data_ptr(), *x.stride()[:3], packed.data_ptr(),
                                    bias.data_ptr(), out.data_ptr(), B, H, W, Ci, Co,
                                    int(upsample), 1, 1, stream)
            if err != 0:
                raise RuntimeError(f"upconv3x3_fwd failed ({err})")

        row = {"shape": [B, H, W, Ci, Co], "upsample": upsample}
        for name, lib in libs.items():
            if name in ("all", "walk8"):
                out.zero_()
                launch(lib)
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"variant {name} differs from the wrapper's output")
            row[f"{name}_ms"] = cuda_ms(lambda: launch(lib), args.iters)
        row["unpacked_ms"] = cuda_ms(
            lambda: uk.upconv3x3(x, w, bias, upsample=upsample, act="lrelu"), args.iters)
        print(json.dumps(row), flush=True)
        del x, w, bias, packed, want, out
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
