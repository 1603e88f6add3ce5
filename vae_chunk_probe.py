#!/usr/bin/env python3
"""The VAE's encode and decode of a window's frames at 512x512, in one pass
and in chunks, on one CUDA card: each pass's time and peak memory, or the
error it raised.

    python3 vae_chunk_probe.py

The SD VAE (128, 256, 512, 512 channels) with seeded bf16 weights, run as
the engine runs it (`AnimationEngine.encode_frames`, `decode_latents`), on
B*F = 16, 32 and 64 frames (one, two and four 16-frame segments); the
decode in one pass and 16 frames a pass (the facade's `decode_chunk` from
32 frames), the encode in one pass and 16 frames a pass. First,
`F.interpolate` nearest 2x on a channels-last (64, 256, 256, 256) bf16
tensor, the decoder's third up block at 64 frames (2^32 output elements).
Prints one JSON line a pass: frames, chunk, seconds (CUDA events, after one
warm-up pass at the same size), `max_memory_allocated` above what was
allocated before, or the error; a line holding the one-pass results against
the chunked ones (the interpolation against the same on 16-frame slices:
equal or not; the decodes' uint8 frames: the largest difference); then the
card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("vae_chunk_probe: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import init_weights_
    from controlanimate_tpu_torch.models.vae import AutoencoderKL
    from controlanimate_tpu_torch.pipelines.engine import AnimationEngine, EngineModels

    def report(**fields):
        print(json.dumps(fields), flush=True)

    def attempt(name, fn, **fields):
        """fn() twice (a warm-up, then timed); its time and peak memory."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            fn()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            report(**{"pass": name}, **fields, seconds=start.elapsed_time(end) / 1e3,
                   max_memory_allocated=torch.cuda.max_memory_allocated() - base)
        except Exception as e:  # the one-pass forms may be refused
            report(**{"pass": name}, **fields, error=f"{type(e).__name__}: {str(e)[:300]}")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    x = torch.randn((64, 256, 256, 256), device="cuda", generator=gen).to(torch.bfloat16)

    def up(t):
        return F.interpolate(t.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")

    attempt("interpolate_nearest_2x_channels_last", lambda: up(x), shape=list(x.shape))
    with torch.no_grad():
        whole = up(x)
        interpolate_equal = all(torch.equal(whole[i:i + 16], up(x[i:i + 16]))
                                for i in range(0, 64, 16))
    del x, whole

    with torch.device("cuda"):
        vae = AutoencoderKL(block_out_channels=(128, 256, 512, 512))
    init_weights_(torch, vae, gen)
    vae = vae.to(torch.bfloat16).eval()
    engine = AnimationEngine(EngineModels(unet=None, vae=vae), schedule=None)
    for n in (16, 32, 64):
        frames = torch.randint(0, 256, (1, n, 512, 512, 3), dtype=torch.uint8, device="cuda",
                               generator=gen)
        noise = torch.randn((n, 64, 64, 4), device="cuda", generator=gen)
        latents = torch.randn((1, n, 64, 64, 4), device="cuda", generator=gen)
        with torch.no_grad():
            for chunk in (0, 16):
                if chunk and chunk >= n:
                    continue
                attempt("decode", lambda: engine.decode_latents(latents, True, chunk),
                        frames=n, chunk=chunk)

                def encode(chunk=chunk):
                    step = chunk or n
                    return torch.cat([engine.encode_frames(frames[:, i:i + step],
                                                           noise[i:i + step])
                                      for i in range(0, n, step)], dim=1)

                attempt("encode", encode, frames=n, chunk=chunk)
            if n == 64:
                one, chunked = (engine.decode_latents(latents, True, c) for c in (0, 16))
                decode_diff = int((one.int() - chunked.int()).abs().max())
                del one, chunked
        del frames, noise, latents
    report(check="one_pass_against_chunked", interpolate_64_equal=interpolate_equal,
           decode_64_uint8_max_diff=decode_diff)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
