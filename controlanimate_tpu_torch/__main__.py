"""The port's command line, the counterpart of `main.py`:

    python -m controlanimate_tpu_torch --config <yaml> [--max-windows N] [--device cuda|cpu]

builds the models from the model zoo the profile names and runs the vid2vid
loop (`vid2vid.vid2vid`) on `--device` (default `cuda`; `--device`
replaces the JAX CLI's `--platform`), then prints the summary. `main(argv)`
runs it in-process and returns the summary.

Ctrl-C as in `main.py`: the first SIGINT asks for a stop at the next window
boundary (pending emits flush, a resumable checkpoint is saved; rerun with
`resume: 1` to continue); a second one raises KeyboardInterrupt. The
previous SIGINT handler is restored when `main` returns.
"""

from __future__ import annotations

import argparse
import os
import signal
from typing import Optional, Sequence

from .vid2vid import vid2vid


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(prog="python -m controlanimate_tpu_torch",
                                     description="ControlAnimate vid2vid on PyTorch + CUDA")
    parser.add_argument("--config", type=str, required=True, help="path to a run yaml")
    parser.add_argument("--max-windows", type=int, default=None,
                        help="stop after N windows (debugging)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on: cuda (default) or cpu")
    args = parser.parse_args(argv)

    stop = {"requested": False}
    prev_handler = signal.getsignal(signal.SIGINT)

    def on_sigint(signum, frame):
        if stop["requested"]:
            signal.signal(signal.SIGINT, prev_handler)
            raise KeyboardInterrupt
        stop["requested"] = True
        # os.write, not print: a buffered write re-entered from the handler
        # raises RuntimeError
        os.write(2, b"\nstopping at the next window boundary (checkpoint will be "
                    b"saved; Ctrl-C again to abort immediately)\n")

    signal.signal(signal.SIGINT, on_sigint)
    try:
        summary = vid2vid(args.config, max_windows=args.max_windows,
                          should_stop=lambda: stop["requested"], device=args.device)
    finally:
        signal.signal(signal.SIGINT, prev_handler)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
