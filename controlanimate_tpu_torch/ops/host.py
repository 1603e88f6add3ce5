"""Host arrays to the device without waiting for it.

`tensor.to("cuda")` from pageable host memory synchronises the stream: the
host waits for every kernel queued before the copy. The OpenPose annotator
uploads tables and shapes mid-window, on the loop's prefetch worker, so
`upload` packs the arrays into one pinned float64 buffer (every value the
callers upload, int64 indices below 2^53 and float32 weights, is exact
there) and copies it with `non_blocking=True`, which queues the copy behind
the stream's work and returns; each array comes back in its own dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(arrays: list, device) -> list:
    """The numpy `arrays` on `device`, in their dtypes, by one copy that the
    host does not wait for (on the CPU: the arrays as tensors)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.from_numpy(np.array(a)) for a in arrays]
    flat = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays]
                          + [np.zeros(0)])
    buf = torch.from_numpy(flat).pin_memory().to(device, non_blocking=True)
    out, at = [], 0
    for a in arrays:
        a = np.asarray(a)
        out.append(buf[at:at + a.size].view(a.shape).to(torch.from_numpy(a[:0]).dtype))
        at += a.size
    return out
