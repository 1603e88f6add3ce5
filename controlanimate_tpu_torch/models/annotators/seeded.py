"""Seeded stand-ins for the lineart and MLSD checkpoints.

The repo ships no annotator weights. These make a `LineartGenerator` and an
`mlsd_large_512_fp32.pth` state dict (controlnet_aux's key layout,
BatchNorm statistics included) from a `torch.Generator`, on its device,
with maps that are neither constant nor saturated: `chip_smoke.py` and the
parity tests drive the annotators with them.
"""

from __future__ import annotations

import math

import torch

from . import mlsd
from .edge_nets import LineartGenerator


def seed_lineart_(net: LineartGenerator, gen: torch.Generator) -> LineartGenerator:
    """Lineart weights whose maps stay off 0 and 1, in place on the
    network's device: convs N(0, 1/fan_in) (the InstanceNorms keep the
    activations at unit scale; a transposed conv's fan-in is its input
    channels times 9), biases N(0, 0.05^2)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.ndim == 4:
                fan_in = p[:, 0].numel() if name.startswith("model3") else p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)
            else:
                p.normal_(0.0, 0.05, generator=gen)
    return net.eval()


def mlsd_model(sd: dict, device) -> mlsd.MLSDLarge:
    """The `MLSDLarge` of a controlnet_aux-layout state dict on `device`, its
    BatchNorms folded on the host as `MLSDAnnotator.from_file` folds them."""
    folded = mlsd.mlsd_state_dict_from_torch({k: v.cpu() for k, v in sd.items()})
    with torch.device("meta"):
        model = mlsd.MLSDLarge()
    model.load_state_dict({k: v.to(device) for k, v in folded.items()}, assign=True)
    return model.eval()


def mlsd_checkpoint(gen: torch.Generator, frames: torch.Tensor) -> dict:
    """A seeded `mlsd_large_512_fp32.pth` on the generator's device: convs
    N(0, 2/fan_in), BatchNorms near identity, and the head (`block22.conv3`)
    set on the (F, H, W, 3) uint8 `frames` so that the centre logits there
    have mean 0 and std 1.6 and each displacement mean 0 and std 11 px (the
    other channels 0.1): a few hundred segments a frame, most longer than
    the decode's 10 px."""
    dev = gen.device
    sd = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def conv_bn(conv, bn, cout, cin, k, groups=1):
        sd[f"{conv}.weight"] = randn(cout, cin // groups, k, k) * math.sqrt(
            2.0 / (cin // groups * k * k))
        sd[f"{bn}.weight"] = 1.0 + 0.1 * randn(cout)
        sd[f"{bn}.bias"] = 0.1 * randn(cout)
        sd[f"{bn}.running_mean"] = 0.1 * randn(cout)
        sd[f"{bn}.running_var"] = 1.0 + 0.1 * torch.rand(cout, generator=gen, device=dev)
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0, device=dev)

    fx = "backbone.features"
    conv_bn(f"{fx}.0.0", f"{fx}.0.1", 32, 4, 3)
    c = 32
    for i, (e, out, _) in enumerate(mlsd.IR_SPEC, start=1):
        p = f"{fx}.{i}.conv"
        if e == 1:
            conv_bn(f"{p}.0.0", f"{p}.0.1", c, c, 3, groups=c)
            conv_bn(f"{p}.1", f"{p}.2", out, c, 1)
        else:
            conv_bn(f"{p}.0.0", f"{p}.0.1", c * e, c, 1)
            conv_bn(f"{p}.1.0", f"{p}.1.1", c * e, c * e, 3, groups=c * e)
            conv_bn(f"{p}.2", f"{p}.3", out, c * e, 1)
        c = out
    for b, (ca, cb) in {15: (64, 96), 17: (32, 64), 19: (24, 64), 21: (16, 64)}.items():
        conv_bn(f"block{b}.conv1.0", f"block{b}.conv1.1", 64, cb, 1)
        conv_bn(f"block{b}.conv2.0", f"block{b}.conv2.1", 64, ca, 1)
    for b in (16, 18, 20, 22):
        conv_bn(f"block{b}.conv1.0", f"block{b}.conv1.1", 128, 128, 3)
        conv_bn(f"block{b}.conv2.0", f"block{b}.conv2.1", 64 if b < 22 else 128, 128, 3)
    sd["block22.conv3.weight"] = randn(16, 128, 1, 1)
    sd["block22.conv3.bias"] = torch.zeros(16, device=dev)
    # the head's input on `frames`, then the head scaled and shifted onto it
    model = mlsd_model(sd, dev)
    seen = {}
    model.block22.conv3.register_forward_hook(lambda m, i, o: seen.setdefault("x", i[0]))
    mlsd.MLSDAnnotator(model).tp_map(frames.to(dev))
    out = torch.einsum("oc,nchw->onhw", sd["block22.conv3.weight"][:, :, 0, 0], seen["x"])
    gain = torch.tensor([1.6] + [11.0] * 4 + [0.1] * 11, device=dev) / out.std((1, 2, 3))
    sd["block22.conv3.weight"] *= gain[:, None, None, None]
    sd["block22.conv3.bias"] = -out.mean((1, 2, 3)) * gain
    return sd
