"""Seeded stand-ins for the lineart, lineart_anime, PidiNet, MLSD, OpenPose,
NormalBae and depth (DPT, DPT-hybrid, GLPN) checkpoints.

The repo ships no annotator weights. These make a `LineartGenerator`, a
lineart_anime `UnetGenerator`, a `table5_pidinet.pth` state dict, an
`mlsd_large_512_fp32.pth` state dict (controlnet_aux's key layout,
BatchNorm statistics included), the three OpenPose files, a `scannet.pt`
and the transformers state dicts and `config.json`s of Intel/dpt-large,
Intel/dpt-hybrid-midas and vinvino02/glpn-nyu (or a smaller geometry;
`write_depth_folder` puts one on disk) from a `torch.Generator`, on its
device, with maps that are
neither constant nor saturated; and `pose_maps`, crafted stride-8 OpenPose
maps of two people, which no seeded network gives. `chip_smoke.py` and the
parity tests drive the annotators with them.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from . import depth as dp
from . import mlsd
from . import normalbae as nb
from ...weights import ingest
from .dpt import DPT_LARGE, DPTConfig, DPTDepth, REASSEMBLE_FACTORS
from .dpt_hybrid import (DPT_HYBRID_MIDAS, DPTHybridConfig, DPTHybridDepth, WSConv,
                         standardize_weights_)
from .edge_nets import LineartGenerator
from .glpn import GLPN_B4, GLPNConfig, GLPNDepth
from .lineart_anime import UnetGenerator
from .openpose import LIMB_SEQ, MAP_IDX, BodyPoseNet
from .openpose_face import FaceNet
from .openpose_hand_face import HandPoseNet
from .pidinet import PiDiNet, PidiNetAnnotator, pdc_weights, pidinet_state_dict_from_torch
from ...ops.warp import fp32_convs


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


def seed_lineart_anime_(net: UnetGenerator, gen: torch.Generator) -> UnetGenerator:
    """lineart_anime weights whose maps stay off 0 and 1, in place on the
    network's device: convs N(0, 1/fan_in), a transposed conv's fan-in its
    input channels times 4 (the taps that reach an output pixel at stride
    2); biases N(0, 0.05^2). The InstanceNorms keep each level at unit
    scale, so the tanh sees unit-scale logits: on 256x256 synthetic frames
    the maps' mean is near 0.4 and their std near 0.2."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight.shape[0] * 4), generator=gen)
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.weight[0].numel()), generator=gen)
            else:
                continue
            m.bias.normal_(0.0, 0.05, generator=gen)
    return net.eval()


def pidinet_checkpoint(gen: torch.Generator, frames: torch.Tensor) -> dict:
    """A seeded `table5_pidinet.pth` in the released layout ({"state_dict":
    ...}, every key under `module.`, the PDC kernels unfolded 3x3) on the
    generator's device: convs N(0, 1/fan_in) and biases N(0, 0.05^2), so
    that the residual stages grow slowly (std about 0.7, 1, 2 and 4 on
    synthetic frames); then the classifier set on the (F, H, W, 3) uint8
    `frames` so that its logits there have mean 0 and std 1.5 (a random
    classifier's logits sit far off 0 for some seeds, and the maps
    saturate)."""
    with torch.device("meta"):
        shapes = PiDiNet().state_dict()
    # the unfolded PDC kernels are 3x3 (the folded `rd` is 5x5)
    shapes.update({k: torch.empty(*shapes[k].shape[:2], 3, 3, device="meta")
                   for k, _ in pdc_weights()})
    sd = {}
    for name, p in shapes.items():
        sd[name] = torch.randn(p.shape, generator=gen, device=gen.device) * (
            1.0 / math.sqrt(p[0].numel()) if p.ndim == 4 else 0.05)
    sd["classifier.bias"].zero_()
    ckpt = {"state_dict": {f"module.{k}": v for k, v in sd.items()}}
    # the classifier's input on `frames`, then the classifier scaled and
    # shifted onto it
    model = pidinet_model(ckpt, gen.device)
    seen = {}
    model.classifier.register_forward_hook(lambda m, i, o: seen.setdefault("z", o))
    PidiNetAnnotator(model)(frames.to(gen.device))
    gain = 1.5 / seen["z"].std()
    sd["classifier.weight"].mul_(gain)
    sd["classifier.bias"].copy_(-seen["z"].mean() * gain)
    return ckpt


def pidinet_model(ckpt: dict, device) -> PiDiNet:
    """The `PiDiNet` of a `pidinet_checkpoint` on `device`, its kernels
    folded on the host as `PidiNetAnnotator.from_file` folds them."""
    folded = pidinet_state_dict_from_torch({k: v.cpu() for k, v in ckpt["state_dict"].items()})
    with torch.device("meta"):
        model = PiDiNet()
    model.load_state_dict({k: v.to(device) for k, v in folded.items()}, assign=True)
    return model.eval()


# the refinement heads' targets on the calibration frames: each output
# channel's std, and the means of x, y, z and kappa
HEAD_STD, HEAD_MEAN = 1.0, (0.0, 0.0, 1.5, 0.0)
VAR_FLOOR = 0.25
RESIDUAL_GAIN = 0.2


@torch.no_grad()
def normalbae_checkpoint(gen: torch.Generator, frames: torch.Tensor,
                         cfg: nb.NNETConfig = nb.B5) -> dict:
    """A seeded `scannet.pt` in the released nesting ({"model": ...}, every
    key under `module.`, BatchNorms unfolded, no `num_batches_tracked`) on
    the generator's device: convs N(0, 1/fan_in), conv biases N(0, 0.05^2),
    BatchNorm gains 1 + N(0, 0.1^2) (times RESIDUAL_GAIN on a block's last
    BatchNorm where it adds its input, so that a stage's output stays near
    unit scale through the 39 blocks, and a frame's activations do not
    grow from block to block) and shifts N(0, 0.1^2). The BatchNorm
    statistics are those of one pass over the (F, H, W, 3) uint8 `frames`
    (each variance at least VAR_FLOOR of its layer's mean), as training
    leaves them, so that every layer sees unit-scale inputs there; and in
    that pass `out_conv_res8` and each refinement head's last conv are
    scaled and shifted so that their outputs have per-channel std HEAD_STD
    and means HEAD_MEAN: the maps are neither constant nor set by the
    biases, and xyz stays off a zero norm, where `norm_normalize` would
    amplify rounding. Pass frames of the size and kind the network will
    see: a random depthwise kernel answers texture, and at the last stages'
    1/32 scale the 5x5 kernels reach past small maps, so frames of another
    kind or size move every block's output off unit scale the same way, and
    over the 39 blocks that compounds (at RESIDUAL_GAIN 0.5 a calibration
    on smooth 64x96 frames left 256x384 ones at 1e5 by stage 5)."""
    dev = gen.device
    with torch.device("meta"):
        model = nb.NNET(cfg)
    norms = {n for n, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    last = set()  # the last BatchNorm of each block that adds its input
    for n, m in model.named_modules():
        if isinstance(m, nb.DepthwiseSeparable) and m.skip:
            last.add(f"{n}.bn2")
        elif isinstance(m, nb.InvertedResidual) and m.skip:
            last.add(f"{n}.bn3")
    sd = {}
    for key, p in model.state_dict().items():
        owner, _, leaf = key.rpartition(".")
        if owner not in norms:
            std = 1.0 / math.sqrt(p[0].numel()) if p.ndim > 1 else 0.05
            sd[key] = torch.randn(p.shape, generator=gen, device=dev) * std
        elif leaf == "weight":
            sd[key] = (1.0 + 0.1 * torch.randn(p.shape, generator=gen, device=dev)) * (
                RESIDUAL_GAIN if owner in last else 1.0)
        elif leaf == "bias":
            sd[key] = 0.1 * torch.randn(p.shape, generator=gen, device=dev)
        else:  # the statistics, set by the pass below
            sd[key] = torch.zeros(p.shape, dtype=p.dtype, device=dev)
    model.load_state_dict(sd, assign=True)
    model.eval()

    def set_statistics(bn, inputs):
        # the batch's statistics, each variance at least VAR_FLOOR of the
        # layer's mean (a channel nearly constant on the batch would get a
        # large gain)
        x = inputs[0]
        var = x.var((0, 2, 3))
        bn.running_mean.copy_(x.mean((0, 2, 3)))
        bn.running_var.copy_(torch.maximum(var, VAR_FLOOR * var.mean()))

    hooks = [m.register_forward_pre_hook(set_statistics) for m in model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    target_mean = torch.tensor(HEAD_MEAN, device=dev)

    def calibrate(conv, inputs, out):
        dims = (0, 2, 3) if out.ndim == 4 else (0, 2)
        gain = HEAD_STD / out.std(dims)
        shift = target_mean - out.mean(dims) * gain
        conv.weight.mul_(gain.reshape(-1, *(1,) * (conv.weight.ndim - 1)))
        conv.bias.mul_(gain).add_(shift)
        lead = (-1, *(1,) * (out.ndim - 2))
        return out * gain.reshape(lead) + shift.reshape(lead)

    dec = model.decoder
    hooks += [m.register_forward_hook(calibrate) for m in (
        dec.out_conv_res8, dec.out_conv_res4[6], dec.out_conv_res2[6], dec.out_conv_res1[6])]
    with fp32_convs():
        model(nb.normalize_frames(frames.to(dev)))
    for h in hooks:
        h.remove()
    return {"model": {f"module.{k}": v.detach().clone() for k, v in model.state_dict().items()
                      if not k.endswith("num_batches_tracked")}}


def normalbae_model(ckpt: dict, device, cfg: nb.NNETConfig = nb.B5) -> nb.NNET:
    """The folded `NNET` of a `normalbae_checkpoint` on `device`, folded on
    the host as `NormalBaeAnnotator.from_file` folds it."""
    sd = nb.scannet_state_dict({f"model.{k}": v.cpu() for k, v in ckpt["model"].items()})
    return nb.nnet_from_state_dict(sd, cfg).to(device)


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


# -- OpenPose -------------------------------------------------------------------
def _seeded_cpm(net: torch.nn.Module, gen: torch.Generator, heads: dict) -> dict:
    """A state dict of `net`'s shapes on the generator's device: convs
    N(0, 2 / fan_in) and zero biases, then each head conv named in `heads`
    (name -> (std of its output's spread, (C,) bias)) scaled down and
    biased."""
    sd = {}
    for name, p in net.state_dict().items():
        if name.endswith(".weight"):
            sd[name] = torch.randn(p.shape, generator=gen, device=gen.device) * math.sqrt(
                2.0 / p[0].numel())
        else:
            sd[name] = torch.zeros(p.shape, device=gen.device)
    for name, (spread, bias) in heads.items():
        sd[f"{name}.weight"] *= spread
        sd[f"{name}.bias"] = bias.to(gen.device)
    return sd


def openpose_checkpoints(gen: torch.Generator) -> dict:
    """Seeded `body_pose_model.pth`, `hand_pose_model.pth` and `facenet.pth`
    state dicts (file name -> state dict) on the generator's device. The
    body's heat head is biased to -0.5 (a seeded trunk finds no person, and
    noise maps would give thousands of peaks); the hand's and face's last
    heads are biased to +0.3 on two parts of every three and -0.3 on the
    third, so that most parts of each crop pass 0.1 and are drawn, hand
    lines between consecutive parts included."""
    with torch.device("meta"):  # the shapes alone
        body, hand, face = BodyPoseNet(), HandPoseNet(), FaceNet()

    def alternate(n):
        return torch.tensor([0.3 if i % 3 != 2 else -0.3 for i in range(n)])

    return {
        "body_pose_model.pth": _seeded_cpm(body, gen, {
            "model6_1.Mconv7_stage6_L1": (0.05, torch.zeros(38)),
            "model6_2.Mconv7_stage6_L2": (0.05, torch.full((19,), -0.5))}),
        "hand_pose_model.pth": _seeded_cpm(hand, gen, {
            "model6.Mconv7_stage6": (0.05, alternate(22))}),
        "facenet.pth": _seeded_cpm(face, gen, {"Mconv7_stage6": (0.05, alternate(71))}),
    }


# coco-18 keypoints of a standing person, as (x, y) shares of its height
# from the top of its head
POSE = ((0.0, 0.12), (0.0, 0.22), (-0.1, 0.22), (-0.17, 0.36), (-0.2, 0.5), (0.1, 0.22),
        (0.17, 0.36), (0.2, 0.5), (-0.06, 0.52), (-0.07, 0.72), (-0.08, 0.92), (0.06, 0.52),
        (0.07, 0.72), (0.08, 0.92), (-0.03, 0.1), (0.03, 0.1), (-0.06, 0.11), (0.06, 0.11))


def pose_maps(H: int, W: int, h8: int, w8: int,
              people: int = 2) -> tuple[np.ndarray, np.ndarray]:
    """Crafted stride-8 (heat (h8, w8, 19), PAF (h8, w8, 38)) float32 maps of
    one person in the middle of an (H, W) frame or two side by side, each
    0.8 H tall (`POSE`): each part a Gaussian blob of
    peak 1 and sigma 1 stride-8 pixel at its keypoint, channel 18 one minus
    their maximum; each limb's PAF channels its unit vector within 1.5
    stride-8 pixels of the segment. Every limb, both wrists and all the face
    points are present, so the decode finds each person, its hands and its
    face."""
    yy, xx = np.mgrid[0:h8, 0:w8].astype(np.float64)
    scale = np.array([w8 / W, h8 / H])
    heat = np.zeros((h8, w8, 19))
    paf = np.zeros((h8, w8, 38))
    pose = np.array(POSE, np.float64) * (0.8 * H)
    for cx in ((0.5,) if people == 1 else (0.3, 0.7)):
        person = pose + (cx * W, 0.08 * H)
        p = (person + 0.5) * scale - 0.5  # full-res pixel -> stride-8 pixel
        for part in range(18):
            blob = np.exp(-((xx - p[part, 0]) ** 2 + (yy - p[part, 1]) ** 2) / 2.0)
            heat[..., part] = np.maximum(heat[..., part], blob)
        for (a, b), (ca, cb) in zip(LIMB_SEQ, MAP_IDX):
            pa, pb = p[a - 1], p[b - 1]
            d = pb - pa
            length = np.hypot(*d)
            u = d / length
            t = ((xx - pa[0]) * u[0] + (yy - pa[1]) * u[1])
            off = np.abs((xx - pa[0]) * u[1] - (yy - pa[1]) * u[0])
            on = (t >= -1) & (t <= length + 1) & (off <= 1.5)
            paf[..., ca - 19][on] = u[0]
            paf[..., cb - 19][on] = u[1]
    heat[..., 18] = 1.0 - heat[..., :18].max(-1)
    return heat.astype(np.float32), paf.astype(np.float32)


def dpt_config(cfg: DPTConfig = DPT_LARGE, size: int = dp.NET_SIZE) -> dict:
    """A plain DPT's transformers `config.json` (the Intel/dpt-large layout)
    for `size` x `size` inputs."""
    return {"model_type": "dpt", "is_hybrid": False, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.heads,
            "intermediate_size": cfg.mlp_dim, "patch_size": cfg.patch, "image_size": size,
            "backbone_out_indices": list(cfg.taps), "neck_hidden_sizes": list(cfg.neck_hidden),
            "fusion_hidden_size": cfg.fusion_hidden,
            "reassemble_factors": list(REASSEMBLE_FACTORS), **dp.JAX_CONSTANTS}


def dpt_hybrid_config(cfg: DPTHybridConfig = DPT_HYBRID_MIDAS, size: int = dp.NET_SIZE) -> dict:
    """DPT-hybrid's transformers `config.json` (the Intel/dpt-hybrid-midas
    layout, BiT backbone config included) for `size` x `size` inputs; its
    stored position grid is size / patch a side."""
    b = cfg.bit
    return {"model_type": "dpt", "is_hybrid": True, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.heads,
            "intermediate_size": cfg.mlp_dim, "patch_size": cfg.patch, "image_size": size,
            "backbone_out_indices": list(cfg.taps), "neck_hidden_sizes": list(cfg.neck_hidden),
            "reassemble_factors": list(cfg.reassemble_factors),
            "fusion_hidden_size": cfg.fusion_hidden, "neck_ignore_stages": [0, 1],
            "backbone_featmap_shape": [1, b.hidden_sizes[-1], size // 16, size // 16],
            "backbone_config": {"model_type": "bit", "layer_type": "bottleneck",
                                "global_padding": "SAME", "embedding_dynamic_padding": True,
                                "embedding_size": b.embedding_size,
                                "hidden_sizes": list(b.hidden_sizes), "depths": list(b.depths),
                                "num_groups": b.num_groups,
                                "out_features": ["stage1", "stage2", "stage3"]},
            **dp.JAX_CONSTANTS}


# the depth head's outputs on the calibration frames, each channel's (mean,
# std): conv1 at unit scale, conv2 mostly positive before its ReLU, the
# depth mostly positive before the last ReLU
DEPTH_HEAD_TARGETS = ((0.0, 1.0), (0.5, 1.0), (1.0, 0.5))


@torch.no_grad()
def _calibrate_head_(model: torch.nn.Module, sd: dict, layers: tuple, targets: tuple,
                     x: torch.Tensor) -> None:
    """Scale and shift each conv `model.head.head[j]` of `layers` so that on
    the input `x` each of its output channels has the (mean, std) of
    `targets` (the later convs see the earlier ones calibrated), and put
    the convs' new weights into the state dict `sd`."""
    head = model.head.head

    def calibrate(conv, out, target):
        mean, std = target
        gain = std / out.std((0, 2, 3))
        shift = mean - out.mean((0, 2, 3)) * gain
        conv.weight.mul_(gain.reshape(-1, 1, 1, 1))
        conv.bias.mul_(gain).add_(shift)
        return out * gain.reshape(1, -1, 1, 1) + shift.reshape(1, -1, 1, 1)

    hooks = [head[j].register_forward_hook(lambda c, i, o, t=t: calibrate(c, o, t))
             for j, t in zip(layers, targets)]
    with fp32_convs():
        model(x)
    for h in hooks:
        h.remove()
    for j in layers:
        sd[f"head.head.{j}.weight"] = head[j].weight.detach().clone()
        sd[f"head.head.{j}.bias"] = head[j].bias.detach().clone()


@torch.no_grad()
def _seeded_depth(model: torch.nn.Module, cfg: dict, gen: torch.Generator,
                  frames: torch.Tensor, size: int) -> dict:
    """The transformers state dict of `model` (built on the meta device):
    Linear and conv weights N(0, 1/fan_in) (a transposed conv's fan-in its
    input channels: each output pixel takes one tap), the ViT layers'
    attention and MLP output weights times 1/sqrt(2 L), so that the
    residual stream stays near unit scale through the L layers; biases N(0,
    0.05^2), norms' gains 1 and shifts 0, the class token N(0, 0.5^2), the
    position table N(0, 0.2^2); the BiT convs N(0, 1) (they are
    standardised). Then the head is calibrated on the (F, H, W, 3) uint8
    `frames` at `size` x `size` (`DEPTH_HEAD_TARGETS`), so that the maps are
    neither constant nor set by the biases. The unused residual_layer1 of
    the deepest fusion layer, which upstream files hold, is drawn too."""
    dev = gen.device
    branch = 1.0 / math.sqrt(2 * cfg["num_hidden_layers"])
    sd = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}"
            if isinstance(m, (torch.nn.LayerNorm, torch.nn.GroupNorm)):
                sd[key] = torch.full(p.shape, float(pname == "weight"), device=dev)
                continue
            if pname == "bias":
                std = 0.05
            elif pname in ("cls_token", "position_embeddings"):
                std = 0.5 if pname == "cls_token" else 0.2
            elif isinstance(m, WSConv):
                std = 1.0
            else:
                fan_in = p.shape[0] if isinstance(m, torch.nn.ConvTranspose2d) else p[0].numel()
                std = 1.0 / math.sqrt(fan_in)
                if key.startswith("dpt.encoder.") and key.endswith("output.dense.weight"):
                    std *= branch
            sd[key] = torch.randn(p.shape, generator=gen, device=dev) * std
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    model = standardize_weights_(model.eval())
    _calibrate_head_(model, sd, (0, 2, 4), DEPTH_HEAD_TARGETS,
                     dp.network_input(frames.to(dev), size))
    c = cfg["fusion_hidden_size"]
    unused = "neck.fusion_stage.layers.0.residual_layer1.convolution"
    for n in (1, 2):
        sd[f"{unused}{n}.weight"] = torch.randn((c, c, 3, 3), generator=gen,
                                                device=dev) / math.sqrt(9 * c)
        sd[f"{unused}{n}.bias"] = torch.randn((c,), generator=gen, device=dev) * 0.05
    return sd


def dpt_checkpoint(gen: torch.Generator, frames: torch.Tensor, cfg: DPTConfig = DPT_LARGE,
                   size: int = dp.NET_SIZE) -> tuple[dict, dict]:
    """A seeded plain DPT (`dpt_config`, transformers keys, its position
    table for `size` x `size`, its head calibrated on `frames` at that
    size) on the generator's device: (config.json, state dict)."""
    config = dpt_config(cfg, size)
    with torch.device("meta"):
        model = DPTDepth(cfg, (size // cfg.patch) ** 2 + 1)
    return config, _seeded_depth(model, config, gen, frames, size)


def dpt_hybrid_checkpoint(gen: torch.Generator, frames: torch.Tensor,
                          cfg: DPTHybridConfig = DPT_HYBRID_MIDAS,
                          size: int = dp.NET_SIZE) -> tuple[dict, dict]:
    """A seeded DPT-hybrid (`dpt_hybrid_config`; the BiT convs as a file
    holds them, unstandardised; its position table of (size / patch)^2 + 1
    rows, so another patch than 16 stores another grid than the /16 map's)
    on the generator's device: (config.json, state dict)."""
    config = dpt_hybrid_config(cfg, size)
    with torch.device("meta"):
        model = DPTHybridDepth(cfg, (size // cfg.patch) ** 2 + 1)
    return config, _seeded_depth(model, config, gen, frames, size)


def glpn_config(cfg: GLPNConfig = GLPN_B4) -> dict:
    """GLPN's transformers `config.json` (vinvino02/glpn-nyu's layout at
    the b4 widths), with the keys JAX never reads at the values it
    assumes."""
    return {"model_type": "glpn", "hidden_sizes": list(cfg.hidden_sizes),
            "depths": list(cfg.depths), "sr_ratios": list(cfg.sr_ratios),
            "num_attention_heads": list(cfg.heads), "patch_sizes": list(cfg.patch_sizes),
            "strides": list(cfg.strides), "mlp_ratios": list(cfg.mlp_ratios),
            "decoder_hidden_size": cfg.decoder_hidden, "max_depth": cfg.max_depth,
            "layer_norm_eps": cfg.ln_eps, "num_encoder_blocks": len(cfg.hidden_sizes),
            **dp.GLPN_CONSTANTS}


# GLPN's head on the calibration frames, each conv's output (mean, std):
# the first at unit scale before its ReLU, the second (before the sigmoid)
# at unit scale about 0, off the sigmoid's flat ends
GLPN_HEAD_TARGETS = ((0.0, 1.0), (0.0, 1.0))


@torch.no_grad()
def glpn_checkpoint(gen: torch.Generator, frames: torch.Tensor,
                    cfg: GLPNConfig = GLPN_B4) -> tuple[dict, dict]:
    """A seeded GLPN (`glpn_config`, transformers keys, BatchNorms unfolded
    with their `num_batches_tracked`) on the generator's device: (config.json,
    state dict). Linear and conv weights N(0, 1/fan_in) (a depthwise conv's
    fan-in its 9 taps), each layer's attention output and second MixFFN
    dense times 1/sqrt(2 depth) of its stage, so that the residual stream
    stays near unit scale; biases N(0, 0.05^2), LayerNorm gains 1 and shifts
    0; BatchNorm gains 1 + N(0, 0.1^2), shifts N(0, 0.1^2), means N(0,
    0.05^2) and variances U(0.75, 1.25) (JAX's transformers test seeds them
    so). Then the head is calibrated on the (F, H, W, 3) uint8 `frames` at
    the annotator's input (`GLPN_HEAD_TARGETS`), so that the maps are
    neither constant nor saturated."""
    dev = gen.device
    with torch.device("meta"):
        model = GLPNDepth(cfg)
    sd = {}
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}"
            if isinstance(m, torch.nn.LayerNorm):
                sd[key] = torch.full(p.shape, float(pname == "weight"), device=dev)
            elif isinstance(m, torch.nn.BatchNorm2d):
                base = float(pname == "weight")
                sd[key] = base + 0.1 * torch.randn(p.shape, generator=gen, device=dev)
            elif pname == "bias":
                sd[key] = 0.05 * torch.randn(p.shape, generator=gen, device=dev)
            else:
                std = 1.0 / math.sqrt(p[0].numel())
                if key.endswith(("attention.output.dense.weight", "mlp.dense2.weight")):
                    std /= math.sqrt(2 * cfg.depths[int(key.split(".")[3])])
                sd[key] = torch.randn(p.shape, generator=gen, device=dev) * std
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            sd[f"{mname}.running_mean"] = 0.05 * torch.randn(c, generator=gen, device=dev)
            sd[f"{mname}.running_var"] = 0.75 + 0.5 * torch.rand(c, generator=gen, device=dev)
            sd[f"{mname}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64, device=dev)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, assign=True)
    _calibrate_head_(model.eval(), sd, (0, 2), GLPN_HEAD_TARGETS,
                     dp.glpn_input(frames.to(dev)))
    return glpn_config(cfg), sd


def write_depth_folder(path, config: dict, sd: dict) -> int:
    """A transformers folder as the depth annotator reads it: `config.json`
    and `model.safetensors`; returns the weights' bytes."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(config))
    return ingest.save_safetensors(path / "model.safetensors", sd)
