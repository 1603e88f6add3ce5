"""Carry weights across from the JAX package's Flax parameter trees.

Each function takes a Flax parameter tree (nested dicts of numpy arrays, as
`jax.device_get(params)` gives) and returns the port's `state_dict` for the
UNet, the VAE, the CLIP text model or the RealESRGAN RRDBNet. The port's
modules use the diffusers / HF / basicsr checkpoint key names, so the tables
below are the inverse of the JAX package's checkpoint loaders
(`controlanimate_tpu/weights/unet_weights.py`, `vae_weights.py`,
`clip_weights.py`, `models/upscaler.py` `rrdbnet_params_from_torch`,
`models/gfpgan.py` `gfpgan_params_from_torch`, `models/retinaface.py`
`retinaface_params_from_torch`, `weights/controlnet_weights.py`
`controlnet_params_from_torch`, `models/annotators/edge_nets.py`
`hed_params_from_torch` and `lineart_params_from_torch`,
`models/annotators/pidinet.py` `pidinet_params_from_torch` (the unfolded
PDC kernels, as `table5_pidinet.pth` holds them),
`models/annotators/lineart_anime.py` `anime_params_from_torch`,
`models/annotators/mlsd_net.py` `mlsd_params_from_torch`, whose folded
convs the port's `MLSDLarge` holds under the same names,
`models/annotators/normalbae_net.py` `nnet_params_from_torch` (the
BatchNorms unfolded, as `scannet.pt` holds them), and the OpenPose
`body_params_from_torch`, `hand_params_from_torch` and
`face_params_from_torch`, `clip_weights.py` `vision_params_from_torch`,
the IP-Adapter projections of `pipelines/ip_adapter.py` `build_projection`,
and `models/annotators/dpt.py` `dpt_params_from_torch` and
`dpt_hybrid.py` `dpt_hybrid_params_from_torch` (the hybrid's weight-
standardised convs unstandardised, as the file holds them), and
`models/annotators/glpn.py` `glpn_params_from_torch` (the decoder's
BatchNorms unfolded, as the file holds them)), copied here so
the port never imports that package. Kinds: "conv" HWIO -> OIHW, "deconv"
a transposed conv's (kh, kw, O, I) -> (I, O, kh, kw), "dense" (in, out) ->
(out, in), "raw" as is, "nchw" (1, H, W, C) -> (1, C, H, W), "lead1" with a
leading axis of 1 (a modulated conv's weight), "chan" (C,) -> (1, C, 1, 1),
"vec1" () -> (1,), "conv1d" a 1x1 conv's (1, 1, I, O) -> a Conv1d's (O, I,
1).
"""

from __future__ import annotations

import math
from typing import Iterator

import numpy as np
import torch

from ..models.annotators.dpt import REASSEMBLE_FACTORS
from ..models.annotators.dpt_hybrid import DPTHybridConfig
from ..models.annotators.edge_nets import LINEART_RES_BLOCKS
from ..models.annotators.glpn import GLPNConfig
from ..models.annotators.mlsd import IR_SPEC
from ..models.annotators.normalbae import B5, NNETConfig
from ..models.annotators.openpose import BodyPoseNet
from ..models.annotators.openpose_face import FaceNet
from ..models.annotators.openpose_hand_face import HandPoseNet
from ..models.annotators.pidinet import DILATIONS, STAGES
from ..models.clip import CLIPTextConfig, CLIPVisionConfig
from ..models.retinaface import RESNET50_STAGES, SSH_BRANCHES
from ..models.unet3d import UNet3DConfig

Entry = tuple[str, str, str]  # (torch key, flax path, kind)


def _resnet(t: str, f: str, shortcut: bool) -> Iterator[Entry]:
    yield f"{t}.norm1.weight", f"{f}/norm1/norm/scale", "raw"
    yield f"{t}.norm1.bias", f"{f}/norm1/norm/bias", "raw"
    yield f"{t}.conv1.weight", f"{f}/conv1/conv/kernel", "conv"
    yield f"{t}.conv1.bias", f"{f}/conv1/conv/bias", "raw"
    yield f"{t}.time_emb_proj.weight", f"{f}/time_emb_proj/kernel", "dense"
    yield f"{t}.time_emb_proj.bias", f"{f}/time_emb_proj/bias", "raw"
    yield f"{t}.norm2.weight", f"{f}/norm2/norm/scale", "raw"
    yield f"{t}.norm2.bias", f"{f}/norm2/norm/bias", "raw"
    yield f"{t}.conv2.weight", f"{f}/conv2/conv/kernel", "conv"
    yield f"{t}.conv2.bias", f"{f}/conv2/conv/bias", "raw"
    if shortcut:
        yield f"{t}.conv_shortcut.weight", f"{f}/conv_shortcut/conv/kernel", "conv"
        yield f"{t}.conv_shortcut.bias", f"{f}/conv_shortcut/conv/bias", "raw"


def _attn(t: str, f: str) -> Iterator[Entry]:
    yield f"{t}.to_q.weight", f"{f}/to_q/kernel", "dense"
    yield f"{t}.to_k.weight", f"{f}/to_k/kernel", "dense"
    yield f"{t}.to_v.weight", f"{f}/to_v/kernel", "dense"
    yield f"{t}.to_out.0.weight", f"{f}/to_out_0/kernel", "dense"
    yield f"{t}.to_out.0.bias", f"{f}/to_out_0/bias", "raw"


def _norm(t: str, f: str) -> Iterator[Entry]:
    yield f"{t}.weight", f"{f}/scale", "raw"
    yield f"{t}.bias", f"{f}/bias", "raw"


def _dense(t: str, f: str, bias: bool = True) -> Iterator[Entry]:
    yield f"{t}.weight", f"{f}/kernel", "dense"
    if bias:
        yield f"{t}.bias", f"{f}/bias", "raw"


def _conv(t: str, f: str) -> Iterator[Entry]:
    yield f"{t}.weight", f"{f}/kernel", "conv"
    yield f"{t}.bias", f"{f}/bias", "raw"


def _ff(t: str, f: str) -> Iterator[Entry]:
    yield from _dense(f"{t}.net.0.proj", f"{f}/net_0/proj")
    yield from _dense(f"{t}.net.2", f"{f}/net_2")


def _spatial(t: str, f: str, ip: bool = False, temporal: bool = False) -> Iterator[Entry]:
    yield from _norm(f"{t}.norm", f"{f}/norm")
    yield from _conv(f"{t}.proj_in", f"{f}/proj_in")
    tb, fb = f"{t}.transformer_blocks.0", f"{f}/transformer_blocks_0"
    yield from _attn(f"{tb}.attn1", f"{fb}/attn1")
    yield from _attn(f"{tb}.attn2", f"{fb}/attn2")
    if ip:
        for name in ("to_k_ip", "to_v_ip"):
            yield f"{tb}.attn2.{name}.weight", f"{fb}/attn2/{name}/kernel", "dense"
    for n in ("norm1", "norm2", "norm3"):
        yield from _norm(f"{tb}.{n}", f"{fb}/{n}")
    yield from _ff(f"{tb}.ff", f"{fb}/ff")
    if temporal:  # the unet_use_temporal_attention sub-layer
        yield from _attn(f"{tb}.attn_temp", f"{fb}/attn_temp")
        yield from _norm(f"{tb}.norm_temp", f"{fb}/norm_temp")
    yield from _conv(f"{t}.proj_out", f"{f}/proj_out")


def _motion(t: str, f: str, cfg: UNet3DConfig) -> Iterator[Entry]:
    tt = f"{t}.temporal_transformer"
    yield from _norm(f"{tt}.norm", f"{f}/norm")
    yield from _dense(f"{tt}.proj_in", f"{f}/proj_in")
    for i in range(cfg.motion.num_transformer_block):
        tb, fb = f"{tt}.transformer_blocks.{i}", f"{f}/transformer_blocks_{i}"
        for k in range(len(cfg.motion.attention_block_types)):
            yield from _attn(f"{tb}.attention_blocks.{k}", f"{fb}/attention_blocks_{k}/attention")
            yield from _norm(f"{tb}.norms.{k}", f"{fb}/attention_blocks_{k}/norm")
        yield from _norm(f"{tb}.ff_norm", f"{fb}/norm")
        yield from _ff(f"{tb}.ff", f"{fb}/ff")
    yield from _dense(f"{tt}.proj_out", f"{f}/proj_out")


def unet_mapping(cfg: UNet3DConfig) -> Iterator[Entry]:
    ip, temporal = bool(cfg.ip_tokens), cfg.temporal_attention
    yield from _conv("conv_in", "conv_in/conv")
    yield from _dense("time_embedding.linear_1", "time_embedding/linear_1")
    yield from _dense("time_embedding.linear_2", "time_embedding/linear_2")
    if cfg.time_cond_proj_dim:
        yield from _dense("time_embedding.cond_proj", "time_embedding/cond_proj", bias=False)
    n_down = len(cfg.down_block_types)
    for i, bt in enumerate(cfg.down_block_types):
        in_ch = cfg.block_out_channels[max(i - 1, 0)]
        out_ch = cfg.block_out_channels[i]
        use_motion = (
            cfg.use_motion_module and (2**i) in cfg.motion_module_resolutions
            and not cfg.motion_module_decoder_only
        )
        for j in range(cfg.layers_per_block):
            t, f = f"down_blocks.{i}", f"down_blocks_{i}"
            yield from _resnet(f"{t}.resnets.{j}", f"{f}_resnets_{j}", j == 0 and in_ch != out_ch)
            if bt == "CrossAttnDownBlock3D":
                yield from _spatial(f"{t}.attentions.{j}", f"{f}_attentions_{j}", ip, temporal)
            if use_motion:
                yield from _motion(f"{t}.motion_modules.{j}", f"{f}_motion_modules_{j}", cfg)
        if i < n_down - 1:
            yield from _conv(f"down_blocks.{i}.downsamplers.0.conv",
                             f"down_blocks_{i}_downsamplers_0/conv/conv")
    yield from _resnet("mid_block.resnets.0", "mid_block_resnets_0", False)
    yield from _spatial("mid_block.attentions.0", "mid_block_attentions_0", ip, temporal)
    if cfg.use_motion_module and cfg.motion_module_mid_block:
        yield from _motion("mid_block.motion_modules.0", "mid_block_motion_modules_0", cfg)
    yield from _resnet("mid_block.resnets.1", "mid_block_resnets_1", False)
    n_up = len(cfg.up_block_types)
    for i, bt in enumerate(cfg.up_block_types):
        use_motion = cfg.use_motion_module and 2 ** (n_up - 1 - i) in cfg.motion_module_resolutions
        for j in range(cfg.layers_per_block + 1):
            t, f = f"up_blocks.{i}", f"up_blocks_{i}"
            yield from _resnet(f"{t}.resnets.{j}", f"{f}_resnets_{j}", True)
            if bt == "CrossAttnUpBlock3D":
                yield from _spatial(f"{t}.attentions.{j}", f"{f}_attentions_{j}", ip, temporal)
            if use_motion:
                yield from _motion(f"{t}.motion_modules.{j}", f"{f}_motion_modules_{j}", cfg)
        if i < n_up - 1:
            yield from _conv(f"up_blocks.{i}.upsamplers.0.conv",
                             f"up_blocks_{i}_upsamplers_0/conv/conv")
    yield from _norm("conv_norm_out", "conv_norm_out/norm")
    yield from _conv("conv_out", "conv_out/conv")


def controlnet_mapping(cfg: UNet3DConfig, cond_levels: int = 4) -> Iterator[Entry]:
    """The ControlNet's keys (diffusers layout) and Flax paths; `cond_levels`
    is the length of the condition embedding's `block_out_channels`."""
    yield from _conv("conv_in", "conv_in/conv")
    yield from _dense("time_embedding.linear_1", "time_embedding/linear_1")
    yield from _dense("time_embedding.linear_2", "time_embedding/linear_2")
    ce = "controlnet_cond_embedding"
    yield from _conv(f"{ce}.conv_in", f"{ce}/conv_in/conv")
    for b in range(2 * (cond_levels - 1)):
        yield from _conv(f"{ce}.blocks.{b}", f"{ce}/blocks_{b}/conv")
    yield from _conv(f"{ce}.conv_out", f"{ce}/conv_out/conv")
    n_down, n_res = len(cfg.down_block_types), 0
    for i, bt in enumerate(cfg.down_block_types):
        in_ch = cfg.block_out_channels[max(i - 1, 0)]
        out_ch = cfg.block_out_channels[i]
        for j in range(cfg.layers_per_block):
            t, f = f"down_blocks.{i}", f"down_blocks_{i}"
            yield from _resnet(f"{t}.resnets.{j}", f"{f}_resnets_{j}", j == 0 and in_ch != out_ch)
            if bt == "CrossAttnDownBlock3D":
                yield from _spatial(f"{t}.attentions.{j}", f"{f}_attentions_{j}")
            n_res += 1
        if i < n_down - 1:
            yield from _conv(f"down_blocks.{i}.downsamplers.0.conv",
                             f"down_blocks_{i}_downsamplers_0/conv/conv")
            n_res += 1
    yield from _resnet("mid_block.resnets.0", "mid_block_resnets_0", False)
    yield from _spatial("mid_block.attentions.0", "mid_block_attentions_0")
    yield from _resnet("mid_block.resnets.1", "mid_block_resnets_1", False)
    for idx in range(n_res + 1):  # conv_in's residual first
        yield from _conv(f"controlnet_down_blocks.{idx}", f"controlnet_down_blocks_{idx}/conv")
    yield from _conv("controlnet_mid_block", "controlnet_mid_block/conv")


# ControlNetHED's five VGG stages: (block, convolutions)
HED_BLOCKS = (("block1", 2), ("block2", 2), ("block3", 3), ("block4", 3), ("block5", 3))


def hed_mapping() -> Iterator[Entry]:
    yield "norm", "norm", "chan"
    for b, n in HED_BLOCKS:
        for i in range(n):
            yield from _conv(f"{b}.convs.{i}", f"{b}/convs_{i}")
        yield from _conv(f"{b}.projection", f"{b}/projection")


def lineart_mapping() -> Iterator[Entry]:
    # the transposed convs' (kh, kw, O, I) kernels go back to (I, O, kh, kw)
    # by the "conv" transposition too
    for t, f in (("model0.1", "conv_in"), ("model1.0", "down1"), ("model1.3", "down2"),
                 ("model3.0", "up1"), ("model3.3", "up2"), ("model4.1", "conv_out")):
        yield from _conv(t, f)
    for i in range(LINEART_RES_BLOCKS):
        yield from _conv(f"model2.{i}.conv_block.1", f"res_{i}/conv1")
        yield from _conv(f"model2.{i}.conv_block.5", f"res_{i}/conv2")


def pidinet_mapping() -> Iterator[Entry]:
    """`table5_pidinet.pth`'s keys, its `module.` prefix stripped, and its
    PDC kernels unfolded (the port folds them as it loads the file)."""
    yield "init_block.weight", "init_block/kernel", "conv"
    for s, (_, n) in enumerate(STAGES, start=1):
        for b in range(1, n + 1):
            t = f"block{s}_{b}"
            yield f"{t}.conv1.weight", f"{t}/conv1/kernel", "conv"
            yield f"{t}.conv2.weight", f"{t}/conv2/kernel", "conv"
            if s > 1 and b == 1:
                yield from _conv(f"{t}.shortcut", f"{t}/shortcut")
    for i in range(len(STAGES)):
        yield from _conv(f"dilations.{i}.conv1", f"dilations_{i}/conv1")
        for j in range(1, len(DILATIONS) + 1):
            yield f"dilations.{i}.conv2_{j}.weight", f"dilations_{i}/conv2_{j}/kernel", "conv"
        yield from _conv(f"attentions.{i}.conv1", f"attentions_{i}/conv1")
        yield f"attentions.{i}.conv2.weight", f"attentions_{i}/conv2/kernel", "conv"
        yield from _conv(f"conv_reduces.{i}.conv", f"conv_reduces_{i}")
    yield from _conv("classifier", "classifier")


def lineart_anime_mapping(num_downs: int = 8) -> Iterator[Entry]:
    """The U-Net's Sequential keys, level by level from the outermost (the
    JAX tree nests each level under `submodule`); the transposed convs'
    (kh, kw, O, I) kernels go back to (I, O, kh, kw) by the "conv"
    transposition."""
    t, f = "model.model", "outer"
    for level in range(num_downs):
        outermost, innermost = level == 0, level == num_downs - 1
        down, up = (0, 3) if outermost else (1, 3) if innermost else (1, 5)
        yield from _conv(f"{t}.{down}", f"{f}/downconv")
        yield from _conv(f"{t}.{up}", f"{f}/upconv")
        t, f = f"{t}.{1 if outermost else 3}.model", f"{f}/submodule"


def mlsd_mapping() -> Iterator[Entry]:
    yield from _conv("stem", "stem")
    for i, (e, _, _) in enumerate(IR_SPEC, start=1):
        for j in range(2 if e == 1 else 3):
            yield from _conv(f"ir_{i}.conv_{j}", f"ir_{i}/conv_{j}")
    for b in range(15, 23):
        for c in ("conv1", "conv2", "conv3") if b == 22 else ("conv1", "conv2"):
            yield from _conv(f"block{b}.{c}", f"block{b}/{c}")


def _bn(t: str, f: str) -> Iterator[Entry]:
    for tname, fname in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                         ("running_var", "var")):
        yield f"{t}.{tname}", f"{f}/{fname}", "raw"


def normalbae_mapping(cfg: NNETConfig = B5) -> Iterator[Entry]:
    """`scannet.pt`'s keys without their wrappers, the BatchNorms unfolded
    (the port folds them as it loads the file)."""
    t, f = "encoder.original_model", "encoder"
    yield f"{t}.conv_stem.weight", f"{f}/conv_stem/kernel", "conv"
    yield from _bn(f"{t}.bn1", f"{f}/bn1")
    for s, (n, expand) in enumerate(zip(cfg.repeats, cfg.expands)):
        for i in range(n):
            tb, fb = f"{t}.blocks.{s}.{i}", f"{f}/blocks_{s}_{i}"
            convs = (("conv_dw", "bn1"), ("conv_pw", "bn2")) if expand == 1 else (
                ("conv_pw", "bn1"), ("conv_dw", "bn2"), ("conv_pwl", "bn3"))
            for conv, bn in convs:
                yield f"{tb}.{conv}.weight", f"{fb}/{conv}/kernel", "conv"
                yield from _bn(f"{tb}.{bn}", f"{fb}/{bn}")
            yield from _conv(f"{tb}.se.conv_reduce", f"{fb}/se/conv_reduce")
            yield from _conv(f"{tb}.se.conv_expand", f"{fb}/se/conv_expand")
    yield f"{t}.conv_head.weight", f"{f}/conv_head/kernel", "conv"
    yield from _conv("decoder.conv2", "decoder/conv2")
    for u in ("up1", "up2", "up3", "up4"):
        tu, fu = f"decoder.{u}._net", f"decoder/{u}"
        yield from _conv(f"{tu}.0", f"{fu}/net_0")
        yield from _bn(f"{tu}.1", f"{fu}/net_1")
        yield from _conv(f"{tu}.3", f"{fu}/net_3")
        yield from _bn(f"{tu}.4", f"{fu}/net_4")
    yield from _conv("decoder.out_conv_res8", "decoder/out_conv_res8")
    for h in ("out_conv_res4", "out_conv_res2", "out_conv_res1"):
        for j in (0, 2, 4, 6):
            yield f"decoder.{h}.{j}.weight", f"decoder/{h}/c{j}/kernel", "conv1d"
            yield f"decoder.{h}.{j}.bias", f"decoder/{h}/c{j}/bias", "raw"


def _vit_layer(t: str, f: str) -> Iterator[Entry]:
    yield from _norm(f"{t}.layernorm_before", f"{f}/layernorm_before")
    yield from _norm(f"{t}.layernorm_after", f"{f}/layernorm_after")
    for tname, fname in (("attention.attention.query", "query"),
                         ("attention.attention.key", "key"),
                         ("attention.attention.value", "value"),
                         ("attention.output.dense", "attn_out"),
                         ("intermediate.dense", "intermediate"), ("output.dense", "output")):
        yield from _dense(f"{t}.{tname}", f"{f}/{fname}")


def _dpt_vit(num_layers: int) -> Iterator[Entry]:
    yield "dpt.embeddings.cls_token", "cls_token", "raw"
    yield "dpt.embeddings.position_embeddings", "position_embeddings", "raw"
    for i in range(num_layers):
        yield from _vit_layer(f"dpt.encoder.layer.{i}", f"layer_{i}")


def _dpt_neck_head(factors, levels) -> Iterator[Entry]:
    """The readout and reassemble of `levels`, the neck convs, the fusion
    layers (JAX's `fusion_{li}` is `fusion_stage.layers.{3 - li}`; the
    deepest one's residual_layer1, which upstream files hold and neither
    network runs, included) and the head."""
    for li in levels:
        rp = f"neck.reassemble_stage.layers.{li}"
        yield from _dense(f"neck.reassemble_stage.readout_projects.{li}.0", f"readout_{li}")
        yield from _conv(f"{rp}.projection", f"reassemble_proj_{li}")
        if factors[li] != 1:
            yield f"{rp}.resize.weight", f"resize_{li}/kernel", (
                "deconv" if factors[li] > 1 else "conv")
            yield f"{rp}.resize.bias", f"resize_{li}/bias", "raw"
    for li in range(4):
        yield f"neck.convs.{li}.weight", f"neck_conv_{li}/kernel", "conv"
        t, f = f"neck.fusion_stage.layers.{3 - li}", f"fusion_{li}"
        yield from _conv(f"{t}.projection", f"{f}/projection")
        for r in ("residual_layer1", "residual_layer2"):
            yield from _conv(f"{t}.{r}.convolution1", f"{f}/{r}/conv1")
            yield from _conv(f"{t}.{r}.convolution2", f"{f}/{r}/conv2")
    for j, name in ((0, "head_conv1"), (2, "head_conv2"), (4, "head_conv3")):
        yield from _conv(f"head.head.{j}", name)


def dpt_mapping(num_layers: int) -> Iterator[Entry]:
    """The plain DPT's transformers keys (`dpt.` prefix)."""
    yield from _conv("dpt.embeddings.patch_embeddings.projection", "patch_embeddings")
    yield from _dpt_vit(num_layers)
    yield from _dpt_neck_head(REASSEMBLE_FACTORS, range(4))


def dpt_hybrid_mapping(cfg: DPTHybridConfig) -> Iterator[Entry]:
    """DPT-hybrid's transformers keys; the BiT convs as the file holds them
    (unstandardised)."""
    t, f = "dpt.embeddings.backbone.bit", "backbone"
    yield f"{t}.embedder.convolution.weight", f"{f}/stem_conv/kernel", "conv"
    yield from _norm(f"{t}.embedder.norm", f"{f}/stem_norm")
    for s, depth in enumerate(cfg.bit.depths):
        for i in range(depth):
            tl, fl = f"{t}.encoder.stages.{s}.layers.{i}", f"{f}/stage_{s}_layer_{i}"
            parts = [(f"conv{n}", f"norm{n}", f"conv{n}", f"norm{n}") for n in (1, 2, 3)]
            if i == 0:
                parts.append(("downsample.conv", "downsample.norm", "downsample_conv",
                              "downsample_norm"))
            for conv, norm, fconv, fnorm in parts:
                yield f"{tl}.{conv}.weight", f"{fl}/{fconv}/kernel", "conv"
                yield from _norm(f"{tl}.{norm}", f"{fl}/{fnorm}")
    yield from _conv("dpt.embeddings.projection", "projection")
    yield from _dpt_vit(cfg.num_layers)
    yield from _dpt_neck_head(cfg.reassemble_factors, (2, 3))


def glpn_mapping(cfg: GLPNConfig) -> Iterator[Entry]:
    """transformers GLPNForDepthEstimation's keys; a depthwise conv's (kh,
    kw, 1, C) kernel goes back to (C, 1, kh, kw) by the "conv"
    transposition, the decoder's BatchNorms unfolded, `dec_conv_{si}` only
    where a stage's width differs from the decoder's."""
    e = "glpn.encoder"
    for i, depth in enumerate(cfg.depths):
        yield from _conv(f"{e}.patch_embeddings.{i}.proj", f"patch_embed_{i}")
        yield from _norm(f"{e}.patch_embeddings.{i}.layer_norm", f"patch_norm_{i}")
        yield from _norm(f"{e}.layer_norm.{i}", f"stage_norm_{i}")
        for j in range(depth):
            t, f = f"{e}.block.{i}.{j}", f"block_{i}_{j}"
            yield from _norm(f"{t}.layer_norm_1", f"{f}/layer_norm_1")
            yield from _norm(f"{t}.layer_norm_2", f"{f}/layer_norm_2")
            for name in ("query", "key", "value"):
                yield from _dense(f"{t}.attention.self.{name}", f"{f}/attention/{name}")
            yield from _dense(f"{t}.attention.output.dense", f"{f}/attention/out")
            if cfg.sr_ratios[i] > 1:
                yield from _conv(f"{t}.attention.self.sr", f"{f}/attention/sr")
                yield from _norm(f"{t}.attention.self.layer_norm", f"{f}/attention/sr_norm")
            yield from _dense(f"{t}.mlp.dense1", f"{f}/mlp/dense1")
            yield from _dense(f"{t}.mlp.dense2", f"{f}/mlp/dense2")
            yield from _conv(f"{t}.mlp.dwconv.dwconv", f"{f}/mlp/dwconv")
    for si, c in enumerate(cfg.hidden_sizes[::-1]):
        t, f = f"decoder.stages.{si}", f"dec_fusion_{si}"
        if c != cfg.decoder_hidden:
            yield from _conv(f"{t}.convolution", f"dec_conv_{si}")
        if si > 0:
            yield from _conv(f"{t}.fusion.convolutional_layer1.0", f"{f}/conv1")
            yield from _bn(f"{t}.fusion.convolutional_layer1.1", f"{f}/bn1")
            yield from _conv(f"{t}.fusion.convolutional_layer2.0", f"{f}/conv2")
            yield from _bn(f"{t}.fusion.convolutional_layer2.1", f"{f}/bn2")
            yield from _conv(f"{t}.fusion.convolutional_layer3", f"{f}/conv3")
    yield from _conv("head.head.0", "head_conv1")
    yield from _conv("head.head.2", "head_conv2")


def openpose_mapping(make) -> Iterator[Entry]:
    """An OpenPose network's convs: the port's `a.b` (or `b`) is the JAX
    package's flat `a_b` (or `b`)."""
    with torch.device("meta"):
        net = make()
    for name, module in net.named_modules():
        if isinstance(module, torch.nn.Conv2d):
            yield from _conv(name, name.replace(".", "_"))


def _vae_resnet(t: str, f: str, shortcut: bool) -> Iterator[Entry]:
    yield from _norm(f"{t}.norm1", f"{f}/norm1")
    yield from _conv(f"{t}.conv1", f"{f}/conv1")
    yield from _norm(f"{t}.norm2", f"{f}/norm2")
    yield from _conv(f"{t}.conv2", f"{f}/conv2")
    if shortcut:
        yield from _conv(f"{t}.conv_shortcut", f"{f}/conv_shortcut")


def _vae_mid(t: str, f: str) -> Iterator[Entry]:
    yield from _vae_resnet(f"{t}.resnets.0", f"{f}/mid_res_0", False)
    a, fa = f"{t}.attentions.0", f"{f}/mid_attn"
    yield from _norm(f"{a}.group_norm", f"{fa}/group_norm")
    for name in ("to_q", "to_k", "to_v"):
        yield from _dense(f"{a}.{name}", f"{fa}/{name}")
    yield from _dense(f"{a}.to_out.0", f"{fa}/to_out_0")
    yield from _vae_resnet(f"{t}.resnets.1", f"{f}/mid_res_1", False)


def vae_mapping(block_out_channels=(128, 256, 512, 512)) -> Iterator[Entry]:
    ch = list(block_out_channels)
    yield from _conv("encoder.conv_in", "encoder/conv_in")
    for i, c in enumerate(ch):
        in_ch = ch[max(i - 1, 0)]
        for j in range(2):
            yield from _vae_resnet(f"encoder.down_blocks.{i}.resnets.{j}",
                                   f"encoder/down_{i}_res_{j}", j == 0 and in_ch != c)
        if i < len(ch) - 1:
            yield from _conv(f"encoder.down_blocks.{i}.downsamplers.0.conv",
                             f"encoder/down_{i}_downsample/conv")
    yield from _vae_mid("encoder.mid_block", "encoder")
    yield from _norm("encoder.conv_norm_out", "encoder/conv_norm_out")
    yield from _conv("encoder.conv_out", "encoder/conv_out")
    rch = list(reversed(ch))
    yield from _conv("decoder.conv_in", "decoder/conv_in")
    yield from _vae_mid("decoder.mid_block", "decoder")
    for i, c in enumerate(rch):
        in_ch = rch[max(i - 1, 0)]
        for j in range(3):
            yield from _vae_resnet(f"decoder.up_blocks.{i}.resnets.{j}",
                                   f"decoder/up_{i}_res_{j}", j == 0 and in_ch != c)
        if i < len(rch) - 1:
            yield from _conv(f"decoder.up_blocks.{i}.upsamplers.0.conv",
                             f"decoder/up_{i}_upsample/conv")
    yield from _norm("decoder.conv_norm_out", "decoder/conv_norm_out")
    yield from _conv("decoder.conv_out", "decoder/conv_out")
    yield from _conv("quant_conv", "quant_conv")
    yield from _conv("post_quant_conv", "post_quant_conv")


def clip_text_mapping(num_layers: int) -> Iterator[Entry]:
    p = "text_model"
    yield f"{p}.embeddings.token_embedding.weight", "token_embedding/embedding", "raw"
    yield f"{p}.embeddings.position_embedding.weight", "position_embedding/embedding", "raw"
    for i in range(num_layers):
        yield from _clip_layer(f"{p}.encoder.layers.{i}", f"layers_{i}")
    yield from _norm(f"{p}.final_layer_norm", "final_layer_norm")


def _clip_layer(t: str, f: str) -> Iterator[Entry]:
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        yield from _dense(f"{t}.self_attn.{name}", f"{f}/self_attn/{name}")
    yield from _norm(f"{t}.layer_norm1", f"{f}/layer_norm1")
    yield from _norm(f"{t}.layer_norm2", f"{f}/layer_norm2")
    yield from _dense(f"{t}.mlp.fc1", f"{f}/mlp_fc1")
    yield from _dense(f"{t}.mlp.fc2", f"{f}/mlp_fc2")


def clip_vision_mapping(num_layers: int) -> Iterator[Entry]:
    p = "vision_model"
    yield f"{p}.embeddings.class_embedding", "class_embedding", "raw"
    yield f"{p}.embeddings.patch_embedding.weight", "patch_embedding/kernel", "conv"
    yield f"{p}.embeddings.position_embedding.weight", "position_embedding/embedding", "raw"
    yield from _norm(f"{p}.pre_layrnorm", "pre_layrnorm")
    for i in range(num_layers):
        yield from _clip_layer(f"{p}.encoder.layers.{i}", f"layers_{i}")
    yield from _norm(f"{p}.post_layernorm", "post_layernorm")
    yield "visual_projection.weight", "visual_projection/kernel", "dense"


def image_proj_mapping(depth: int = 0) -> Iterator[Entry]:
    """The base `ImageProjModel`'s keys, or with `depth` the `Resampler`'s."""
    if not depth:
        yield from _dense("proj", "proj")
        yield from _norm("norm", "norm")
        return
    yield "latents", "latents", "raw"
    yield from _dense("proj_in", "proj_in")
    yield from _dense("proj_out", "proj_out")
    yield from _norm("norm_out", "norm_out")
    for i in range(depth):
        a = f"layers_{i}_attn"
        yield from _norm(f"layers.{i}.0.norm1", f"{a}/norm1")
        yield from _norm(f"layers.{i}.0.norm2", f"{a}/norm2")
        for name in ("to_q", "to_kv", "to_out"):
            yield from _dense(f"layers.{i}.0.{name}", f"{a}/{name}", bias=False)
        yield from _norm(f"layers.{i}.1.0", f"layers_{i}_ff_norm")
        yield from _dense(f"layers.{i}.1.1", f"layers_{i}_ff_0", bias=False)
        yield from _dense(f"layers.{i}.1.3", f"layers_{i}_ff_2", bias=False)


def mlp_proj_mapping() -> Iterator[Entry]:
    yield from _dense("proj.0", "proj_0")
    yield from _dense("proj.2", "proj_2")
    yield from _norm("proj.3", "norm")


def rrdbnet_mapping(num_block: int) -> Iterator[Entry]:
    for name in ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr", "conv_last"):
        yield from _conv(name, name)
    for i in range(num_block):
        for r in (1, 2, 3):
            for c in range(1, 6):
                yield from _conv(f"body.{i}.rdb{r}.conv{c}", f"body_{i}/rdb{r}/conv{c}")


def gfpgan_mapping(out_size: int) -> Iterator[Entry]:
    """`GFPGANv1Clean`'s keys; the JAX tree has no style MLP either."""
    log_size = int(math.log2(out_size))

    def resblock(t, f):
        yield from _conv(f"{t}.conv1", f"{f}/conv1")
        yield from _conv(f"{t}.conv2", f"{f}/conv2")
        yield f"{t}.skip.weight", f"{f}/skip/kernel", "conv"

    def modconv(t, f):
        yield f"{t}.weight", f"{f}/weight", "lead1"
        yield from _dense(f"{t}.modulation", f"{f}/modulation")

    def styleconv(t, f):
        yield from modconv(f"{t}.modulated_conv", f"{f}/modulated_conv")
        yield f"{t}.weight", f"{f}/noise_weight", "vec1"
        yield f"{t}.bias", f"{f}/bias", "chan"

    def torgb(t, f):
        yield from modconv(f"{t}.modulated_conv", f"{f}/modulated_conv")
        yield f"{t}.bias", f"{f}/bias", "chan"

    yield from _conv("conv_body_first", "conv_body_first")
    yield from _conv("final_conv", "final_conv")
    yield from _dense("final_linear", "final_linear")
    for i in range(log_size - 2):
        yield from resblock(f"conv_body_down.{i}", f"conv_body_down_{i}")
        yield from resblock(f"conv_body_up.{i}", f"conv_body_up_{i}")
        for cond in ("condition_scale", "condition_shift"):
            yield from _conv(f"{cond}.{i}.0", f"{cond}_{i}_0")
            yield from _conv(f"{cond}.{i}.2", f"{cond}_{i}_2")
    d = "stylegan_decoder"
    yield f"{d}.constant_input.weight", f"{d}/constant_input", "nchw"
    yield from styleconv(f"{d}.style_conv1", f"{d}/style_conv1")
    yield from torgb(f"{d}.to_rgb1", f"{d}/to_rgb1")
    for i in range((log_size - 2) * 2):
        yield from styleconv(f"{d}.style_convs.{i}", f"{d}/style_convs_{i}")
    for i in range(log_size - 2):
        yield from torgb(f"{d}.to_rgbs.{i}", f"{d}/to_rgbs_{i}")


def retinaface_mapping() -> Iterator[Entry]:
    """`RetinaFaceNet`'s keys: its folded convs hold the checkpoint's conv
    names, the JAX tree the flax module names."""
    yield from _conv("body.conv1", "body/conv1")
    for li, (_, blocks) in enumerate(RESNET50_STAGES, start=1):
        for b in range(blocks):
            t, f = f"body.layer{li}.{b}", f"body/layer{li}_{b}"
            for c in (1, 2, 3):
                yield from _conv(f"{t}.conv{c}", f"{f}/conv{c}")
            if b == 0:
                yield from _conv(f"{t}.downsample.0", f"{f}/downsample")
    for name in ("output1", "output2", "output3", "merge1", "merge2"):
        yield from _conv(f"fpn.{name}.0", f"fpn_{name}")
    for i in (1, 2, 3):
        for branch in SSH_BRANCHES:
            yield from _conv(f"ssh{i}.{branch}.0", f"ssh{i}/{branch}")
    for i in range(3):
        for head, f in (("ClassHead", "class_head"), ("BboxHead", "bbox_head"),
                        ("LandmarkHead", "landmark_head")):
            yield from _conv(f"{head}.{i}.conv1x1", f"{f}_{i}")


def _get(tree: dict, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _state_dict(params: dict, mapping: Iterator[Entry]) -> dict[str, torch.Tensor]:
    out = {}
    for tkey, fpath, kind in mapping:
        arr = np.asarray(_get(params, fpath))
        if kind in ("conv", "deconv"):  # (kh, kw, a, b) -> (b, a, kh, kw)
            arr = np.transpose(arr, (3, 2, 0, 1))
        elif kind == "dense":
            arr = arr.T
        elif kind == "nchw":
            arr = np.transpose(arr, (0, 3, 1, 2))
        elif kind == "lead1":
            arr = arr[None]
        elif kind == "chan":
            arr = arr.reshape(1, -1, 1, 1)
        elif kind == "vec1":
            arr = arr.reshape(1)
        elif kind == "conv1d":
            arr = np.transpose(arr[0], (2, 1, 0))
        out[tkey] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def unet_state_dict(params: dict, cfg: UNet3DConfig) -> dict[str, torch.Tensor]:
    return _state_dict(params, unet_mapping(cfg))


def vae_state_dict(params: dict, block_out_channels=(128, 256, 512, 512)) -> dict[str, torch.Tensor]:
    return _state_dict(params, vae_mapping(block_out_channels))


def clip_text_state_dict(params: dict, cfg: CLIPTextConfig) -> dict[str, torch.Tensor]:
    return _state_dict(params, clip_text_mapping(cfg.num_layers))


def clip_vision_state_dict(params: dict, cfg: CLIPVisionConfig) -> dict[str, torch.Tensor]:
    return _state_dict(params, clip_vision_mapping(cfg.num_layers))


def image_proj_state_dict(params: dict, depth: int = 0) -> dict[str, torch.Tensor]:
    return _state_dict(params, image_proj_mapping(depth))


def mlp_proj_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, mlp_proj_mapping())


def rrdbnet_state_dict(params: dict, num_block: int) -> dict[str, torch.Tensor]:
    return _state_dict(params, rrdbnet_mapping(num_block))


def gfpgan_state_dict(params: dict, out_size: int) -> dict[str, torch.Tensor]:
    return _state_dict(params, gfpgan_mapping(out_size))


def retinaface_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, retinaface_mapping())


def controlnet_state_dict(params: dict, cfg: UNet3DConfig,
                          cond_levels: int = 4) -> dict[str, torch.Tensor]:
    return _state_dict(params, controlnet_mapping(cfg, cond_levels))


def hed_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, hed_mapping())


def lineart_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, lineart_mapping())


def pidinet_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, pidinet_mapping())


def lineart_anime_state_dict(params: dict, num_downs: int = 8) -> dict[str, torch.Tensor]:
    return _state_dict(params, lineart_anime_mapping(num_downs))


def mlsd_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, mlsd_mapping())


def normalbae_state_dict(params: dict, cfg: NNETConfig = B5) -> dict[str, torch.Tensor]:
    return _state_dict(params, normalbae_mapping(cfg))


def openpose_body_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, openpose_mapping(BodyPoseNet))


def openpose_hand_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, openpose_mapping(HandPoseNet))


def openpose_face_state_dict(params: dict) -> dict[str, torch.Tensor]:
    return _state_dict(params, openpose_mapping(FaceNet))


def dpt_state_dict(params: dict, num_layers: int) -> dict[str, torch.Tensor]:
    return _state_dict(params, dpt_mapping(num_layers))


def dpt_hybrid_state_dict(params: dict, cfg: DPTHybridConfig) -> dict[str, torch.Tensor]:
    return _state_dict(params, dpt_hybrid_mapping(cfg))


def glpn_state_dict(params: dict, cfg: GLPNConfig) -> dict[str, torch.Tensor]:
    return _state_dict(params, glpn_mapping(cfg))
