"""Checkpoints of the port, and weights from the JAX package.

The save side: `save_checkpoint` writes a state tree (training/common.py:
`state_to_tree`) as `{ckpt_dir}/{name}.pth` with its metrics in the
`{name}.metrics.json` sidecar; `load_checkpoint` reads both back;
`find_latest_checkpoint` picks the highest `checkpoint_epoch_N` for a
resume, falling back to `best_model`. The layout follows the JAX package's
(adam_dehaze_tpu/training/checkpoint.py), one torch file where that is an
orbax directory.

Weights from the JAX package:

`load_torch_fcos(state_dict, detector)` fills the torchvision-geometry
detector from a torchvision `fcos_resnet50_fpn` state dict, as the JAX
package's load_torch_fcos fills its tree.

The upstream reference's checkpoints go into port modules through the JAX
package's readers' counterparts (`load_torch_joint`, `load_torch_branch`
with `branch_kind_for`, `load_torch_classifier` on every backbone,
`load_torch_gate`, `load_torch_resnet`, `load_torch_mobilenet_v2`/`_v3`,
`load_torch_efficientnet`, `load_torch_vgg16`, `load_torch_alexnet`,
`load_torch_lpips`): each takes a `.pth` path or a state dict and fills
the module in place, raising on a missing, surplus or mis-shaped key.
`python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint`
writes them as the port's checkpoints.

`load_flax_variables(module, variables)` fills a port module from the JAX
package's `{"params", "batch_stats"}` tree (nested dicts of arrays): a
block, a branch of any model type, the classifier on any backbone (ResNet;
MobileNetV2/V3 and EfficientNet, whose convs and BNs flax names in call
order), the DenseFeatureExtractor (`ResNet_0`), a whole router (subtrees
`classifier` and `models_{low,medium,high}`, and a GatedRouter's gate
`Dense_{0,1,2}`), or
the FCOS detector (`ResNet_0`, `FPN_0`: lateral{i}, smooth{i}, p6, p7;
`FCOSHead_0`: cls{i}, reg{i}, cls_gn{i}, reg_gn{i}, cls_out, reg_out,
ctr_out), or the evaluation's QualityHead (`Conv_{0..3}`, `Dense_0`). It
inverts the layout conversions of adam_dehaze_tpu/training/checkpoint.py
(convert_torch_conv, convert_torch_linear, convert_torch_convtranspose)
along the same block tables (_block_assigns, _branch_layout,
load_torch_resnet, load_torch_classifier, load_torch_gate). Because the
port registers its submodules under the upstream reference's torch names,
`module.state_dict()` fed back through the JAX side's `load_torch_joint`
gives the original tree.

The loss nets (VGG16Features, AlexNetFeatures, LPIPS) map flax's
`conv{stage}_{idx}` / `conv{i}` / `lin{i}` onto torchvision's `features.N`
keys. orbax checkpoints, which only JAX reads, are not read here.
"""
from __future__ import annotations

import itertools
import json
import os
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from adam_dehaze_tpu_torch.evaluation.no_reference import QualityHead
from adam_dehaze_tpu_torch.losses.lpips import LPIPS
from adam_dehaze_tpu_torch.models.branches import (
    COrunInspiredModel,
    DualBranchAttentionModel,
    EncoderDecoder,
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    LowIntensityUNet,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.models.classifier import (
    DenseFeatureExtractor,
    FogIntensityClassifier,
)
from adam_dehaze_tpu_torch.models.detection import FCOSDetector
from adam_dehaze_tpu_torch.models.routing import (
    INTENSITY_ORDER,
    GatedRouter,
    HardRouter,
    SoftRouter,
)
from adam_dehaze_tpu_torch.nn import efficientnet, mobilenet
from adam_dehaze_tpu_torch.nn.alexnet import AlexNetFeatures
from adam_dehaze_tpu_torch.nn.blocks import (
    AttentionBlock,
    ConvBlock,
    ResidualBlock,
    UpBlock,
)
from adam_dehaze_tpu_torch.nn.resnet import Bottleneck, ResNet
from adam_dehaze_tpu_torch.nn.vgg import _STAGES as _VGG_STAGES
from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
from adam_dehaze_tpu_torch.parallel.multihost import process_count, process_index

_EPOCH_RE = re.compile(r"checkpoint_epoch_(\d+)\.pth$")


def _metrics_path(path: str) -> str:
    return os.path.splitext(path)[0] + ".metrics.json"


def save_checkpoint(ckpt_dir: str, name: str, state: Dict[str, Any],
                    metrics: Optional[Dict[str, float]] = None) -> str:
    """Save a state tree as {ckpt_dir}/{name}.pth (+ the metrics sidecar);
    returns the path. The file is replaced atomically. Under a process
    group of more than one process, process 0 writes and every process
    waits on a barrier until the file is there, as orbax saves a
    replicated state once."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"{name}.pth"))
    if process_index() == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
        torch.save(state, path + ".tmp")
        os.replace(path + ".tmp", path)
        if metrics is not None:
            with open(_metrics_path(path), "w") as f:
                json.dump({k: float(v) for k, v in metrics.items()}, f, indent=2)
    if process_count() > 1:
        torch.distributed.barrier()
    return path


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Read a checkpoint onto the CPU: (state tree, metrics)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    metrics = {}
    if os.path.exists(_metrics_path(path)):
        with open(_metrics_path(path)) as f:
            metrics = json.load(f)
    return state, metrics


def best_model_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, "best_model.pth")


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest checkpoint_epoch_N for a resume, else best_model, else
    None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [(int(m.group(1)), entry) for entry in os.listdir(ckpt_dir)
              if (m := _EPOCH_RE.match(entry))]
    if epochs:
        return os.path.join(ckpt_dir, max(epochs)[1])
    best = best_model_path(ckpt_dir)
    return best if os.path.exists(best) else None

# (torch key, collection, flax path, transform or None)
Assign = Tuple[str, str, tuple, Optional[Callable]]


def _conv(k):
    """flax HWIO -> torch OIHW."""
    return np.transpose(k, (3, 2, 0, 1))


def _linear(k):
    """flax (in, out) -> torch (out, in)."""
    return np.transpose(k)


def _dense_as_1x1(k):
    """flax Dense (in, out) -> torch 1x1 Conv2d (out, in, 1, 1)."""
    return np.transpose(k)[:, :, None, None]


def _convtranspose(k):
    """flax ConvTranspose (kH, kW, in, out), spatially flipped -> torch
    ConvTranspose2d (in, out, kH, kW)."""
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def _bn(tp: str, fp: tuple, out: List[Assign]) -> None:
    out += [(f"{tp}.weight", "params", fp + ("scale",), None),
            (f"{tp}.bias", "params", fp + ("bias",), None),
            (f"{tp}.running_mean", "batch_stats", fp + ("mean",), None),
            (f"{tp}.running_var", "batch_stats", fp + ("var",), None)]


def _block(kind: str, tp: str, fp: tuple, keys, out: List[Assign]) -> None:
    """One reference block at torch prefix `tp` ("" for a lone block) and
    flax path `fp` (kinds as in the JAX package's _block_assigns)."""
    def k(name):
        return f"{tp}.{name}" if tp else name

    if kind == "CB":
        out.append((k("block.0.weight"), "params", fp + ("Conv_0", "kernel"), _conv))
        if k("block.0.bias") in keys:
            out.append((k("block.0.bias"), "params", fp + ("Conv_0", "bias"), None))
        if k("block.1.weight") in keys:
            _bn(k("block.1"), fp + ("BatchNorm_0",), out)
    elif kind == "RES":
        _block("CB", k("conv1"), fp + ("ConvBlock_0",), keys, out)
        _block("CB", k("conv2"), fp + ("ConvBlock_1",), keys, out)
    elif kind == "ATT":
        out += [(k("fc.0.weight"), "params", fp + ("Dense_0", "kernel"), _dense_as_1x1),
                (k("fc.2.weight"), "params", fp + ("Dense_1", "kernel"), _dense_as_1x1),
                (k("conv_spatial.weight"), "params", fp + ("spatial_conv",), _conv)]
    elif kind == "UP":
        out += [(k("0.weight"), "params", fp + ("ConvTranspose_0", "kernel"),
                 _convtranspose),
                (k("0.bias"), "params", fp + ("ConvTranspose_0", "bias"), None)]
        _bn(k("1"), fp + ("BatchNorm_0",), out)
    elif kind == "CONV":
        out.append((k("weight"), "params", fp + ("kernel",), _conv))
        if k("bias") in keys:
            out.append((k("bias"), "params", fp + ("bias",), None))
    else:
        raise ValueError(f"Unknown block kind {kind}")


_BLOCK_KINDS = {ConvBlock: "CB", ResidualBlock: "RES", AttentionBlock: "ATT",
                UpBlock: "UP"}


def _branch_table(model: nn.Module) -> list:
    """(block kind, torch prefix, flax name) per block, in the JAX
    package's _branch_layout order."""
    if isinstance(model, LightweightDehazeModel):
        t = [("CB", "init_conv", "ConvBlock_0")]
        t += [("RES", f"residual_blocks.{i}", f"ResidualBlock_{i}")
              for i in range(model.n_blocks)]
        return t + [("CB", "output_conv.0", "ConvBlock_1"),
                    ("CONV", "output_conv.1", "Conv_0")]
    if isinstance(model, MediumIntensityDehazeModel):
        return [
            ("CB", "init_conv", "ConvBlock_0"),
            ("CB", "encoder.0.0", "ConvBlock_1"),
            ("RES", "encoder.0.1", "ResidualBlock_0"),
            ("RES", "encoder.0.2", "ResidualBlock_1"),
            ("CB", "encoder.1.0", "ConvBlock_2"),
            ("RES", "encoder.1.1", "ResidualBlock_2"),
            ("RES", "encoder.1.2", "ResidualBlock_3"),
            ("RES", "bottleneck.0", "ResidualBlock_4"),
            ("RES", "bottleneck.1", "ResidualBlock_5"),
            ("UP", "decoder.0", "UpBlock_0"),
            ("RES", "decoder.0.3", "ResidualBlock_6"),
            ("UP", "decoder.1", "UpBlock_1"),
            ("RES", "decoder.1.3", "ResidualBlock_7"),
            ("CB", "output_conv.0", "ConvBlock_3"),
            ("CB", "output_conv.1", "ConvBlock_4"),
            ("CONV", "output_conv.2", "Conv_0"),
        ]
    if isinstance(model, HighIntensityDehazeModel):
        return [
            ("CB", "detail_branch.0", "ConvBlock_0"),
            ("CB", "detail_branch.1", "ConvBlock_1"),
            ("CONV", "detail_branch.2", "Conv_0"),
            ("CB", "init_conv", "ConvBlock_2"),
            ("CB", "encoder.0.0", "ConvBlock_3"),
            ("RES", "encoder.0.1", "ResidualBlock_0"),
            ("RES", "encoder.0.2", "ResidualBlock_1"),
            ("ATT", "encoder.0.3", "AttentionBlock_0"),
            ("CB", "encoder.1.0", "ConvBlock_4"),
            ("RES", "encoder.1.1", "ResidualBlock_2"),
            ("RES", "encoder.1.2", "ResidualBlock_3"),
            ("ATT", "encoder.1.3", "AttentionBlock_1"),
            ("RES", "bottleneck.0", "ResidualBlock_4"),
            ("ATT", "bottleneck.1", "AttentionBlock_2"),
            ("RES", "bottleneck.2", "ResidualBlock_5"),
            ("ATT", "bottleneck.3", "AttentionBlock_3"),
            ("UP", "decoder.0", "UpBlock_0"),
            ("RES", "decoder.0.3", "ResidualBlock_6"),
            ("ATT", "decoder.0.4", "AttentionBlock_4"),
            ("UP", "decoder.1", "UpBlock_1"),
            ("RES", "decoder.1.3", "ResidualBlock_7"),
            ("ATT", "decoder.1.4", "AttentionBlock_5"),
            ("CB", "output_conv.0", "ConvBlock_5"),
            ("CB", "output_conv.1", "ConvBlock_6"),
            ("CONV", "output_conv.2", "Conv_1"),
        ]
    if isinstance(model, LowIntensityUNet):
        t = [("CB", "init_conv", "ConvBlock_0"), ("CB", "down1.0", "ConvBlock_1"),
             ("RES", "down1.1", "ResidualBlock_0")]
        t += [("RES", f"bottleneck.{i}", f"ResidualBlock_{i + 1}")
              for i in range(model.n_blocks - 1)]
        return t + [("UP", "up1", "UpBlock_0"), ("CB", "output_conv.0", "ConvBlock_2"),
                    ("CB", "output_conv.1", "ConvBlock_3"), ("CONV", "output_conv.2", "Conv_0")]
    if isinstance(model, COrunInspiredModel):
        t = [("CB", "init_conv", "ConvBlock_0"), ("CB", "scale1_conv", "ConvBlock_1"),
             ("CB", "scale2_conv.1", "ConvBlock_2"), ("CB", "scale3_conv.1", "ConvBlock_3"),
             ("CB", "fusion_conv", "ConvBlock_4")]
        t += [("RES", f"residual_blocks.{i}", f"ResidualBlock_{i}")
              for i in range(model.n_blocks)]
        return t + [("CB", "output_conv.0", "ConvBlock_5"), ("CONV", "output_conv.1", "Conv_0")]
    if isinstance(model, DualBranchAttentionModel):
        return [
            ("CB", "global_branch.0", "ConvBlock_0"),
            ("RES", "global_branch.2", "ResidualBlock_0"),
            ("ATT", "global_branch.3", "AttentionBlock_0"),
            ("RES", "global_branch.5", "ResidualBlock_1"),
            ("ATT", "global_branch.6", "AttentionBlock_1"),
            ("RES", "global_branch.7", "ResidualBlock_2"),
            ("RES", "global_branch.9", "ResidualBlock_3"),
            ("CB", "global_branch.11", "ConvBlock_1"),
            ("CB", "local_branch.0", "ConvBlock_2"),
            ("RES", "local_branch.1", "ResidualBlock_4"),
            ("RES", "local_branch.2", "ResidualBlock_5"),
            ("CB", "local_branch.3", "ConvBlock_3"),
            ("CB", "transmission_branch.0", "ConvBlock_4"),
            ("CB", "transmission_branch.1", "ConvBlock_5"),
            ("CONV", "transmission_branch.2", "Conv_0"),
            ("CB", "fusion_conv.0", "ConvBlock_6"),
            ("CONV", "fusion_conv.1", "Conv_1"),
        ]
    if isinstance(model, EncoderDecoder):
        # flax's call order: the stem, each encoder level's strided
        # ConvBlock and ResidualBlocks, the bottleneck, each decoder level's
        # ResidualBlocks, UpBlock and fusion ConvBlock, the output.
        per, res = model.per, itertools.count()
        t = [("CB", "init_conv", "ConvBlock_0")]
        for lvl in range(3):
            t.append(("CB", f"encoder.{lvl}.0", f"ConvBlock_{lvl + 1}"))
            t += [("RES", f"encoder.{lvl}.{i + 1}", f"ResidualBlock_{next(res)}")
                  for i in range(per)]
        t += [("RES", f"bottleneck.{i}", f"ResidualBlock_{next(res)}") for i in range(2)]
        if model.use_attention:
            t.append(("ATT", "bottleneck.2", "AttentionBlock_0"))
        for lvl in range(3):
            t += [("RES", f"decoder.{lvl}.{i}", f"ResidualBlock_{next(res)}")
                  for i in range(per)]
            t += [("UP", f"decoder.{lvl}.{per}", f"UpBlock_{lvl}"),
                  ("CB", f"fusion.{lvl}", f"ConvBlock_{lvl + 4}")]
        return t + [("CB", "output_conv.0", "ConvBlock_7"), ("CONV", "output_conv.1", "Conv_0")]
    raise TypeError(f"no weight layout for {type(model).__name__}")


def _feature_net_assigns(module: nn.Module, tp: str = "", fp: tuple = ()) -> List[Assign]:
    """The loss nets: flax `conv{stage}_{idx}` (VGG16) or `conv{i}`
    (AlexNet) onto `features.N`, LPIPS's trunk and heads."""
    if isinstance(module, LPIPS):
        out = _feature_net_assigns(module.net, "net.", ("AlexNetFeatures_0",))
        return out + [(f"lin{i}", "params", (f"lin{i}",), None) for i in range(5)]
    convs = [i for i, m in enumerate(module.features) if isinstance(m, nn.Conv2d)]
    if isinstance(module, VGG16Features):
        names = [f"conv{si}_{ci}" for si, (_, n) in enumerate(_VGG_STAGES, start=1)
                 for ci in range(1, n + 1)]
    else:
        names = [f"conv{i}" for i in range(1, 6)]
    out: List[Assign] = []
    for idx, name in zip(convs, names):
        out += [(f"{tp}features.{idx}.weight", "params", fp + (name, "kernel"), _conv),
                (f"{tp}features.{idx}.bias", "params", fp + (name, "bias"), None)]
    return out


def _resnet(tp: str, resnet, fp: tuple, keys, out: List[Assign]) -> None:
    """A ResNet at torch prefix `tp` and flax path `fp` (the JAX package's
    load_torch_resnet): the stem, then each block's convs and BNs and its
    downsample pair."""
    out.append((f"{tp}.conv1.weight", "params", fp + ("Conv_0", "kernel"), _conv))
    _bn(f"{tp}.bn1", fp + ("BatchNorm_0",), out)
    bottleneck = isinstance(resnet.layer1[0], Bottleneck)
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    n_convs = 3 if bottleneck else 2
    idx = 0
    for li, n_blocks in enumerate(resnet.stage_sizes, start=1):
        for b in range(n_blocks):
            bp, bf = f"{tp}.layer{li}.{b}", fp + (f"{block_name}_{idx}",)
            for ci in range(n_convs):
                out.append((f"{bp}.conv{ci + 1}.weight", "params",
                            bf + (f"Conv_{ci}", "kernel"), _conv))
                _bn(f"{bp}.bn{ci + 1}", bf + (f"BatchNorm_{ci}",), out)
            if f"{bp}.downsample.0.weight" in keys:
                out.append((f"{bp}.downsample.0.weight", "params",
                            bf + (f"Conv_{n_convs}", "kernel"), _conv))
                _bn(f"{bp}.downsample.1", bf + (f"BatchNorm_{n_convs}",), out)
            idx += 1


# Port modules that flax builds as named submodules of their own.
_FLAX_SUBMODULES = {mobilenet.InvertedResidual: "InvertedResidual",
                    mobilenet.InvertedResidualV3: "InvertedResidualV3",
                    mobilenet.SqueezeExcite: "SqueezeExcite",
                    efficientnet.MBConv: "MBConv",
                    efficientnet.SqueezeExcite: "SqueezeExcite"}


def _call_order(module: nn.Module, tp: str, fp: tuple, out: List[Assign]) -> None:
    """A MobileNet or EfficientNet (sub)module at torch prefix `tp` and flax
    path `fp`. flax auto-names its convs, BNs and blocks in call order
    (`Conv_i`, `BatchNorm_i`, `MBConv_i`, ...), which is the order in which
    the port registers them; MobileNetV3's SE gate names its Dense layers
    `fc1` and `fc2` (1x1 convs here)."""
    counters = dict.fromkeys(("Conv", "BatchNorm", *_FLAX_SUBMODULES.values()), 0)

    def walk(m: nn.Module, prefix: str) -> None:
        for name, child in m.named_children():
            cp = f"{prefix}.{name}"
            if isinstance(child, mobilenet.SqueezeExcite):
                sp = fp + (f"SqueezeExcite_{counters['SqueezeExcite']}",)
                counters["SqueezeExcite"] += 1
                for fc in ("fc1", "fc2"):
                    out.extend([(f"{cp}.{fc}.weight", "params", sp + (fc, "kernel"),
                                 _dense_as_1x1),
                                (f"{cp}.{fc}.bias", "params", sp + (fc, "bias"), None)])
            elif type(child) in _FLAX_SUBMODULES:
                kind = _FLAX_SUBMODULES[type(child)]
                _call_order(child, cp, fp + (f"{kind}_{counters[kind]}",), out)
                counters[kind] += 1
            elif isinstance(child, nn.Conv2d):
                cf = fp + (f"Conv_{counters['Conv']}",)
                counters["Conv"] += 1
                out.append((f"{cp}.weight", "params", cf + ("kernel",), _conv))
                if child.bias is not None:
                    out.append((f"{cp}.bias", "params", cf + ("bias",), None))
            elif isinstance(child, nn.BatchNorm2d):
                _bn(cp, fp + (f"BatchNorm_{counters['BatchNorm']}",), out)
                counters["BatchNorm"] += 1
            else:
                walk(child, cp)

    walk(module, tp)


# The flax name of a classifier backbone, by its port class.
_BACKBONE_FLAX = {ResNet: "ResNet", mobilenet.MobileNetV2: "MobileNetV2",
                  mobilenet.MobileNetV3: "MobileNetV3", efficientnet.EfficientNet: "EfficientNet"}


def _assigns(module: nn.Module, variables) -> List[Assign]:
    keys = set(module.state_dict())
    out: List[Assign] = []
    if isinstance(module, (VGG16Features, AlexNetFeatures, LPIPS)):
        return _feature_net_assigns(module)
    if isinstance(module, DenseFeatureExtractor):
        _resnet("backbone", module.backbone, ("ResNet_0",), keys, out)
        return out
    if isinstance(module, FogIntensityClassifier):
        kind = _BACKBONE_FLAX[type(module.backbone)]
        bb = next(k for k in variables["params"] if k.startswith(f"{kind}_"))
        if kind == "ResNet":
            _resnet("backbone", module.backbone, (bb,), keys, out)
        else:
            _call_order(module.backbone, "backbone", (bb,), out)
        for ti, fi in ((1, 0), (4, 1)):
            out += [(f"classifier.{ti}.weight", "params", (f"Dense_{fi}", "kernel"),
                     _linear),
                    (f"classifier.{ti}.bias", "params", (f"Dense_{fi}", "bias"), None)]
        return out
    if isinstance(module, QualityHead):
        for i in range(len(module.convs)):
            _block("CONV", f"convs.{i}", (f"Conv_{i}",), keys, out)
        return out + [("dense.weight", "params", ("Dense_0", "kernel"), _linear),
                      ("dense.bias", "params", ("Dense_0", "bias"), None)]
    if isinstance(module, FCOSDetector):
        _resnet("backbone", module.backbone, ("ResNet_0",), keys, out)
        fpn = module.fpn
        convs = [f"{kind}{i}" for i in range(fpn.n_levels) for kind in ("lateral", "smooth")]
        convs += ["p6", "p7"] if fpn.extra_levels else []
        for name in convs:
            _block("CONV", f"fpn.{name}", ("FPN_0", name), keys, out)
        head = module.head
        for i in range(head.tower_convs):
            for branch in ("cls", "reg"):
                _block("CONV", f"head.{branch}{i}", ("FCOSHead_0", f"{branch}{i}"), keys, out)
                if head.group_norm:
                    gn, fp = f"head.{branch}_gn{i}", ("FCOSHead_0", f"{branch}_gn{i}")
                    out += [(f"{gn}.weight", "params", fp + ("scale",), None),
                            (f"{gn}.bias", "params", fp + ("bias",), None)]
        for name in ("cls_out", "reg_out", "ctr_out"):
            _block("CONV", f"head.{name}", ("FCOSHead_0", name), keys, out)
        return out
    if isinstance(module, (SoftRouter, HardRouter, GatedRouter)):
        out = []
        if isinstance(module, GatedRouter) and module.classifier is not None:
            # The gate MLP: the reference's gate_network.{0,3,5} are flax's
            # router-level Dense_{0,1,2} (load_torch_gate).
            for ti, fi in ((0, 0), (3, 1), (5, 2)):
                out += [(f"gate_network.{ti}.weight", "params", (f"Dense_{fi}", "kernel"),
                         _linear),
                        (f"gate_network.{ti}.bias", "params", (f"Dense_{fi}", "bias"), None)]
        subs = [("classifier", "classifier", module.classifier)]
        subs += [(f"models.{lvl}", f"models_{lvl}", module.models[lvl])
                 for lvl in INTENSITY_ORDER if lvl in module.models]
        for tprefix, fname, sub in subs:
            if sub is None:
                continue
            subvars = {c: variables[c][fname] for c in ("params", "batch_stats")
                       if fname in variables.get(c, {})}
            out += [(f"{tprefix}.{k}", c, (fname,) + p, tf)
                    for k, c, p, tf in _assigns(sub, subvars)]
        return out
    if type(module) in _BLOCK_KINDS:
        _block(_BLOCK_KINDS[type(module)], "", (), keys, out)
        return out
    for kind, tp, fname in _branch_table(module):
        _block(kind, tp, (fname,), keys, out)
    if isinstance(module, LightweightDehazeModel):
        out.append(("skip_alpha", "params", ("skip_alpha",), None))
    return out


@torch.no_grad()
def load_flax_variables(module: nn.Module, variables) -> nn.Module:
    """Fill `module` in place from a JAX `{"params", "batch_stats"}` tree.
    Raises on a shape mismatch and on any parameter or buffer left unset
    (BN's num_batches_tracked aside)."""
    sd = module.state_dict()
    done = set()
    for key, coll, path, tf in _assigns(module, variables):
        node = variables[coll]
        for p in path:
            node = node[p]
        value = np.asarray(node, dtype=np.float32)
        if tf is not None:
            value = tf(value)
        target = sd[key]
        if tuple(target.shape) != value.shape:
            raise ValueError(f"Shape mismatch at {key} <- {'/'.join(path)}: "
                             f"{tuple(target.shape)} vs {value.shape}")
        target.copy_(torch.from_numpy(np.array(value, order="C")))
        done.add(key)
    missing = [k for k in sd if k not in done and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"not filled from the flax tree: {missing[:8]}"
                         f"{' ...' if len(missing) > 8 else ''}")
    return module


def _tv_fcos_keys(sd) -> Dict[str, str]:
    """{port key: torchvision key} of a torchvision `fcos_resnet50_fpn`
    state dict, after the JAX package's load_torch_fcos (its docstring gives
    the layout). The FPN convs come flat (`p.weight`) or nested in
    Conv2dNormActivation (`p.0.weight`), the head towers nested (`conv.{i}.0`
    conv, `conv.{i}.1` GroupNorm) or flat interleaved (`conv.{3i}`,
    `conv.{3i+1}`): torchvision has shipped both."""
    keys = {}
    for k in sd:
        if k.startswith("backbone.body."):
            keys["backbone." + k[len("backbone.body."):]] = k

    def conv(port, tv):
        nested = f"{tv}.0.weight" in sd
        for p in ("weight", "bias"):
            keys[f"{port}.{p}"] = f"{tv}.0.{p}" if nested else f"{tv}.{p}"

    for i in range(3):
        conv(f"fpn.lateral{i}", f"backbone.fpn.inner_blocks.{i}")
        conv(f"fpn.smooth{i}", f"backbone.fpn.layer_blocks.{i}")
    for lvl in ("p6", "p7"):
        conv(f"fpn.{lvl}", f"backbone.fpn.extra_blocks.{lvl}")
    for branch, tv in (("cls", "head.classification_head"), ("reg", "head.regression_head")):
        nested = f"{tv}.conv.0.0.weight" in sd
        for i in range(4):
            cw = f"{tv}.conv.{i}.0" if nested else f"{tv}.conv.{3 * i}"
            gn = f"{tv}.conv.{i}.1" if nested else f"{tv}.conv.{3 * i + 1}"
            for p in ("weight", "bias"):
                keys[f"head.{branch}{i}.{p}"] = f"{cw}.{p}"
                keys[f"head.{branch}_gn{i}.{p}"] = f"{gn}.{p}"
    for port, tv in (("cls_out", "head.classification_head.cls_logits"),
                     ("reg_out", "head.regression_head.bbox_reg"),
                     ("ctr_out", "head.regression_head.bbox_ctrness")):
        for p in ("weight", "bias"):
            keys[f"head.{port}.{p}"] = f"{tv}.{p}"
    return keys


@torch.no_grad()
def load_torch_fcos(pth_path_or_sd, detector: FCOSDetector) -> FCOSDetector:
    """Fill the port's torchvision-geometry detector (FCOSDetector with
    `torchvision_compat`, the `tv_fcos_resnet50_fpn` backbone) in place from
    a torchvision `fcos_resnet50_fpn` state dict, or a .pth holding one (or
    {"model_state_dict": ...}); returns it. The port's modules carry
    torchvision's layouts, so the weights go over as they are; torchvision's
    raw offsets times the level's stride are the port's pixel offsets, so
    nothing is rescaled. Raises on a shape mismatch and on any parameter or
    buffer left unset (BN's num_batches_tracked aside: torchvision's frozen
    BNs have none)."""
    sd = pth_path_or_sd
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=False)
        sd = sd.get("model_state_dict", sd)
    target = detector.state_dict()
    keys = _tv_fcos_keys(sd)
    done = set()
    for port, tv in keys.items():
        if port not in target:
            continue
        value = torch.as_tensor(np.asarray(sd[tv]))
        if tuple(target[port].shape) != tuple(value.shape):
            raise ValueError(f"Shape mismatch at {port} <- {tv}: "
                             f"{tuple(target[port].shape)} vs {tuple(value.shape)}")
        target[port].copy_(value)
        done.add(port)
    missing = [k for k in target if k not in done and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"not filled from the torchvision state dict: {missing[:8]}"
                       f"{' ...' if len(missing) > 8 else ''}")
    return detector


# ---------------------------------------------------------------------------
# The upstream reference's own checkpoints: its torch state dicts, read into
# the port's modules (the JAX package's load_torch_* readers). The port's
# modules carry the reference's key names, so a reader is a checked mapping:
# the keys the JAX reader skips are dropped by name (torchvision's and
# timm's classification heads, which the reference replaces by an identity;
# VGG16's convolutions past the deepest tap), a few key forms are renamed
# (`N.weight` for `features.N.weight`; the lpips package's heads), and every
# other key must be the module's, with its shape.
# ---------------------------------------------------------------------------

_VGG16_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
_LPIPS_HEAD = re.compile(r"lins?\.?(\d)\.model\.1\.weight")


def _reference_state_dict(pth_path_or_sd) -> Dict[str, torch.Tensor]:
    """A state dict of tensors from a reference `.pth` (a `torch.save` dict,
    its `model_state_dict` where it holds one; read with torch's
    weights-only loader) or from a dict of tensors or arrays."""
    sd = pth_path_or_sd
    if isinstance(sd, (str, os.PathLike)):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in sd.items()}


def _under(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `sd` under `prefix`, the prefix taken off."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _without(sd: Dict[str, torch.Tensor], prefixes) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in sd.items() if not k.startswith(tuple(prefixes))}


@torch.no_grad()
def _load_checked(module: nn.Module, sd: Dict[str, torch.Tensor], what: str,
                  optional=("num_batches_tracked",), prefix: str = "") -> nn.Module:
    """`module` filled in place from `sd`, whose keys must be the module's:
    a key the module lacks, one of the module's that `sd` lacks (those
    ending in `optional` aside, which keep the module's values) or a tensor
    of another shape raises, naming the key as the reference's dict has it
    (`prefix` + key). Returns `module`."""
    own = module.state_dict()
    surplus = sorted(prefix + k for k in set(sd) - set(own))
    missing = sorted(prefix + k for k in set(own) - set(sd) if not k.endswith(tuple(optional)))
    for keys, say in ((surplus, f"keys that the port's {type(module).__name__} lacks"),
                      (missing, "lacks the keys")):
        if keys:
            raise ValueError(f"{what}: {say} {keys[:8]}{' ...' if len(keys) > 8 else ''}")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{what}: {prefix}{k} has the shape {tuple(v.shape)}, the port's "
                             f"{tuple(own[k].shape)}")
    module.load_state_dict({**own, **sd})
    return module


def _features(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision's `features.N.*` keys, also where they come as `N.*`."""
    return {f"features.{k}" if k[:1].isdigit() else k: v for k, v in sd.items()}


def load_torch_resnet(pth_path_or_sd, resnet: ResNet) -> ResNet:
    """A torchvision ResNet's state dict (its `fc` head dropped) into the
    port's ResNet (18, 34 or 50: the module's blocks say which), in place."""
    return _load_checked(resnet, _without(_reference_state_dict(pth_path_or_sd), ("fc.",)),
                         "resnet")


def load_torch_vgg16(pth_path_or_sd, vgg: VGG16Features) -> VGG16Features:
    """torchvision VGG16's `features` weights into VGG16Features, in place:
    the convolutions it holds (up to its deepest tap); the deeper ones and
    the `classifier` head are dropped."""
    sd = _without(_features(_reference_state_dict(pth_path_or_sd)), ("classifier.",))
    own = {int(k.split(".")[1]) for k in vgg.state_dict()}
    deeper = tuple(f"features.{i}." for i in _VGG16_TORCH_CONV_IDX if i not in own)
    return _load_checked(vgg, _without(sd, deeper), "vgg16")


def load_torch_alexnet(pth_path_or_sd, net: nn.Module) -> nn.Module:
    """torchvision AlexNet's `features` weights (its `classifier` head
    dropped) into AlexNetFeatures, or into an LPIPS's trunk, in place: the
    LPIPS trunk. Returns `net`."""
    sd = _without(_features(_reference_state_dict(pth_path_or_sd)), ("classifier.",))
    _load_checked(net.net if isinstance(net, LPIPS) else net, sd, "alexnet")
    return net


def load_torch_lpips(pth_path_or_sd, lpips: LPIPS) -> LPIPS:
    """The lpips package's linear heads (`lin{i}.model.1.weight` or
    `lins.{i}.model.1.weight`, (1, C, 1, 1)) into LPIPS's `lin{i}` (C,), in
    place. The AlexNet trunk stays as it is (load_torch_alexnet fills it
    from a torchvision alexnet)."""
    heads = {}
    for k, v in _reference_state_dict(pth_path_or_sd).items():
        m = _LPIPS_HEAD.fullmatch(k)
        if m is None:
            raise ValueError(f"lpips: {k} is not a linear head (lin{{i}}.model.1.weight)")
        heads[f"lin{m.group(1)}"] = v.reshape(-1)
    trunk = {k: v for k, v in lpips.state_dict().items() if k.startswith("net.")}
    return _load_checked(lpips, {**trunk, **heads}, "lpips")


def load_torch_mobilenet_v2(pth_path_or_sd, backbone: nn.Module) -> nn.Module:
    """torchvision mobilenet_v2's state dict (its `classifier` head dropped)
    into the port's MobileNetV2, in place."""
    return _load_checked(backbone, _without(_reference_state_dict(pth_path_or_sd),
                                            ("classifier.",)), "mobilenet_v2")


def load_torch_mobilenet_v3(pth_path_or_sd, backbone: nn.Module) -> nn.Module:
    """torchvision mobilenet_v3_{small,large}'s state dict (its `classifier`
    head dropped) into the port's MobileNetV3 of that variant, in place."""
    return _load_checked(backbone, _without(_reference_state_dict(pth_path_or_sd),
                                            ("classifier.",)), "mobilenet_v3")


def load_torch_efficientnet(pth_path_or_sd, backbone: nn.Module) -> nn.Module:
    """timm's EfficientNet-B0..B3 state dict (its `classifier` head dropped)
    into the port's EfficientNet of that variant, in place. timm's BN eps
    (1e-5) is not in the state dict; the port keeps the JAX package's
    1e-3."""
    return _load_checked(backbone, _without(_reference_state_dict(pth_path_or_sd),
                                            ("classifier.",)), "efficientnet")


def load_torch_classifier(pth_path_or_sd, classifier: FogIntensityClassifier
                          ) -> FogIntensityClassifier:
    """The reference's FogIntensityClassifier state dict (`backbone.*` on
    any of the config's backbones, as the backbone readers take them; the
    head `classifier.{1,4}.*`) into the port's classifier of the same
    backbone, in place."""
    sd = _reference_state_dict(pth_path_or_sd)
    other = sorted(k for k in sd if not k.startswith(("backbone.", "classifier.")))
    if other:
        raise ValueError(f"classifier: keys neither backbone.* nor classifier.*: {other[:8]}")
    backbone = _without(_under(sd, "backbone."), ("fc.", "classifier."))
    _load_checked(classifier.backbone, backbone, "classifier", prefix="backbone.")
    _load_checked(classifier.classifier, _under(sd, "classifier."), "classifier",
                  prefix="classifier.")
    return classifier


BRANCH_KINDS = {"lightweight": LightweightDehazeModel, "low_unet": LowIntensityUNet,
                "medium": MediumIntensityDehazeModel, "corun": COrunInspiredModel,
                "high": HighIntensityDehazeModel, "dual_branch": DualBranchAttentionModel}


def branch_kind_for(level: str, model_type: str) -> str:
    """The reference branch kind of a config's (level, model_type), as the
    reference's factories map them."""
    if level == "low":
        return "lightweight" if model_type == "lightweight" else "low_unet"
    if level == "medium":
        return "corun" if model_type == "corun" else "medium"
    return "dual_branch" if model_type == "dual_branch" else "high"


def load_torch_branch(pth_path_or_sd, kind: str, model: nn.Module) -> nn.Module:
    """A reference branch model's state dict of `kind` (BRANCH_KINDS) into
    the port's branch of that kind, in place. The lightweight branch's
    `skip_alpha` may be absent (the JAX reader reads it where it is)."""
    if not isinstance(model, BRANCH_KINDS[kind]):
        raise ValueError(f"a {kind} branch's weights do not fill a {type(model).__name__}")
    return _load_checked(model, _reference_state_dict(pth_path_or_sd), f"{kind} branch",
                         optional=("num_batches_tracked", "skip_alpha"))


def load_torch_gate(pth_path_or_sd, router: GatedRouter) -> GatedRouter:
    """The reference GatedRouter's gate MLP (`gate_network.{0,3,5}` of its
    router state dict; the rest of that dict holds the classifier and the
    branches, which their own state dicts fill) into the port's gate, in
    place."""
    gate = _under(_reference_state_dict(pth_path_or_sd), "gate_network.")
    _load_checked(router.gate_network, gate, "gate")
    return router


def load_torch_joint(pth_path_or_ckpt, router: nn.Module, config) -> nn.Module:
    """The reference's joint checkpoint ({router, low_model, medium_model,
    high_model, classifier}_state_dict) into the port's `create_router`
    module of `config`, in place: the classifier, each branch of its
    config's model type, and a gated router's gate. The optimizer state is
    not read (the JAX reader ignores it too). Returns `router`."""
    ckpt = pth_path_or_ckpt
    if isinstance(ckpt, (str, os.PathLike)):
        ckpt = torch.load(ckpt, map_location="cpu", weights_only=True)

    def part(name):
        if name not in ckpt:
            raise ValueError(f"the joint checkpoint lacks {name} (it has {sorted(ckpt)})")
        return ckpt[name]

    load_torch_classifier(part("classifier_state_dict"), router.classifier)
    for level in INTENSITY_ORDER:
        load_torch_branch(part(f"{level}_model_state_dict"),
                          branch_kind_for(level, config["dehazing"][level]["model_type"]),
                          router.models[level])
    if config["routing"]["type"] == "gated":
        load_torch_gate(part("router_state_dict"), router)
    return router
