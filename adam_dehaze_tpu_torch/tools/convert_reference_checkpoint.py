"""Convert the upstream reference's PyTorch checkpoints into the port's.

    python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint \\
        --kind resnet18|resnet34|resnet50|vgg16|lpips|alexnet|fcos \\
        --pth PATH --out OUT
    python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint \\
        --kind classifier --pth classifier/best_model.pth --out converted/classifier
    python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint \\
        --kind branch --level medium --pth dehazing/medium/best_model.pth \\
        --out experiments/E/checkpoints/medium/best_model [--config cfg.yaml]
    python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint \\
        --kind joint --pth joint/best_model.pth \\
        --out experiments/E/checkpoints/joint/best_model [--config cfg.yaml]

The counterpart of tools/convert_reference_checkpoint.py, with its `--kind`
choices: the reference's `.pth` (a `torch.save` dict, with
`model_state_dict` where it has one; the joint checkpoint's five state
dicts) goes through training/checkpoint.py's readers into the port's
module and is written by `save_checkpoint` as `OUT.pth`, which the port's
config keys read as they are:

- classifier (the config's `classifier.model`) and resnet18/34/50 (a
  backbone alone): `classifier.pretrained`;
- vgg16: `loss.vgg_weights`; lpips (the linear heads) and alexnet (the
  trunk), each into an LPIPS net (the rest of it seeded): `loss.lpips_weights`;
- fcos (torchvision's fcos_resnet50_fpn): `detection.pretrained` with
  `detection.model: tv_fcos_resnet50_fpn`;
- branch (`--level`, its config's `model_type`): the dehazing trainer's
  `{dehazing.checkpoint_dir}/{level}/best_model.pth`;
- joint: the joint best (`{joint_training.checkpoint_dir}/best_model.pth`)
  that evaluation and serving load (evaluation/evaluate.py:_load_joint).

`--config` is the config the classifier, branch and joint kinds are built
from (the package's default.yaml without it). The conversion moves
tensors on the host; no device is used.
"""
from __future__ import annotations

import argparse
import os

import torch

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.losses.lpips import LPIPS
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.detection import FCOSDetector
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.nn.resnet import resnet18, resnet34, resnet50
from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
from adam_dehaze_tpu_torch.training import checkpoint as ckpt

KINDS = ("resnet18", "resnet34", "resnet50", "vgg16", "lpips", "alexnet", "classifier",
         "branch", "joint", "fcos")
_RESNETS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


def convert(kind: str, pth: str, config=None, level=None):
    """The port's checkpoint tree of the reference's `pth` of `kind`:
    {"model": state dict} for the modules the trainers and serving load,
    {"state_dict": state dict} for the loss nets."""
    seeded = torch.Generator().manual_seed(0)
    if kind in _RESNETS:
        return {"model": ckpt.load_torch_resnet(pth, _RESNETS[kind]()).state_dict()}
    if kind == "vgg16":
        return {"state_dict": ckpt.load_torch_vgg16(pth, VGG16Features()).state_dict()}
    if kind in ("lpips", "alexnet"):
        read = ckpt.load_torch_lpips if kind == "lpips" else ckpt.load_torch_alexnet
        return {"state_dict": read(pth, init_params_(LPIPS(), seeded)).state_dict()}
    if kind == "fcos":
        detector = FCOSDetector(num_classes=91, backbone_name="tv_fcos_resnet50_fpn",
                                channels=256, torchvision_compat=True)
        return {"model": ckpt.load_torch_fcos(pth, detector).state_dict()}
    if kind == "classifier":
        return {"model": ckpt.load_torch_classifier(pth, create_classifier(config)).state_dict()}
    if kind == "branch":
        model = create_branch_models(config)[level]
        kind_of = ckpt.branch_kind_for(level, config["dehazing"][level]["model_type"])
        return {"model": ckpt.load_torch_branch(pth, kind_of, model).state_dict()}
    router = create_router(create_branch_models(config), create_classifier(config), config)
    return {"model": ckpt.load_torch_joint(pth, router, config).state_dict()}


def parser() -> argparse.ArgumentParser:
    """The command line: the JAX tool's flags (tools/convert_reference_checkpoint.py)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", required=True, choices=KINDS)
    p.add_argument("--pth", required=True, help="the reference's .pth")
    p.add_argument("--out", required=True, help="the port's checkpoint, written as OUT.pth")
    p.add_argument("--config", default=None,
                   help="config YAML of the classifier, branch and joint kinds")
    p.add_argument("--level", default=None, choices=["low", "medium", "high"],
                   help="the branch's level, for --kind branch")
    p.add_argument("--image_size", type=int, default=64,
                   help="accepted and ignored: the JAX tool's resolution for a dummy init, "
                        "which a PyTorch module does not need")
    return p


def main(argv=None) -> str:
    p = parser()
    args = p.parse_args(argv)
    if args.kind == "branch" and not args.level:
        p.error("--kind branch requires --level")
    tree = convert(args.kind, args.pth, load_config(args.config), args.level)
    out = os.path.abspath(args.out)
    path = ckpt.save_checkpoint(os.path.dirname(out), os.path.basename(out), tree,
                                {"source": 0.0})
    print(f"Converted {args.kind} weights from {args.pth} -> {path}")
    return path


if __name__ == "__main__":
    main()
