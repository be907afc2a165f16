"""Graft a retrained classifier into an experiment's joint checkpoint.

    python -m adam_dehaze_tpu_torch.tools.graft_classifier --experiment E
        [--classifier_dir D]

The counterpart of tools/graft_classifier.py. Serving and evaluation load
only the joint best (`{joint_training.checkpoint_dir}/best_model.pth`,
evaluation/evaluate.py:_load_joint), which holds the classifier beside the
branches and the gate. This swaps the classifier's best
(`{classifier.checkpoint_dir}/best_model.pth`, or D's) into it and saves it
again; the branches, the gate and the optimizer state stay bit for bit.

The JAX tool zeroes the classifier's slots of the joint Adam moments (the
JAX joint step keeps the frozen classifier in its optimizer, its gradients
masked). The port's joint trainer leaves the classifier out of its
optimizer (training/train_joint.py:build_router_state), so the joint Adam
holds no classifier slot to zero: the tool checks that the saved
optimizer's parameters are the router's other ones, and refuses a joint
checkpoint whose optimizer holds more. Tensors move on the host; no device
is used.
"""
from __future__ import annotations

import argparse
import os

from adam_dehaze_tpu_torch.config import load_config, update_checkpoint_paths
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.training import checkpoint as ckpt

PREFIX = "classifier."


def graft(joint: dict, classifier: dict, config) -> dict:
    """The joint checkpoint tree `joint` with its classifier's entries
    replaced by `classifier` (a classifier's state dict); raises where the
    keys or shapes differ, or where the joint optimizer holds classifier
    slots."""
    model = dict(joint["model"])
    own = {k[len(PREFIX):]: v for k, v in model.items() if k.startswith(PREFIX)}
    if set(own) != set(classifier):
        raise ValueError(f"the classifier's keys are not the joint checkpoint's: "
                         f"{sorted(set(own) ^ set(classifier))[:8]}")
    for k, v in classifier.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{PREFIX}{k}: shape {tuple(v.shape)}, the joint checkpoint's "
                             f"{tuple(own[k].shape)}")
        model[PREFIX + k] = v
    if "optimizer" in joint:
        router = create_router(create_branch_models(config), create_classifier(config), config)
        others = sum(1 for n, _ in router.named_parameters() if not n.startswith(PREFIX))
        held = sum(len(g["params"]) for g in joint["optimizer"]["param_groups"])
        if held != others:
            raise ValueError(f"the joint optimizer holds {held} parameters, the router "
                             f"{others} besides its classifier: it may hold classifier slots, "
                             "which this tool does not rewrite")
    return dict(joint, model=model)


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--experiment", required=True)
    p.add_argument("--classifier_dir", default=None)
    args = p.parse_args(argv)
    config = update_checkpoint_paths(
        load_config(os.path.join(args.experiment, "config.yaml")), args.experiment)
    clf_best = ckpt.best_model_path(args.classifier_dir or config["classifier"]["checkpoint_dir"])
    joint_dir = config["joint_training"]["checkpoint_dir"]
    joint_best = ckpt.best_model_path(joint_dir)
    for path, what in ((clf_best, "classifier"), (joint_best, "joint")):
        if not os.path.exists(path):
            raise SystemExit(f"no {what} best_model at {path}")
    classifier, meta = ckpt.load_checkpoint(clf_best)
    print(f"classifier best: {clf_best} (val_acc {meta.get('val_acc', 'n/a')})")
    tree = graft(ckpt.load_checkpoint(joint_best)[0], classifier["model"], config)
    path = ckpt.save_checkpoint(joint_dir, "best_model", tree, {"grafted_classifier": 1.0})
    print(f"grafted classifier into {path}")
    return path


if __name__ == "__main__":
    main()
