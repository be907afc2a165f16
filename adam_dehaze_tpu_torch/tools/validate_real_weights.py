"""Day-one validation of the upstream reference's checkpoints: convert,
restore in a fresh process, check the forward, run a tiny evaluation, in
one command with one PASS/FAIL JSON line.

    python -m adam_dehaze_tpu_torch.tools.validate_real_weights --kind classifier --pth best.pth
    python -m adam_dehaze_tpu_torch.tools.validate_real_weights --kind branch --level medium \\
        --pth medium/best_model.pth
    python -m adam_dehaze_tpu_torch.tools.validate_real_weights --kind joint --pth joint/best.pth
    python -m adam_dehaze_tpu_torch.tools.validate_real_weights --kind fcos --pth fcos_coco.pth
    python -m adam_dehaze_tpu_torch.tools.validate_real_weights --kind joint --selftest \\
        [--config CFG] [--workdir DIR] [--atol 1e-4] [--device cpu]

The counterpart of tools/validate_real_weights.py, with its kinds, flags
and fixed input (2 x 64^2 x 3 from numpy's default_rng(7)). The stages:

1. record: `--selftest` first writes a `.pth` in the reference's layout
   from the port's own modules (seeded weights, BN scales, shifts and
   running statistics drawn at random; the dict layout of the reference's
   train_joint.py:272-283: `model_state_dict`, or the joint's
   `{router,classifier,low_model,medium_model,high_model}_state_dict` with
   an empty optimizer state; for fcos a synthetic state dict of
   torchvision's fcos_resnet50_fpn layout). The JAX tool records its
   forward with the upstream reference's own modules; the port's modules
   carry the reference's key names, so the port records it from its own
   module of the config, built on the CPU in fp32 and loaded from the
   `.pth` with `load_state_dict(strict=True)`: a missing or a surplus key
   fails here. (fcos records nothing: layout only, as in the JAX tool.)
2. convert: `python -m adam_dehaze_tpu_torch.tools.convert_reference_checkpoint`
   in a subprocess, as a user runs it.
3. restore: a fresh process on `--device` (the card unless `--device cpu`)
   reads the converted checkpoint into a new module (`load_checkpoint`,
   strict), runs the same input in fp32 with TF32 off, and diffs every
   recorded output; for joint it also dehazes 6 synthetic fog triplets
   (`data/synthetic.py:apply_random_fog`, intensities 0, 1, 2, 0, 1, 2)
   through the router's forward and reports the mean PSNR of the dehazed
   and of the hazy images against the clear ones (`ops/image.py:psnr`);
   for fcos it checks that every level's outputs are finite.

Prints one JSON line with the JAX tool's keys (`forward_max_abs_diff` per
output against `atol`, `parity` "forward_numeric" or "layout_only"), plus
`device` and `launches` (the kernels the restore launched, by name) from
the restore. A stage that fails prints `ok: false` with the stage and its
error; the exit code is 1 on any failure, 0 when every diff is within
`--atol` (fcos: finite outputs).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER

KINDS = ("classifier", "branch", "joint", "fcos")
# The repository root: the subprocesses import the package from it.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FCOS_KW = dict(num_classes=91, backbone_name="tv_fcos_resnet50_fpn", channels=256,
               torchvision_compat=True)
RESULT = "RESTORE_RESULT "


def fp32_config(path):
    """The config of `path` (the package's default.yaml for None) in fp32."""
    from adam_dehaze_tpu_torch.config import load_config
    config = load_config(path or None)
    config["cuda"]["compute_dtype"] = "float32"
    return config


def build_module(kind: str, level: str, config) -> torch.nn.Module:
    """The port's module of `kind` for the config, on the CPU."""
    from adam_dehaze_tpu_torch.models.branches import create_branch_models
    from adam_dehaze_tpu_torch.models.classifier import create_classifier
    from adam_dehaze_tpu_torch.models.detection import FCOSDetector
    from adam_dehaze_tpu_torch.models.routing import create_router
    if kind == "classifier":
        return create_classifier(config)
    if kind == "branch":
        return create_branch_models(config)[level]
    if kind == "joint":
        return create_router(create_branch_models(config), create_classifier(config), config)
    return FCOSDetector(**FCOS_KW)


@torch.no_grad()
def randomized_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Seeded weights (`init_params_`), then every BatchNorm's scale, shift
    and running statistics drawn at random, so that the forward reads them
    all."""
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    init_params_(module, generator)
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.copy_(1.0 + 0.1 * torch.randn(m.num_features, generator=generator))
            m.bias.copy_(0.1 * torch.randn(m.num_features, generator=generator))
            m.running_mean.copy_(0.1 * torch.randn(m.num_features, generator=generator))
            m.running_var.copy_(0.5 + torch.rand(m.num_features, generator=generator))
    return module


def tv_fcos_state_dict(rng: np.random.Generator) -> dict:
    """Random values in torchvision fcos_resnet50_fpn's key layout and
    shapes (its nested `.0` form): what `--kind fcos` reads."""
    sd = {}

    def add(name, *shape):
        sd[name] = rng.standard_normal(shape, dtype=np.float32) * 0.05

    def add_bn(prefix, c):
        for field in ("weight", "bias", "running_mean"):
            add(f"{prefix}.{field}", c)
        sd[f"{prefix}.running_var"] = np.abs(rng.standard_normal(c, dtype=np.float32)) + 1.0

    add("backbone.body.conv1.weight", 64, 3, 7, 7)
    add_bn("backbone.body.bn1", 64)
    cin = 64
    for li, n_blocks in enumerate((3, 4, 6, 3), start=1):
        mid = 64 * 2 ** (li - 1)
        for b in range(n_blocks):
            tp = f"backbone.body.layer{li}.{b}"
            for i, (cout, k_in, k) in enumerate(((mid, cin, 1), (mid, mid, 3),
                                                  (mid * 4, mid, 1)), start=1):
                add(f"{tp}.conv{i}.weight", cout, k_in, k, k)
                add_bn(f"{tp}.bn{i}", cout)
            if b == 0:
                add(f"{tp}.downsample.0.weight", mid * 4, cin, 1, 1)
                add_bn(f"{tp}.downsample.1", mid * 4)
            cin = mid * 4
    for i, c in enumerate((512, 1024, 2048)):
        add(f"backbone.fpn.inner_blocks.{i}.0.weight", 256, c, 1, 1)
        add(f"backbone.fpn.inner_blocks.{i}.0.bias", 256)
        add(f"backbone.fpn.layer_blocks.{i}.0.weight", 256, 256, 3, 3)
        add(f"backbone.fpn.layer_blocks.{i}.0.bias", 256)
    for lvl in ("p6", "p7"):
        add(f"backbone.fpn.extra_blocks.{lvl}.weight", 256, 256, 3, 3)
        add(f"backbone.fpn.extra_blocks.{lvl}.bias", 256)
    for head in ("classification_head", "regression_head"):
        for i in range(4):
            add(f"head.{head}.conv.{i}.0.weight", 256, 256, 3, 3)
            add(f"head.{head}.conv.{i}.0.bias", 256)
            add(f"head.{head}.conv.{i}.1.weight", 256)
            add(f"head.{head}.conv.{i}.1.bias", 256)
    for name, cout in (("classification_head.cls_logits", 91), ("regression_head.bbox_reg", 4),
                       ("regression_head.bbox_ctrness", 1)):
        add(f"head.{name}.weight", cout, 256, 3, 3)
        add(f"head.{name}.bias", cout)
    return sd


def reference_layout(kind: str, module: torch.nn.Module) -> dict:
    """The `.pth` dict that the reference saves for `module`."""
    sd = module.state_dict()
    if kind != "joint":
        return {"model_state_dict": sd}

    def under(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    return {"router_state_dict": sd, "classifier_state_dict": under("classifier."),
            **{f"{lvl}_model_state_dict": under(f"models.{lvl}.") for lvl in INTENSITY_ORDER},
            "optimizer_state_dict": {"state": {}, "param_groups": []}, "epoch": 0}


def build_selftest_pth(kind: str, level: str, config, workdir: str) -> str:
    """A reference-layout `.pth` of `kind` with seeded random weights."""
    pth = os.path.join(workdir, f"{kind}_selftest.pth")
    if kind == "fcos":
        sd = tv_fcos_state_dict(np.random.default_rng(3))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pth)
    else:
        module = randomized_(build_module(kind, level, config), torch.Generator().manual_seed(5))
        torch.save(reference_layout(kind, module), pth)
    return pth


@torch.no_grad()
def record_forward(kind: str, level: str, config, pth: str, x: np.ndarray) -> dict:
    """The port's fp32 CPU forward of `x` through its module of `kind`,
    loaded strictly from the reference-layout `.pth`: {output: array}
    ({} for fcos)."""
    if kind == "fcos":
        return {}
    ck = torch.load(pth, map_location="cpu", weights_only=True)
    module = build_module(kind, level, config)
    xt = torch.from_numpy(x)
    if kind == "classifier":
        module.load_state_dict(ck.get("model_state_dict", ck))
        return {"logits": module.eval()(xt)[0].numpy()}
    if kind == "branch":
        module.load_state_dict(ck.get("model_state_dict", ck))
        return {"out": module.eval()(xt).numpy()}
    module.classifier.load_state_dict(ck["classifier_state_dict"])
    recorded = {"classifier_logits": module.classifier.eval()(xt)[0].numpy()}
    for lvl in INTENSITY_ORDER:
        module.models[lvl].load_state_dict(ck[f"{lvl}_model_state_dict"])
        recorded[f"{lvl}_out"] = module.models[lvl].eval()(xt).numpy()
    return recorded


def _max_diff(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.float().cpu().numpy() - want).max())


@torch.no_grad()
def restore(kind: str, level: str, converted: str, config_path: str, npz: str,
            device: str) -> dict:
    """The restore stage, run in a fresh process: the converted checkpoint
    into a new module on `device`, fp32, TF32 off; the recorded outputs
    diffed, the joint's tiny evaluation, the fcos levels checked finite.
    Returns the stage's fields, the diffs under "diffs"."""
    from adam_dehaze_tpu_torch.ops.image import psnr
    from adam_dehaze_tpu_torch.ops.kernels import launch_counters, reset_launch_counts
    from adam_dehaze_tpu_torch.training.checkpoint import load_checkpoint

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    config = fp32_config(config_path)
    module = build_module(kind, level, config)
    module.load_state_dict(load_checkpoint(converted)[0]["model"])
    module = module.to(dev).eval()
    data = np.load(npz)
    x = torch.from_numpy(data["x"]).to(dev)
    diffs, out = {}, {}
    reset_launch_counts()
    if kind == "classifier":
        diffs["logits"] = _max_diff(module(x)[0], data["logits"])
    elif kind == "branch":
        diffs["out"] = _max_diff(module(x), data["out"])
    elif kind == "joint":
        diffs["classifier_logits"] = _max_diff(module.classifier(x)[0],
                                               data["classifier_logits"])
        for lvl in INTENSITY_ORDER:
            diffs[f"{lvl}_out"] = _max_diff(module.models[lvl](x), data[f"{lvl}_out"])
        from adam_dehaze_tpu_torch.data.synthetic import apply_random_fog
        gen = torch.Generator(dev).manual_seed(0)
        clear = torch.rand((6, *x.shape[1:]), generator=gen, device=dev)
        hazy = apply_random_fog(gen, clear, torch.tensor([0, 1, 2, 0, 1, 2], device=dev))
        dehazed, _ = module(hazy)
        out["eval_psnr_dehazed"] = float(psnr(dehazed.float(), clear).mean())
        out["eval_psnr_hazy"] = float(psnr(hazy, clear).mean())
    else:
        levels = module(torch.zeros(1, 128, 128, 3, device=dev))
        out["n_levels"] = len(levels)
        out["finite"] = all(bool(torch.isfinite(lv[k]).all()) for lv in levels
                            for k in ("logits", "offsets", "centerness"))
        if not out["finite"]:
            out["error"] = "non-finite detector outputs"
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out["launches"] = {k: fn.launches for k, fn in launch_counters().items() if fn.launches}
    out["diffs"] = diffs
    return out


_RESTORE = ("import json, sys; "
            "from adam_dehaze_tpu_torch.tools.validate_real_weights import RESULT, restore; "
            "print(RESULT + json.dumps(restore(*sys.argv[1:])))")


def _subprocess(argv):
    """Run `argv` with the repository importable; (returncode, stdout,
    stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    r = subprocess.run(argv, capture_output=True, text=True, env=env)
    return r.returncode, r.stdout, r.stderr


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--kind", required=True, choices=list(KINDS))
    p.add_argument("--level", default="medium", choices=list(INTENSITY_ORDER))
    p.add_argument("--pth", default=None, help="the reference's .pth")
    p.add_argument("--selftest", action="store_true",
                   help="write a reference-layout .pth from the port's modules (seeded "
                        "random weights) and validate that")
    p.add_argument("--config", default=None)
    p.add_argument("--workdir", default=None)
    p.add_argument("--atol", type=float, default=1e-4)
    p.add_argument("--device", default="cuda", help="where the restore runs: cuda or cpu")
    return p


def validate(argv=None) -> dict:
    """The stages of the command line `argv`; returns the JSON line's
    fields."""
    p = parser()
    args = p.parse_args(argv)
    if not args.pth and not args.selftest:
        p.error("need --pth (real weights) or --selftest")
    config = fp32_config(args.config)
    workdir = args.workdir or tempfile.mkdtemp(prefix="validate_weights_")
    os.makedirs(workdir, exist_ok=True)
    x = np.random.default_rng(7).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)

    def failed(stage, error):
        return {"kind": args.kind, "ok": False, "stage": stage, "error": error[-800:]}

    pth = (build_selftest_pth(args.kind, args.level, config, workdir) if args.selftest
           else args.pth)
    try:
        recorded = record_forward(args.kind, args.level, config, pth, x)
    except (RuntimeError, KeyError) as e:     # a missing, surplus or mis-shaped key
        return failed("record", f"{type(e).__name__}: {e}")

    out = os.path.join(workdir, f"{args.kind}_converted")
    cmd = [sys.executable, "-m", "adam_dehaze_tpu_torch.tools.convert_reference_checkpoint",
           "--kind", args.kind, "--pth", pth, "--out", out]
    if args.kind == "branch":
        cmd += ["--level", args.level]
    if args.config:
        cmd += ["--config", args.config]
    rc, _, err = _subprocess(cmd)
    if rc != 0:
        return failed("convert", err)
    converted = out + ".pth"

    npz = os.path.join(workdir, "recorded.npz")
    np.savez(npz, x=x, **recorded)
    rc, stdout, err = _subprocess([sys.executable, "-c", _RESTORE, args.kind, args.level,
                                   converted, args.config or "", npz, args.device])
    line = next((ln for ln in stdout.splitlines() if ln.startswith(RESULT)), None)
    if rc != 0 or line is None:
        return failed("restore", err or stdout)
    res = json.loads(line[len(RESULT):])
    diffs = res.pop("diffs")
    ok = (bool(res.get("finite", False)) if args.kind == "fcos"
          else all(d <= args.atol for d in diffs.values()))
    return {"kind": args.kind, "pth": pth, "converted": converted, "ok": ok,
            "mode": "selftest" if args.selftest else "real",
            "parity": "layout_only" if args.kind == "fcos" else "forward_numeric",
            "atol": args.atol, "forward_max_abs_diff": diffs, **res}


def main(argv=None) -> int:
    line = validate(argv)
    print(json.dumps(line))
    return 0 if line["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
