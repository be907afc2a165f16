"""Command-line interface of the port.

The JAX package's surface (adam_dehaze_tpu/cli.py), with the same options,
defaults and choices:

  python3 main_torch.py --mode {preprocess, train_classifier, train_dehazing,
                                train_joint, train_all, train_detection,
                                evaluate, demo, serve, export, bench}
       [--config PATH] [--exp_name NAME] [--data_dir DIR] [--device DEV]
       [--resume] [--seed N] [--batch_size N] [--experiment_dir DIR]
       [--serve_mode soft|hard|spill|spill_up|stream|queued|device]
       [--queue_bucket N] [--max_wait_batches W] [--out DIR] [--detect]
       [--lowres high[,medium] | auto] [--precompiled DIR | auto]

Everything runs on the card (the config's `device`, "cuda" by default);
`--device cpu` runs on the CPU. Without a card and without `--device cpu`
the command stops at once. `--mode export` writes a precompiled serving
bundle (serving_export.py) and `serve --precompiled` serves through one.
`--mode bench` runs the port's benchmark (adam_dehaze_tpu_torch/bench.py)
and nothing else: `--device` and `--batch_size` go to it as its `--device`
and `--batch`, and the options that this parser does not know (`--full`,
`--size`, `--iters`, `--warmup`) as they are; its JSON line is the last
line printed.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from pathlib import Path

import numpy as np
import torch

from adam_dehaze_tpu_torch.config import (
    apply_cli_overrides,
    compute_dtype,
    create_experiment_dir,
    load_config,
    update_checkpoint_paths,
)
from adam_dehaze_tpu_torch.utils.helpers import seed_everything

MODES = ("preprocess", "train_classifier", "train_dehazing", "train_joint",
         "train_all", "train_detection", "evaluate", "demo", "serve",
         "export", "bench")

SERVE_MODES = ("soft", "hard", "spill", "spill_up", "stream", "queued",
               "device")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Adaptive Fog Intensity Dehazing Framework (PyTorch/CUDA port)")
    p.add_argument("--config", type=str, default=None,
                   help="Path to config file (defaults bundled)")
    p.add_argument("--mode", type=str, default="train_all", choices=MODES)
    p.add_argument("--exp_name", type=str, default=None)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--device", type=str, default=None,
                   help="cuda (the config's default) or cpu")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--experiment_dir", type=str, default=None,
                   help="Existing experiment to evaluate / resume")
    p.add_argument("--serve_mode", type=str, default="hard", choices=SERVE_MODES,
                   help="serve: which serving route dehazes the inputs "
                        "(serving.py AdaptiveDehazer)")
    p.add_argument("--queue_bucket", type=int, default=16,
                   help="serve --serve_mode queued: same-class bucket size")
    p.add_argument("--max_wait_batches", type=int, default=None,
                   help="serve --serve_mode queued: the most batches an image "
                        "waits before a partial bucket dispatches")
    p.add_argument("--out", type=str, default=None,
                   help="serve: output dir (default <experiment>/served)")
    p.add_argument("--detect", action="store_true",
                   help="serve: run the trained detector on the dehazed outputs "
                        "and write detections.json (boxes/scores/labels per image)")
    p.add_argument("--precompiled", type=str, default=None,
                   help="serve: precompiled serving bundle dir, or 'auto' "
                        "for <experiment_dir>/precompiled; export: output "
                        "dir (default <experiment_dir>/precompiled)")
    p.add_argument("--lowres", type=str, default="",
                   help="serve hard/spill/stream: comma-separated branch "
                        "levels (low,medium,high) to run at half resolution "
                        "with a guided-filter lift of the correction "
                        "(ops/resolution.py), or 'auto' for the experiment's "
                        "tuned policy (tools/autotune_resolution.py)")
    return p


def parse_args(argv=None):
    return _parser().parse_args(argv)


def main(argv=None):
    parser = _parser()
    args, rest = parser.parse_known_args(argv)
    if args.mode == "bench":
        from adam_dehaze_tpu_torch import bench
        return bench.main(rest + (["--device", args.device] if args.device else [])
                          + (["--batch", str(args.batch_size)] if args.batch_size else []))
    if rest:
        parser.error(f"unrecognized arguments: {' '.join(rest)}")
    cfg_path = args.config
    if cfg_path is None and args.experiment_dir:
        # An existing experiment without --config: its own config, whose
        # model sizes match its checkpoints.
        cand = os.path.join(args.experiment_dir, "config.yaml")
        if os.path.exists(cand):
            cfg_path = cand
    config = apply_cli_overrides(load_config(cfg_path), args)
    device = torch.device(str(config.get("device") or "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"device {device} asked for, but no CUDA card is visible: "
                         "run on a machine with a card, or pass --device cpu")

    if args.experiment_dir:
        config = update_checkpoint_paths(config, args.experiment_dir)
        exp_dir = args.experiment_dir
    else:
        exp_dir, config = create_experiment_dir(config, args.exp_name)
    print(f"Experiment directory: {exp_dir}")
    seed_everything(config["seed"])
    print(f"Random seed set to {config['seed']}")

    if args.mode == "preprocess":
        from adam_dehaze_tpu_torch.data.preprocessing import preprocess_dataset, split_dataset
        data_dir = Path(config["dataset"]["train_path"]).parent
        processed_dir = os.path.join(data_dir, "processed")
        n = preprocess_dataset(os.path.join(data_dir, "raw"), processed_dir,
                               size=config["dataset"]["img_size"])
        counts = split_dataset(processed_dir, seed=config["seed"])
        print(f"Preprocessed {n} triplets; split: {counts}")

    elif args.mode == "train_classifier":
        from adam_dehaze_tpu_torch.training.train_classifier import (
            evaluate_classifier,
            train_classifier,
        )
        model, state = train_classifier(config, resume=args.resume, device=device)
        evaluate_classifier(model, state, config)

    elif args.mode == "train_dehazing":
        from adam_dehaze_tpu_torch.training.train_dehazing import (
            evaluate_dehazing_model,
            train_all_dehazing_models,
        )
        models = train_all_dehazing_models(config, resume=args.resume, device=device)
        for level, (model, state) in models.items():
            print(f"Evaluating {level} intensity model...")
            evaluate_dehazing_model(model, state, level, config)

    elif args.mode == "train_joint":
        from adam_dehaze_tpu_torch.training.train_joint import (
            evaluate_joint_model,
            train_joint_model,
        )
        router, state = train_joint_model(config, resume=args.resume, device=device)
        evaluate_joint_model(router, state, config)

    elif args.mode == "train_all":
        run_train_all(config, args.resume, device)

    elif args.mode == "train_detection":
        from adam_dehaze_tpu_torch.training.train_detection import train_detection
        train_detection(config, epochs=config["detection"].get("epochs", 1),
                        resume=args.resume, img_size=config["dataset"]["img_size"],
                        device=device)

    elif args.mode == "evaluate":
        from adam_dehaze_tpu_torch.evaluation.evaluate import run_comprehensive_evaluation
        run_comprehensive_evaluation(config, device=device)

    elif args.mode == "demo":
        run_demo(config, exp_dir, device=device)

    elif args.mode == "serve":
        run_serve(config, exp_dir, args, device=device)

    elif args.mode == "export":
        run_export(config, exp_dir, args, device=device)

    print(f"All tasks completed successfully! Results are available in: {exp_dir}")


def run_train_all(config, resume: bool, device):
    """Classifier, the three branches, the adaptive evaluation of the
    grafted stage checkpoints (pre_joint_adaptive.json), the joint
    trainer, then run_comprehensive_evaluation."""
    from adam_dehaze_tpu_torch.evaluation.evaluate import (
        evaluate_joint_model,
        run_comprehensive_evaluation,
    )
    from adam_dehaze_tpu_torch.training.train_classifier import (
        evaluate_classifier,
        train_classifier,
    )
    from adam_dehaze_tpu_torch.training.train_dehazing import train_all_dehazing_models
    from adam_dehaze_tpu_torch.training.train_joint import build_router_state, train_joint_model

    print("\n===== Step 1: Training Fog Intensity Classifier =====")
    model, state = train_classifier(config, resume=resume, device=device)
    evaluate_classifier(model, state, config)
    print("\n===== Step 2: Training Dehazing Models =====")
    train_all_dehazing_models(config, resume=resume, device=device)

    # The stage checkpoints before joint fine-tuning, so that the joint
    # stage's contribution is a measured row.
    print("\n===== Step 2b: Adaptive Eval (pre-joint) =====")
    pre_router, _ = build_router_state(config, device,
                                       torch.Generator().manual_seed(config["seed"]))
    pre_joint = evaluate_joint_model(config, pre_router, device)
    del pre_router
    results_dir = config["evaluation"]["results_dir"]
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "pre_joint_adaptive.json"), "w") as f:
        json.dump(pre_joint, f, indent=2)

    print("\n===== Step 3: Training Joint Model =====")
    router, _ = train_joint_model(config, resume=resume, device=device)
    print("\n===== Step 4: Comprehensive Evaluation =====")
    run_comprehensive_evaluation(config, router, device)


def run_demo(config, exp_dir: str, max_batches: int = 2, device="cuda"):
    """The router on the first `max_batches` test batches: comparison
    grids and routing weights in <exp_dir>/demo/."""
    from adam_dehaze_tpu_torch.data.dataset import get_dataloader
    from adam_dehaze_tpu_torch.evaluation.evaluate import _dehaze_fn, _load_joint
    from adam_dehaze_tpu_torch.utils import visualize

    device = torch.device(device)
    demo_dir = os.path.join(exp_dir, "demo")
    os.makedirs(demo_dir, exist_ok=True)
    dehaze = _dehaze_fn(_load_joint(config, device), compute_dtype(config))
    for bi, batch in enumerate(get_dataloader(config, "test")):
        if bi >= max_batches:
            break
        dehazed, info = dehaze(torch.from_numpy(batch["hazy"]).to(device))
        k = min(4, dehazed.shape[0])
        visualize.visualize_comparison(
            batch["hazy"][:k], dehazed[:k].cpu().numpy(), batch["clear"][:k],
            os.path.join(demo_dir, f"demo_batch{bi}.png"))
        weights = info.get("weights")
        if weights is None:
            weights = info.get("gate_weights")
        if weights is not None:
            visualize.visualize_routing_weights(
                weights[:k].float().cpu().numpy(),
                os.path.join(demo_dir, f"demo_weights{bi}.png"))
    print(f"Demo completed. Results saved to: {demo_dir}")


def serve_inputs(config, data_dir=None):
    """The images `serve` reads: every .png/.jpg/.jpeg under data_dir
    (recursive), else the config's test split's hazy images; sorted."""
    if data_dir:
        return sorted(f for ext in ("png", "jpg", "jpeg")
                      for f in glob.glob(os.path.join(data_dir, "**", f"*.{ext}"),
                                         recursive=True))
    return sorted(glob.glob(os.path.join(config["dataset"]["test_path"], "test", "*",
                                         "hazy", "*.png")))


def run_serve(config, exp_dir: str, args, device="cuda"):
    """Dehaze a directory of images through one serving route of the
    port's AdaptiveDehazer and write <out>/<basename> PNGs and
    <out>/routing.json ({filename: {intensity, branch}} for the hard
    routes); with --detect also <out>/detections.json from the trained
    detector on the dehazed images.

      python3 main_torch.py --mode serve --experiment_dir experiments/X \\
          [--data_dir DIR] [--serve_mode hard|spill|spill_up|stream|queued|device|soft]
          [--queue_bucket N] [--max_wait_batches W] [--out DIR] [--detect]
          [--lowres high[,medium] | auto] [--precompiled DIR | auto]

    --lowres serves the named branches at half resolution (hard, spill,
    spill_up and stream only); "auto" reads <exp_dir>/resolution_policy.json.
    --precompiled serves through a bundle of `--mode export` ("auto":
    <exp_dir>/precompiled when it exists).
    """
    from adam_dehaze_tpu_torch.data.dataset import _imread_rgb
    from adam_dehaze_tpu_torch.data.preprocessing import _write_rgb
    from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
    from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    device = torch.device(device)
    files = serve_inputs(config, args.data_dir)
    if not files:
        raise SystemExit("serve: no input images found (give --data_dir or "
                         "point dataset.test_path at a corpus)")
    img_size = config["dataset"]["img_size"]
    batch = config["dataset"]["batch_size"]
    out_dir = args.out or os.path.join(exp_dir, "served")
    os.makedirs(out_dir, exist_ok=True)
    dehazer = AdaptiveDehazer(_load_joint(config, device), None, config, device=device,
                              resolution_policy=os.path.join(exp_dir, "resolution_policy.json"),
                              precompiled=_resolve_bundle(args, exp_dir))

    def batches():
        for i in range(0, len(files), batch):
            yield np.stack([_imread_rgb(f, img_size) for f in files[i:i + batch]])

    mode = args.serve_mode
    lowres = parse_lowres(args.lowres)
    if lowres and mode not in ("hard", "spill", "spill_up", "stream"):
        raise SystemExit("serve: --lowres applies to hard/spill/stream modes")
    results = {}  # global index -> (dehazed HWC float32, intensity or None)
    if mode == "queued":
        for out, gidx, cls in dehazer.route_hard_queued(
                batches(), queue_bucket=args.queue_bucket,
                max_wait_batches=args.max_wait_batches):
            for row, g in zip(out.float().cpu().numpy(), gidx):
                results[int(g)] = (row, int(cls))
    elif mode == "stream":
        base = 0
        for out, intensity in dehazer.route_hard_stream(batches(), lowres=lowres):
            for j, row in enumerate(out):
                results[base + j] = (row, int(intensity[j]))
            base += out.shape[0]
    else:
        base = 0
        for x in batches():
            if mode == "soft":
                out, intensity = dehazer(x), None
            elif mode == "device":
                out, intensity = dehazer.route_device_binned(x)
            else:
                spill = {"hard": False, "spill": True, "spill_up": "up"}[mode]
                out, intensity = dehazer.route_hard(x, spill=spill, lowres=lowres)
            for j in range(out.shape[0]):
                results[base + j] = (out[j], None if intensity is None else int(intensity[j]))
            base += out.shape[0]

    manifest = {}
    for g, (img, intensity) in sorted(results.items()):
        name = os.path.basename(files[g])
        _write_rgb(os.path.join(out_dir, name), np.asarray(img, np.float32))
        if intensity is not None:
            manifest[name] = {"intensity": intensity, "branch": INTENSITY_ORDER[intensity]}
    if args.detect:
        _serve_detect(config, files, results, out_dir, batch, device)
    with open(os.path.join(out_dir, "routing.json"), "w") as f:
        json.dump({"serve_mode": mode,
                   "lowres": "auto" if lowres == "auto" else list(lowres),
                   "images": manifest}, f, indent=2)
    hist = {}
    for v in manifest.values():
        hist[v["branch"]] = hist.get(v["branch"], 0) + 1
    print(f"Served {len(results)} images via '{mode}' -> {out_dir} "
          f"(routing: {hist if hist else 'soft blend'})")


def _resolve_bundle(args, exp_dir: str):
    """--precompiled PATH|auto -> the bundle directory (None when absent)."""
    if args.precompiled == "auto":
        cand = os.path.join(exp_dir, "precompiled")
        return cand if os.path.isdir(cand) else None
    return args.precompiled


def run_export(config, exp_dir: str, args, device="cuda"):
    """Write a precompiled serving bundle of the experiment
    (serving_export.py), at the config's batch size:

      python3 main_torch.py --mode export --experiment_dir experiments/X \\
          [--precompiled OUTDIR] [--batch_size N] [--queue_bucket B]

    Afterwards `--mode serve --precompiled auto` (or
    `AdaptiveDehazer.from_experiment(..., precompiled=...)`) serves through
    the bundle: CUDA graphs on the card and no nvcc."""
    from adam_dehaze_tpu_torch.evaluation.evaluate import _load_joint
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    out = (args.precompiled if args.precompiled not in (None, "auto")
           else os.path.join(exp_dir, "precompiled"))
    dehazer = AdaptiveDehazer(_load_joint(config, device), None, config, device=device)
    batch = config["dataset"]["batch_size"]
    written = dehazer.export_precompiled(
        out, batch_sizes=(batch,), queue_buckets=(args.queue_bucket,),
        device_buckets=(16, batch), progress=lambda m: print(f"  {m}"))
    print(f"Exported {len(written)} serving programs -> {out}")


def parse_lowres(value: str):
    """--lowres as the dial of route_hard: "auto", or a tuple of levels
    (empty for full resolution). Unknown levels stop the command."""
    from adam_dehaze_tpu_torch.models.routing import INTENSITY_ORDER
    if value == "auto":
        return "auto"
    lowres = tuple(s for s in value.split(",") if s)
    bad = set(lowres) - set(INTENSITY_ORDER)
    if bad:
        raise SystemExit(f"serve: unknown --lowres levels {sorted(bad)} "
                         f"(choose from {list(INTENSITY_ORDER)} or 'auto')")
    return lowres


def _serve_detect(config, files, results, out_dir: str, batch: int, device):
    """The trained detector on the served (dehazed) images:
    <out_dir>/detections.json, {filename: {boxes, scores, labels}}, boxes
    xyxy in pixels."""
    from adam_dehaze_tpu_torch.evaluation.evaluate import load_detection_model
    from adam_dehaze_tpu_torch.models.detection import imagenet_normalize

    det_model = load_detection_model(config, device=device)
    order = sorted(results)
    detections = {}
    for i in range(0, len(order), batch):
        idx = order[i:i + batch]
        x = torch.from_numpy(np.stack([np.asarray(results[g][0], np.float32)
                                       for g in idx])).to(device)
        for g, det in zip(idx, det_model(imagenet_normalize(x))):
            detections[os.path.basename(files[g])] = {
                k: np.asarray(det[k]).tolist() for k in ("boxes", "scores", "labels")}
    with open(os.path.join(out_dir, "detections.json"), "w") as f:
        json.dump(detections, f, indent=2)
    n = sum(len(v["scores"]) for v in detections.values())
    print(f"Detected {n} objects across {len(detections)} images -> "
          f"{out_dir}/detections.json")


if __name__ == "__main__":
    main()
