"""One rank of the two-process gloo group of tests/test_torch_spatial_resize.py.

    python tests/torch_spatial_resize_worker.py RANK PORT INPUTS OUT_DIR

Imports the port only (no JAX): the test computes the JAX references in its
own process and compares them with what each rank writes to
OUT_DIR/rank{RANK}.pt. On a `{"spatial": 2}` mesh of the two ranks, each
beside the unsharded call: the branches whose paths resize (corun,
dual_branch, the medium branch at a width whose decoder resizes W), the
half-resolution dial around the medium and high branches and around the
tuned applies' plain versions, route_hard with the dial on every branch,
F.interpolate alone in each mode (and its gradient), the adaptive pools,
and what still raises.
"""
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.branches import (
    COrunInspiredModel,
    DualBranchAttentionModel,
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.resolution import make_lowres_apply
from adam_dehaze_tpu_torch.ops.serving_apply import (
    make_high_chain_apply,
    make_medium_tail_apply,
    make_serving_apply,
)
from adam_dehaze_tpu_torch.parallel import multihost
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.spatial import (
    make_spatial_infer,
    shard_image_batch,
    spatial_sharding,
)
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from torch_parallel_worker import numpy_tree
from torch_spatial_worker import ROUTE_LABELS, balance_head_, perturbed_bn_

# name -> the port module (the test builds the JAX one of the same name).
BRANCHES = {"corun": lambda: COrunInspiredModel(8, 2),
            "dual_branch": lambda: DualBranchAttentionModel(8),
            "medium": lambda: MediumIntensityDehazeModel(8),
            "high": lambda: HighIntensityDehazeModel(8)}
# The rule alone on 2 H shards of (2, 3, 8, 6): name -> F.interpolate's
# keyword arguments, `size` as the whole image's (each shard asks for its
# half of the rows), and whether the op is the identity along H.
RESIZES = {
    "antialiased_shrink": (dict(size=(4, 3), mode="bilinear", antialias=True), False),
    "half_pixel_upsample": (dict(size=(16, 12), mode="bilinear"), False),
    "antialiased_upsample": (dict(size=(16, 9), mode="bilinear", antialias=True), False),
    "align_corners_upsample": (dict(size=(16, 11), mode="bilinear", align_corners=True), False),
    "align_corners_shrink": (dict(size=(4, 4), mode="bilinear", align_corners=True), False),
    "nearest_exact_upsample": (dict(size=(16, 12), mode="nearest-exact"), False),
    "scale_factor_upsample": (dict(scale_factor=2.0, mode="bilinear"), False),
    "w_only_antialiased": (dict(size=(8, 4), mode="bilinear", antialias=True), True),
    "w_only_align_corners": (dict(size=(8, 9), mode="bilinear", align_corners=True), True),
    # A 4x antialiased shrink of 4-row shards: each output row reads 6 to 8
    # source rows, a band taller than a shard.
    "band_taller_than_a_shard": (dict(size=(2, 6), mode="bilinear", antialias=True), False),
}
# Gradients through the rule: name of RESIZES.
GRAD_RESIZES = ("antialiased_shrink", "align_corners_upsample", "band_taller_than_a_shard")


def branch(name, inputs):
    model = BRANCHES[name]()
    return load_flax_variables(model, numpy_tree(inputs["branch_vars"][name])).eval()


def _whole_and_sharded(apply, x, mesh):
    with torch.no_grad():
        return {"whole": apply(x),
                "sharded": make_spatial_infer(apply, mesh)(shard_image_batch(mesh, x))}


def models(inputs, mesh):
    """corun, dual_branch (K2's plain version on its maps' filled halo) and
    the medium branch at 64 x 58 (its decoder resizes W)."""
    return {"corun": _whole_and_sharded(branch("corun", inputs), inputs["x"], mesh),
            "dual_branch": _whole_and_sharded(branch("dual_branch", inputs), inputs["x"], mesh),
            "medium_58": _whole_and_sharded(make_serving_apply(branch("medium", inputs),
                                                               torch.float32),
                                            inputs["x58"], mesh)}


def dial(inputs, mesh):
    """make_lowres_apply around the medium and high branches: their serving
    applies in fp32 (held against JAX), and the branches in float64 (held
    against the unsharded dial: in float32 the guided lift's integral
    images sum their rows in another order on a taller shard); and the
    bilinear dial around the tuned applies' plain versions, fp32, c = 16
    (K3 for the medium branch; K6, K4 and K2' for the high one)."""
    out = {}
    for lvl in ("medium", "high"):
        model = branch(lvl, inputs)
        out[lvl] = _whole_and_sharded(make_lowres_apply(make_serving_apply(model, torch.float32)),
                                      inputs["x"], mesh)
        out[f"{lvl}_float64"] = _whole_and_sharded(make_lowres_apply(model.double()),
                                                   inputs["x"].double(), mesh)
    gen = torch.Generator().manual_seed(26)
    medium = perturbed_bn_(init_params_(MediumIntensityDehazeModel(16), gen), gen).eval()
    high = perturbed_bn_(init_params_(HighIntensityDehazeModel(16), gen), gen).eval()
    for name, apply in (("k3", make_medium_tail_apply(medium, torch.float32)),
                        ("k6_k4", make_high_chain_apply(high, torch.float32, res_chain=True,
                                                        tail_chain=True))):
        out[name] = _whole_and_sharded(make_lowres_apply(apply, mode="bilinear"), inputs["x"],
                                       mesh)
    return out


def route_lowres(inputs, mesh):
    """route_hard(..., lowres=("low", "medium", "high")) of a seeded default
    router (c = 8, fp32) whose head sends one image
    at least to each branch, on the whole batch and through
    make_spatial_infer."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for level in ("low", "medium", "high"):
        cfg["dehazing"][level]["channels"] = 8
    models = {"low": LightweightDehazeModel(8, 3), "medium": MediumIntensityDehazeModel(8),
              "high": HighIntensityDehazeModel(8)}
    router = create_router(models, create_classifier(cfg), cfg)
    gen = torch.Generator().manual_seed(27)
    perturbed_bn_(init_params_(router, gen), gen).eval()
    x = inputs["route_x"]
    balance_head_(router.classifier, x, ROUTE_LABELS)
    d = AdaptiveDehazer(router, None, cfg, device="cpu")
    lowres = ("low", "medium", "high")
    whole, labels = d.route_hard(x.numpy(), lowres=lowres)
    got, got_labels = make_spatial_infer(lambda t: d.route_hard(t, lowres=lowres),
                                         mesh)(shard_image_batch(mesh, x))
    return {"whole": torch.from_numpy(whole), "labels": labels.tolist(),
            "sharded": torch.from_numpy(got), "sharded_labels": got_labels.tolist()}


def _shard_kwargs(kwargs, size):
    """The arguments as a shard passes them: its rows of a `size`."""
    if "size" not in kwargs:
        return kwargs
    h, w = kwargs["size"]
    return {**kwargs, "size": (h // size, w)}


def resizes(inputs, mesh):
    """Each of RESIZES on the whole tensor and on this rank's rows."""
    rows = mesh.axis("spatial")
    x = inputs["resize_x"]
    out = {}
    for name, (kwargs, _) in RESIZES.items():
        whole = F.interpolate(x, **kwargs)
        with spatial_sharding(mesh):
            part = F.interpolate(x.chunk(rows.size, 2)[rows.index],
                                 **_shard_kwargs(kwargs, rows.size))
        out[name] = {"whole": whole, "sharded": part}
    return out


def resize_gradients(inputs, mesh):
    """For each of GRAD_RESIZES, float64: this rank's input gradient through
    the sharded resize (each rank's loss a weighted sum of its output rows,
    the weights differing per rank), and autograd's gradient of the
    unsharded resize under the sum of those losses."""
    rows = mesh.axis("spatial")
    x = inputs["resize_x"].double()
    out = {}
    for name in GRAD_RESIZES:
        kwargs = RESIZES[name][0]
        whole_out = F.interpolate(x, **kwargs)
        n = whole_out.shape[2] // rows.size
        weights = [torch.from_numpy(np.random.default_rng(40 + r).standard_normal(
            (*whole_out.shape[:2], n, whole_out.shape[3]))) for r in range(rows.size)]
        part = x.chunk(rows.size, 2)[rows.index].clone().requires_grad_()
        with spatial_sharding(mesh):
            y = F.interpolate(part, **_shard_kwargs(kwargs, rows.size))
        (y * weights[rows.index]).sum().backward()
        ref = x.clone().requires_grad_()
        y = F.interpolate(ref, **kwargs)
        sum((y[:, :, r * n:(r + 1) * n] * w).sum() for r, w in enumerate(weights)).backward()
        out[name] = (part.grad, ref.grad.chunk(rows.size, 2)[rows.index])
    return out


def pools(inputs, mesh):
    """The adaptive pools to 1 x 1 and to the whole image's H (8) by 3."""
    rows = mesh.axis("spatial")
    x = inputs["resize_x"]
    out = {}
    for name, fn in (("avg_1x1", lambda t: F.adaptive_avg_pool2d(t, 1)),
                     ("max_1x1", lambda t: F.adaptive_max_pool2d(t, (1, 1))),
                     ("avg_whole_h", lambda t: F.adaptive_avg_pool2d(t, (8, 3))),
                     ("max_whole_h", lambda t: F.adaptive_max_pool2d(t, (None, 3)))):
        whole = fn(x)
        with spatial_sharding(mesh):
            out[name] = {"whole": whole, "sharded": fn(x.chunk(rows.size, 2)[rows.index])}
    return out


def refusals(inputs, mesh):
    """What still raises on an H shard: name -> (exception type, message)."""
    rows = mesh.axis("spatial")
    part = inputs["resize_x"].chunk(rows.size, 2)[rows.index]
    uneven = torch.zeros(1, 1, 3, 4)
    cases = {"bicubic": lambda: F.interpolate(part, size=(8, 6), mode="bicubic"),
             "uneven_rows": lambda: F.interpolate(uneven, scale_factor=0.5, mode="bilinear"),
             "adaptive_2x2": lambda: F.adaptive_avg_pool2d(part, 2),
             "pad_of_h": lambda: F.pad(part, (0, 0, 1, 1)),
             "strided_avg_pool": lambda: F.avg_pool2d(part, 2)}
    out = {}
    for name, fn in cases.items():
        try:
            with spatial_sharding(mesh):
                fn()
            out[name] = None
        except (NotImplementedError, ValueError) as e:
            out[name] = (type(e).__name__, str(e))
    return out


def main():
    rank, port, inputs_path, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                        sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=True)
    multihost.initialize(f"localhost:{port}", 2, rank, device="cpu")
    mesh = make_mesh({"data": 1, "spatial": 2}, ["cpu", "cpu"])
    out = {"models": models(inputs, mesh), "dial": dial(inputs, mesh),
           "route": route_lowres(inputs, mesh), "resizes": resizes(inputs, mesh),
           "grads": resize_gradients(inputs, mesh), "pools": pools(inputs, mesh),
           "refusals": refusals(inputs, mesh)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
