"""One rank of the two-process gloo group of tests/test_torch_spatial.py.

    python tests/torch_spatial_worker.py RANK PORT INPUTS OUT_DIR

Imports the port only (no JAX): the test computes the JAX references in its
own process and compares them with what each rank writes to
OUT_DIR/rank{RANK}.pt. Every case that needs the group runs in this one
spawn, on a `{"spatial": 2}` mesh and a `{"model": 2}` mesh of the two ranks:
also the tuned kernels' plain versions (K3, K4, K2' alone and inside K4,
K6), the loss pieces, the augmentation and AlexNet's layers on 2 H shards,
each beside the unsharded call; int8 serving (the medium and high
branches, and one Int8Conv2d of each body and shape) on both meshes; and
the joint step under `cuda.remat` on the spatial mesh, also with its
backward run on another thread (as the card's autograd engine runs it).
"""
import os
import sys
import threading

import numpy as np
import torch
import torch.nn.functional as F

from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.data.augment import _color_jitter, _flip
from adam_dehaze_tpu_torch.data.synthetic import fog_density_map
from adam_dehaze_tpu_torch.losses.lpips import LPIPS
from adam_dehaze_tpu_torch.models.branches import (
    HighIntensityDehazeModel,
    LightweightDehazeModel,
    MediumIntensityDehazeModel,
)
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.nn.alexnet import AlexNetFeatures
from adam_dehaze_tpu_torch.nn.blocks import init_params_
from adam_dehaze_tpu_torch.ops.image import psnr, ssim_gray
from adam_dehaze_tpu_torch.ops.kernels.cbam import spatial_gate
from adam_dehaze_tpu_torch.ops.quant import Int8Conv2d, quantize_apply
from adam_dehaze_tpu_torch.ops.serving_apply import (
    make_high_chain_apply,
    make_medium_chain_apply,
    make_medium_tail_apply,
    make_serving_apply,
)
from adam_dehaze_tpu_torch.parallel import data_parallel, multihost
from adam_dehaze_tpu_torch.parallel.collectives import (
    AllReduceMax,
    AllReduceSum,
    GatherChannels,
    Halo,
    ShardChannels,
    SumToReplicated,
    channel_slice,
)
from adam_dehaze_tpu_torch.parallel.mesh import make_mesh
from adam_dehaze_tpu_torch.parallel.sharded_ops import ShardedOps
from adam_dehaze_tpu_torch.parallel.sharding import channel_sharding
from adam_dehaze_tpu_torch.parallel.spatial import (
    make_spatial_infer,
    shard_image_batch,
    spatial_sharding,
)
from adam_dehaze_tpu_torch.serving import AdaptiveDehazer
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from adam_dehaze_tpu_torch.training.remat import checkpoint_call
from torch_joint_sharded_worker import run_step
from torch_parallel_worker import TinyConv, module_arrays, mse_step, numpy_tree, sgd_state

BRANCHES = {"low": lambda: LightweightDehazeModel(8, 3),
            "medium": lambda: MediumIntensityDehazeModel(8),
            "high": lambda: HighIntensityDehazeModel(8)}
# The images of the hard route: one a branch at least, once the head is set.
ROUTE_LABELS = (0, 1, 2, 0)


def branch(level, inputs, dtype=torch.float32):
    model = load_flax_variables(BRANCHES[level](), numpy_tree(inputs["branch_vars"][level]))
    return model.to(dtype).eval()


def spatial_forwards(inputs, mesh):
    """Each branch's serving apply (K1's plain version for the low branch,
    the canonical forward with K2's for the others) on the whole batch,
    and through make_spatial_infer on this rank's rows."""
    x = inputs["x"]
    out = {}
    for level in BRANCHES:
        apply = make_serving_apply(branch(level, inputs), torch.float32)
        with torch.no_grad():
            out[level] = {"whole": apply(x),
                          "sharded": make_spatial_infer(apply, mesh)(shard_image_batch(mesh, x))}
    return out


def channel_forwards(inputs, mesh):
    """The medium and high branches on the whole batch, and under
    channel_sharding."""
    out = {}
    for level in ("medium", "high"):
        model = branch(level, inputs)
        with torch.no_grad():
            whole = model(inputs["tp_x"])
            with channel_sharding(mesh):
                out[level] = {"whole": whole, "sharded": model(inputs["tp_x"])}
    return out


def balance_head_(classifier, x, labels):
    """Set the classifier's last linear so that image i's logits are 10 at
    labels[i] and -5 elsewhere: the least-norm weights that map the head's
    hidden features of `x` onto those logits (seeded weights route every
    image to one class)."""
    _, fc0, relu, _, fc1 = classifier.classifier
    classifier.eval()
    with torch.no_grad():
        h = relu(fc0(classifier.backbone(x.permute(0, 3, 1, 2)))).double()
        t = torch.full((len(labels), 3), -5.0, dtype=torch.float64)
        t[torch.arange(len(labels)), torch.tensor(labels)] = 10.0
        fc1.weight.copy_((t.T @ torch.linalg.solve(h @ h.T, h)).float())
        fc1.bias.zero_()


def route(inputs, mesh, quant=None):
    """route_hard of a seeded default router (small widths, fp32, served
    under `cuda.serving_quant: quant`) on the whole batch, and through
    make_spatial_infer on this rank's rows."""
    cfg = load_config(overrides={"cuda": {"compute_dtype": "float32", "serving_quant": quant}})
    for level in BRANCHES:
        cfg["dehazing"][level]["channels"] = 8
    models = {level: BRANCHES[level]() for level in BRANCHES}
    router = create_router(models, create_classifier(cfg), cfg)
    init_params_(router, torch.Generator().manual_seed(0)).eval()
    x = inputs["route_x"]
    balance_head_(router.classifier, x, ROUTE_LABELS)
    d = AdaptiveDehazer(router, None, cfg, device="cpu")
    whole, labels = d.route_hard(x.numpy())
    got, got_labels = make_spatial_infer(d.route_hard, mesh)(shard_image_batch(mesh, x))
    return {"whole": torch.from_numpy(whole), "labels": labels.tolist(),
            "sharded": torch.from_numpy(got), "sharded_labels": got_labels.tolist()}


def steps(inputs, spatial_mesh, model_mesh, rank):
    """The two-conv model's step (float32) and the low branch's BN step
    (float64) on the spatial mesh; the medium branch's step (float64) on
    the model mesh; on rank 0 the global steps of both branches."""
    out = {}
    conv = TinyConv()
    with torch.no_grad():
        for name, t in inputs["conv_params"].items():
            conv.get_parameter(name).copy_(t)
    batch = {"x": inputs["conv_x"], "y": inputs["conv_y"]}
    data_parallel.shard_train_step(mse_step, spatial_mesh, batch)(sgd_state(conv), batch)
    out["conv"] = module_arrays(conv)
    for level, mesh in (("low", spatial_mesh), ("medium", model_mesh)):
        batch = {"x": inputs["step_x"], "y": inputs["step_y"]}
        for tag in ("sharded", "global") if rank == 0 else ("sharded",):
            model = load_flax_variables(BRANCHES[level](),
                                        numpy_tree(inputs["branch_vars"][level]))
            model = model.double().train()
            step = (data_parallel.shard_train_step(mse_step, mesh, batch) if tag == "sharded"
                    else mse_step)
            step(sgd_state(model), batch)
            out[f"{level}_{tag}"] = module_arrays(model)
    return out


def _rand(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape))


def exchange_gradients(mesh, rank):
    """For each exchange Function: this rank's input gradient through it
    (each rank's loss a weighted sum of its output, with weights that
    differ per rank), and autograd's gradient of the unsharded computation
    it stands for (the ranks' losses added), float64."""
    axis = mesh.axis("spatial")
    out = {}

    def weights(shapes):
        return [_rand(100 + r, s) for r, s in enumerate(shapes)]

    # Halo: 4 rows a shard, 2 rows above and 1 below.
    whole = _rand(0, (2, 3, 8, 5))
    for name, fill, windows in (("halo", 0.0, [(0, 7), (4, 11)]),
                                ("halo_at_edges_left_out", None, [(0, 5), (2, 8)])):
        x = whole[:, :, 4 * rank:4 * rank + 4].clone().requires_grad_()
        w = weights([(2, 3, b - a, 5) for a, b in windows])
        (Halo.apply(x, 2, 2, 1, fill, axis) * w[rank]).sum().backward()
        ref = whole.clone().requires_grad_()
        padded = F.pad(ref, (0, 0, 2, 1)) if fill is not None else ref
        sum((padded[:, :, a:b] * wr).sum() for (a, b), wr in zip(windows, w)).backward()
        out[name] = (x.grad, ref.grad[:, :, 4 * rank:4 * rank + 4])

    parts = [_rand(20 + r, (3, 4)) for r in (0, 1)]
    w = weights([(3, 4), (3, 4)])
    for name, fn, join in (
            ("all_reduce_sum", lambda t: AllReduceSum.apply(t, (axis.group,)),
             lambda ts: ts[0] + ts[1]),
            ("all_reduce_max", lambda t: AllReduceMax.apply(t, axis),
             lambda ts: torch.maximum(ts[0], ts[1]))):
        t = parts[rank].clone().requires_grad_()
        (fn(t) * w[rank]).sum().backward()
        ref = [p.clone().requires_grad_() for p in parts]
        sum((join(ref) * wr).sum() for wr in w).backward()
        out[name] = (t.grad, ref[rank].grad)

    # The same loss on every rank after SumToReplicated: counted once.
    t = parts[rank].clone().requires_grad_()
    (SumToReplicated.apply(t, axis) * w[0]).sum().backward()
    ref = [p.clone().requires_grad_() for p in parts]
    ((ref[0] + ref[1]) * w[0]).sum().backward()
    out["sum_to_replicated"] = (t.grad, ref[rank].grad)

    whole = _rand(1, (2, 4, 3, 3))
    part = channel_slice(4, axis)
    x = whole.clone().requires_grad_()
    w = weights([(2, 2, 3, 3)] * 2)
    (ShardChannels.apply(x, axis) * w[rank]).sum().backward()
    ref = whole.clone().requires_grad_()
    sum((ref[:, channel_slice(4, axis._replace(index=r))] * w[r]).sum() for r in (0, 1)).backward()
    out["shard_channels"] = (x.grad, ref.grad)

    x = whole[:, part].clone().requires_grad_()
    w = weights([(2, 4, 3, 3)] * 2)
    (GatherChannels.apply(x, axis) * w[rank]).sum().backward()
    ref = whole.clone().requires_grad_()
    sum((ref * wr).sum() for wr in w).backward()
    out["gather_channels"] = (x.grad, ref.grad[:, part])
    return out


def int8_forwards(inputs, spatial_mesh, model_mesh):
    """The medium and high branches' int8 serving applies (fp32) on the
    whole batch, through make_spatial_infer on this rank's rows, and under
    channel_sharding."""
    x = inputs["x"]
    out = {}
    for level in ("medium", "high"):
        apply = quantize_apply(branch(level, inputs), torch.float32)
        with torch.inference_mode():
            whole = apply(x)
            rows = make_spatial_infer(apply, spatial_mesh)(shard_image_batch(spatial_mesh, x))
            with channel_sharding(model_mesh):
                channels = apply(x)
        out[level] = {"whole": whole, "spatial": rows, "channels": channels}
    return out


# One Int8Conv2d of each body and shape that quantized_inference serves:
# name -> (cin, cout, kernel, stride, padding, BN). Without a BN the conv
# has its bias. The RGB inputs are never split by channel.
INT8_LAYERS = {"tile_3x3": (32, 32, 3, 1, 1, True), "tile_4x4_s2": (16, 32, 4, 2, 1, True),
               "gather_rgb_7x7": (3, 8, 7, 1, 3, True), "gather_rgb_3x3": (3, 16, 3, 1, 1, True),
               "gather_3x3": (8, 8, 3, 1, 1, True), "gather_4x4_s2": (8, 16, 4, 2, 1, True),
               "gather_1x1_bias": (56, 16, 1, 1, 0, False)}


def int8_layer(name):
    """The layer `name` of INT8_LAYERS (eval BN with moved statistics, ReLU),
    seeded alike on every rank, and its input (2 images of 32 x 16)."""
    cin, cout, k, stride, pad, use_bn = INT8_LAYERS[name]
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    conv = torch.nn.Conv2d(cin, cout, k, stride, pad, bias=not use_bn)
    bn = None
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
        if use_bn:
            bn = perturbed_bn_(torch.nn.BatchNorm2d(cout), gen).eval()
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.uniform_(-0.2, 0.2, generator=gen)
    x = torch.randn(2, cin, 32, 16, generator=gen).contiguous(memory_format=torch.channels_last)
    return Int8Conv2d(conv, bn, relu=True), x


def int8_layers(spatial_mesh, model_mesh):
    """Each layer of INT8_LAYERS on the whole input, on this rank's rows,
    and (inputs of more than 3 channels) on this rank's channels."""
    rows, cols = spatial_mesh.axis("spatial"), model_mesh.axis("model")
    out = {}
    for name in INT8_LAYERS:
        layer, x = int8_layer(name)
        with torch.inference_mode():
            rec = {"whole": layer(x)}
            with spatial_sharding(spatial_mesh):
                rec["spatial"] = layer(x.chunk(rows.size, 2)[rows.index])
            if x.shape[1] > 3:
                with channel_sharding(model_mesh):
                    rec["channels"] = layer(x.chunk(cols.size, 1)[cols.index])
        out[name] = rec
    return out


REMAT_MODES = (False, True, "fullres")


def remat_steps(inputs, mesh):
    """The joint train step (the dryrun's router in float64, as
    tests/test_torch_joint_sharded.py takes it) on the spatial mesh under
    each cuda.remat mode."""
    return {str(mode): run_step("train", inputs["remat_batch"], mesh, remat=mode)
            for mode in REMAT_MODES}


def remat_on_another_thread(inputs, mesh):
    """A checkpointed forward of the low branch (train mode, float64) on this
    rank's rows, its MSE's backward run on a fresh thread outside the
    sharding context (no context variables, no function modes) and on one
    that holds ShardedOps but not the context variables (what the card's
    autograd thread inherits), against the same backward without the
    checkpoint: the gradients and BN statistics."""
    x = shard_image_batch(mesh, inputs["step_x"])
    y = shard_image_batch(mesh, inputs["step_y"])
    out = {}
    for name in ("plain", "bare_thread", "mode_thread"):
        model = branch("low", inputs, torch.float64).train()
        with data_parallel._synchronized_batch_norms(model, (mesh.axis("spatial").group,)):
            with spatial_sharding(mesh):
                pred = (model(x) if name == "plain" else
                        checkpoint_call(model, x, module=model))
                loss = ((pred - y) ** 2).mean()
            if name == "plain":
                loss.backward()
            else:
                def backward(with_mode=name == "mode_thread"):
                    if with_mode:
                        with ShardedOps():
                            loss.backward()
                    else:
                        loss.backward()
                t = threading.Thread(target=backward)
                t.start()
                t.join()
        out[name] = {**module_arrays(model),
                     **{f"{n}.grad": p.grad.detach().clone() for n, p in model.named_parameters()}}
    return out


def perturbed_bn_(model, gen):
    """BN statistics moved away from (0, 1), so that folding them matters."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.8, 1.3, generator=gen)
    return model


def _whole_and_sharded(fn, mesh, *args, dims=None):
    """fn on the whole tensors, and on this rank's H shards (dim 1, or
    `dims[i]` for argument i, None for an argument every rank holds whole)
    under spatial_sharding."""
    rows = mesh.axis("spatial")
    dims = dims or [1] * len(args)
    parts = [a if d is None else a.chunk(rows.size, d)[rows.index]
             for a, d in zip(args, dims)]
    with torch.no_grad():
        whole = fn(*args)
        with spatial_sharding(mesh):
            return whole, fn(*parts)


def tuned_kernels(inputs, mesh):
    """The tuned serving applies' plain versions, fp32, through
    make_spatial_infer: K3 (the medium tail), K6 on the medium branch's
    three segments, K6 on the high branch's three segments with K4 and K2'
    after them; and K2' alone on a shard."""
    x = inputs["tuned_x"]
    gen = torch.Generator().manual_seed(16)
    models = {lvl: perturbed_bn_(init_params_(cls(16), gen), gen).eval()
              for lvl, cls in (("medium", MediumIntensityDehazeModel),
                               ("high", HighIntensityDehazeModel))}
    applies = {"k3": make_medium_tail_apply(models["medium"], torch.float32),
               "k6_medium": make_medium_chain_apply(models["medium"], torch.float32),
               "k6_k4_high": make_high_chain_apply(models["high"], torch.float32,
                                                   res_chain=True, tail_chain=True)}
    out = {}
    for name, apply in applies.items():
        with torch.no_grad():
            out[name] = {"whole": apply(x),
                         "sharded": make_spatial_infer(apply, mesh)(shard_image_batch(mesh, x))}
    g = inputs["gate_x"]
    w = inputs["gate_w"]
    out["k2_prime"] = dict(zip(("whole", "sharded"),
                               _whole_and_sharded(lambda t: spatial_gate(t, w), mesh, g)))
    return out


def loss_pieces(inputs, mesh):
    """LPIPS, psnr, ssim_gray and fog_density_map (float64) on the whole
    images and on this rank's H shards."""
    torch.manual_seed(0)
    lpips = LPIPS().eval()
    a, b = inputs["loss_a"], inputs["loss_b"]
    out = {}
    for name, fn, args in (("lpips", lpips, (2 * a - 1, 2 * b - 1)), ("psnr", psnr, (a, b)),
                           ("ssim", ssim_gray, (a, b)),
                           ("density", fog_density_map, (inputs["hazy64"],))):
        whole, sharded = _whole_and_sharded(fn, mesh, *args)
        out[name] = {"whole": whole, "sharded": sharded}
    return out


def augmentation(inputs, mesh):
    """_flip and _color_jitter at given flip bits and factors."""
    x, (hflip, vflip, bf, cf) = inputs["aug_x"], inputs["aug_params"]
    out = {}
    for name, fn in (("flip", lambda t: _flip(t, hflip, vflip)),
                     ("jitter", lambda t: _color_jitter(t, bf, cf))):
        whole, sharded = _whole_and_sharded(fn, mesh, x)
        out[name] = {"whole": whole, "sharded": sharded}
    return out


def alexnet_layers(mesh):
    """AlexNet's 11x11/4 conv1 on 2 H shards of a 64^2 image and its 3x3/2
    max-pool on 2 shards of 16 rows: the unsharded rows, and what each
    sharded call returned (its rows) or raised (its message)."""
    net = AlexNetFeatures().eval()
    conv1, pool = net.features[0], net.features[2]
    x = torch.rand(1, 3, 64, 64, generator=torch.Generator().manual_seed(7))
    out = {}
    pooled = torch.rand(1, 64, 16, 16, generator=torch.Generator().manual_seed(8))
    for name, fn, arg in (("conv1", conv1, x), ("pool", pool, pooled)):
        with torch.no_grad():
            want = fn(arg).shape[2]
            part = arg.chunk(2, 2)[mesh.axis("spatial").index]
            try:
                with spatial_sharding(mesh):
                    got = fn(part).shape[2]
            except ValueError as e:
                got = str(e)
        out[name] = (want, got)
    return out


def main():
    rank, port, inputs_path, out_dir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                                        sys.argv[4])
    torch.set_num_threads(1)
    inputs = torch.load(inputs_path, weights_only=True)
    multihost.initialize(f"localhost:{port}", 2, rank, device="cpu")
    spatial_mesh = make_mesh({"data": 1, "spatial": 2}, ["cpu", "cpu"])
    model_mesh = make_mesh({"data": 1, "model": 2}, ["cpu", "cpu"])
    out = {"spatial": spatial_forwards(inputs, spatial_mesh),
           "channels": channel_forwards(inputs, model_mesh),
           "route": route(inputs, spatial_mesh),
           "route_int8": route(inputs, spatial_mesh, "int8"),
           "steps": steps(inputs, spatial_mesh, model_mesh, rank),
           "grads": exchange_gradients(spatial_mesh, rank),
           "int8": int8_forwards(inputs, spatial_mesh, model_mesh),
           "int8_layers": int8_layers(spatial_mesh, model_mesh),
           "remat": remat_steps(inputs, spatial_mesh),
           "remat_thread": remat_on_another_thread(inputs, spatial_mesh),
           "tuned": tuned_kernels(inputs, spatial_mesh),
           "losses": loss_pieces(inputs, spatial_mesh),
           "augment": augmentation(inputs, spatial_mesh),
           "alexnet": alexnet_layers(spatial_mesh)}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
