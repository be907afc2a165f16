"""The port's joint trainer against the JAX package, on the CPU (tiny
branch widths, resnet18, 32^2, augmentation off, fp32):

- the JointLoss's components at 1e-4;
- one joint train step under soft, hard and gated routing: the loss
  components at 1e-4, every branch and gate gradient at 1e-4 of the
  largest, the classifier's parameters bit-identical after the step (it is
  frozen), and every BN's running statistics as flax's once torch's
  unbiased batch variance is mapped to flax's biased one;
- `make_hard_branch_step` on the high branch;
- `cuda.remat` true and fullres against no remat, with the classifier's
  dropout on: gradients, BN buffers and losses within 1e-6;
- `load_flax_variables` on a GatedRouter.

The trainer end to end: tests/test_torch_joint_trainer.py.

The JAX references compute in float64 (`jax.enable_x64`, compute dtype
float64, the parameters as they are): in float32 the JAX step's own
gradients are up to 1e-3 of the largest off float64 (flax's train-mode BN
takes the variance as E[x^2] - E[x]^2; tests/test_torch_classifier_training.py), where
the port's float32 step stays within it; and at batch 2 even float32
against float64 moves the cross-entropy by 3e-4, so the steps take batch 4
(four values a channel). The parameters' gradients are the VJP of the
router with the JointLoss's gradient of the dehazed images (the CE term
reaches only the frozen classifier), so that the loss nets compile once.
Dropout is off on both sides in the comparisons (the frameworks draw
different masks): flax's Dropout is monkeypatched to the identity, the
port's dropouts get p = 0."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adam_dehaze_tpu.losses.dehazing import get_joint_loss as jget_joint_loss
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.losses.dehazing import get_joint_loss
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import GatedRouter, create_router
from adam_dehaze_tpu_torch.training import train_joint as tj
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
from torch_port_util import (
    ATOL,
    as64,
    as_np,
    assert_bn_stats_match_flax,
    f64,
    flax_dropout_off,
    images,
    jax_router_variables,
    joint_configs,
    no_dropout_,
    port_loss_params,
    port_of,
)

@pytest.fixture
def no_flax_dropout(monkeypatch):
    flax_dropout_off(monkeypatch)


@pytest.fixture(scope="module")
def loss_nets():
    """(JAX JointLoss's init tree, the port's nets filled from it)."""
    jcfg, _ = joint_configs()
    jl = jget_joint_loss(jcfg)
    jlp = jax.jit(lambda k: jl.init(k, (1, 32, 32, 3)))(jax.random.PRNGKey(0))
    jlp = as_np(jlp)
    return jlp, port_loss_params(jlp)


@pytest.fixture(scope="module")
def router_vars():
    """routing type -> seeded JAX variables (soft and hard routers share
    one tree; the gated router adds its gate)."""
    soft = jax_router_variables("soft")
    return {"soft": soft, "hard": soft, "gated": jax_router_variables("gated")}


@pytest.fixture(scope="module")
def loss_grad(loss_nets):
    """The JAX JointLoss in float64 and its gradient with respect to the
    dehazed images: (total, components), d total / d dehazed. The
    gradient of the router's parameters is the router's VJP of it: the CE
    term reaches only the (frozen) classifier."""
    jlp, _ = loss_nets
    with jax.enable_x64(True):
        jl, lp = jget_joint_loss(f64(joint_configs()[0])), as64(jlp)
    return jax.jit(jax.value_and_grad(
        lambda out, logits, labels, clear, hazy: jl(lp, out, clear, logits, labels, hazy=hazy),
        has_aux=True))


def _batch(seed=10, n=2):
    return {"hazy": images((n, 32, 32, 3), seed=seed),
            "clear": images((n, 32, 32, 3), seed=seed + 1),
            "intensity": np.arange(n)[::-1] % 3}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _comps(tree):
    return {k: float(v) for k, v in tree.items() if k != "dehazing_components"}


# ------------------------------------------------------------ JointLoss ---

@pytest.mark.parametrize("with_logits", [True, False])
def test_joint_loss_matches_jax(loss_nets, with_logits):
    jlp, nets = loss_nets
    jcfg, pcfg = joint_configs()
    jl, pl = jget_joint_loss(jcfg), get_joint_loss(pcfg)
    b = _batch(3)
    pred = images((2, 32, 32, 3), seed=5)
    logits = np.random.default_rng(6).normal(size=(2, 3)).astype(np.float32)
    args = (logits, b["intensity"]) if with_logits else (None, None)
    want_total, want = jax.jit(
        lambda p, c, h, lg, y: jl(jlp, p, c, lg, y, hazy=h))(
        pred, b["clear"], b["hazy"], *args)
    total, got = pl(nets, torch.from_numpy(pred), torch.from_numpy(b["clear"]),
                    *(None if a is None else torch.from_numpy(a) for a in args),
                    hazy=torch.from_numpy(b["hazy"]))
    assert set(got) == set(want)
    for k, v in _comps(want).items():
        np.testing.assert_allclose(float(got[k]), v, rtol=ATOL, atol=ATOL, err_msg=k)
    for k, v in want["dehazing_components"].items():
        np.testing.assert_allclose(float(got["dehazing_components"][k]), float(v),
                                   rtol=ATOL, atol=ATOL, err_msg=k)
    assert float(got["detection"]) == 0.0
    assert (float(got["classification"]) > 0) == with_logits
    np.testing.assert_allclose(float(total), float(want_total), rtol=ATOL, atol=ATOL)


# ----------------------------------------------------- one joint step ---

def _jax_joint_step(jcfg, vs, loss_grad, batch):
    """Loss components, new BN statistics and trainable parameters'
    gradients of the JAX joint step (the JAX trainer's loss_fn), in
    float64."""
    with jax.enable_x64(True):
        cfg = f64(jcfg)
        router = JR.create_router(JB.create_branch_models(cfg), JC.create_classifier(cfg), cfg)
        bs = as64(vs["batch_stats"])
        x, clear = (jnp.asarray(batch[k], jnp.float64) for k in ("hazy", "clear"))

        def forward(params):
            (out, info), mut = router.apply({"params": params, "batch_stats": bs}, x,
                                            train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                                            mutable=["batch_stats"])
            return out, (info["logits"], mut["batch_stats"])

        out, vjp, (logits, new_bs) = jax.jit(lambda p: jax.vjp(forward, p, has_aux=True))(
            as64(vs["params"]))
        (_, comps), dout = loss_grad(out, logits, batch["intensity"], clear, x)
        grads, = jax.jit(vjp)(dout)
        return _comps(comps), as_np(new_bs), as_np(grads)


@pytest.mark.parametrize("routing", ["soft", "hard", "gated"])
def test_joint_step_matches_jax(routing, loss_nets, router_vars, loss_grad, no_flax_dropout):
    _, nets = loss_nets
    jcfg, pcfg = joint_configs(routing)
    vs = router_vars[routing]
    # Batch 4: the classifier's last stage then normalises 4 values a
    # channel in train mode (at batch 2 only 2, where even float32 against
    # float64 moves the cross-entropy by 3e-4).
    batch = _batch(n=4)
    want, new_bs, jgrads = _jax_joint_step(jcfg, vs, loss_grad, batch)

    router, state = tj.build_router_state(pcfg, "cpu")
    load_flax_variables(router, vs)
    no_dropout_(router).train()
    clf_before = {k: v.clone() for k, v in router.classifier.state_dict().items()}
    step = tj.make_train_step(get_joint_loss(pcfg), nets, augmentation=False)
    got = step(state, _torch_batch(batch))
    assert state.step == 1
    for k in ("dehazing", "classification", "detection", "total"):
        np.testing.assert_allclose(float(got[k]), want[k], rtol=ATOL, atol=ATOL, err_msg=k)

    # Gradients: every trainable parameter (branches, gate) has one, within
    # 1e-4 of the largest; the classifier has none and has not moved.
    grads = port_of(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg),
                    {"params": jgrads, "batch_stats": vs["batch_stats"]})
    trainable = {n: p for n, p in router.named_parameters() if not n.startswith("classifier.")}
    assert [p for p in state.optimizer.param_groups[0]["params"]] == list(trainable.values())
    want_g = {n: p.detach() for n, p in grads.named_parameters() if n in trainable}
    g_max = max(float(g.abs().max()) for g in want_g.values())
    for n, p in trainable.items():
        assert p.grad is not None, n          # hard routing: zeros, not None
        assert float((p.grad - want_g[n]).abs().max()) <= ATOL * g_max, n
    if routing == "gated":
        assert any(n.startswith("gate_network.") for n in trainable)
    for k, v in router.classifier.state_dict().items():
        if "running" in k or "num_batches" in k:
            continue
        assert torch.equal(v, clf_before[k]), k
        assert router.classifier.get_parameter(k).grad is None, k
    # BN statistics of the classifier and the branches, as flax's.
    template = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
    assert_bn_stats_match_flax(router, port_of(copy.deepcopy(template), vs),
                               port_of(template, {"params": vs["params"], "batch_stats": new_bs}),
                               torch.from_numpy(batch["hazy"]))


def test_hard_branch_step_matches_jax(loss_nets, router_vars, loss_grad):
    """The hard fine-tune step of the high branch against the JAX step's
    loss (the JointLoss without logits is the dehazing loss) and gradients,
    in float64. The JAX package's make_hard_branch_step itself runs in the
    trainer test (tests/test_torch_joint_trainer.py)."""
    _, nets = loss_nets
    jcfg, pcfg = joint_configs()
    batch = _batch(20, n=4)
    sub = {c: router_vars["soft"][c]["models_high"] for c in ("params", "batch_stats")}
    with jax.enable_x64(True):
        jmodel64 = JB.create_high_intensity_model(f64(jcfg))
        x, clear = (jnp.asarray(batch[k], jnp.float64) for k in ("hazy", "clear"))

        def forward(params):
            return jmodel64.apply({"params": params, "batch_stats": as64(sub["batch_stats"])},
                                  x, True, mutable=["batch_stats"])[0]

        out, vjp = jax.jit(lambda p: jax.vjp(forward, p))(as64(sub["params"]))
        (_, comps), dout = loss_grad(out, jnp.zeros((4, 3)), batch["intensity"], clear, x)
        jgrads, = jax.jit(vjp)(dout)
        jgrads = as_np(jgrads)
        want_dehazing = float(comps["dehazing"])
    model = port_of(create_branch_models(pcfg)["high"], sub).train()
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    got = tj.make_hard_branch_step(get_joint_loss(pcfg), nets, augmentation=False)(
        state, _torch_batch(batch))
    assert set(got) == {"dehazing", "classification", "detection", "total", "psnr"}
    assert float(got["classification"]) == 0.0 == float(got["detection"])
    for k in ("dehazing", "total"):
        np.testing.assert_allclose(float(got[k]), want_dehazing, rtol=ATOL, atol=ATOL,
                                   err_msg=k)
    want = port_of(create_branch_models(pcfg)["high"],
                   {"params": jgrads, "batch_stats": sub["batch_stats"]})
    g_max = max(float(q.detach().abs().max()) for q in want.parameters())
    for (n, p), q in zip(model.named_parameters(), want.parameters()):
        assert float((p.grad - q.detach()).abs().max()) <= ATOL * g_max, n


# ----------------------------------------------------------------- remat ---

def _counting(module, counts, name):
    module.register_forward_hook(lambda *_: counts.__setitem__(name, counts[name] + 1))
    counts[name] = 0


@pytest.mark.parametrize("remat", [True, "fullres"])
def test_remat_matches_no_remat(remat, loss_nets):
    """One soft joint step with the classifier's dropout on, under remat
    and without: the same losses, gradients and BN buffers (1e-6); the
    checkpointed regions ran their forward twice."""
    _, nets = loss_nets
    results = []
    for mode in (False, remat):
        _, pcfg = joint_configs()
        pcfg["cuda"]["remat"] = mode
        torch.manual_seed(0)
        router, state = tj.build_router_state(pcfg, "cpu")
        router.train()
        counts = {}     # forwards of one conv in each region, recomputes included
        _counting(router.classifier.backbone.conv1, counts, "classifier")
        _counting(router.models["low"].init_conv.block[0], counts, "low init_conv")
        _counting(router.models["high"].encoder[0][0].block[0], counts, "high encoder")
        step = tj.make_train_step(get_joint_loss(pcfg), nets, augmentation=False, remat=mode)
        comps = step(state, _torch_batch(_batch()), torch.Generator().manual_seed(3))
        results.append((comps, {n: p.grad.clone() for n, p in router.named_parameters()
                                if p.grad is not None},
                        {n: b.clone() for n, b in router.named_buffers()}, counts))
    (c0, g0, b0, n0), (c1, g1, b1, n1) = results
    assert n0 == {"classifier": 1, "low init_conv": 1, "high encoder": 1}
    if remat is True:
        assert n1 == {"classifier": 2, "low init_conv": 2, "high encoder": 2}
    else:
        assert n1 == {"classifier": 1, "low init_conv": 2, "high encoder": 1}
    for k in c0:
        np.testing.assert_allclose(float(c1[k]), float(c0[k]), rtol=1e-6, atol=1e-6)
    assert set(g1) == set(g0) and len(g0) > 0
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    for n in b0:
        np.testing.assert_allclose(b1[n].numpy(), b0[n].numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=n)


def test_remat_fullres_keeps_parameter_names_and_dehazing_step():
    """fullres leaves the state_dict keys alone, and the dehazing train
    step under remat true matches the plain one."""
    from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss
    from adam_dehaze_tpu_torch.training.train_dehazing import make_train_step
    _, plain = joint_configs()
    _, fullres = joint_configs()
    fullres["cuda"]["remat"] = "fullres"
    for level, model in create_branch_models(fullres).items():
        assert list(model.state_dict()) == list(create_branch_models(plain)[level].state_dict())
    loss = get_dehazing_loss(plain)
    nets = loss.init(torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        torch.manual_seed(1)
        model = create_branch_models(plain)["high"].train()
        state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
        make_train_step(loss, nets, augmentation=False, remat=remat)(
            state, _torch_batch(_batch()))
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- GatedRouter ---

def test_gated_router_loads_flax_variables_and_matches_eval_forward(router_vars):
    jcfg, pcfg = joint_configs("gated")
    vs = router_vars["gated"]
    x = images((2, 32, 32, 3), seed=9)
    router = JR.create_router(JB.create_branch_models(jcfg), JC.create_classifier(jcfg), jcfg)
    want, winfo = jax.jit(router.apply)(vs, jnp.asarray(x))
    port = port_of(create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg), vs)
    assert isinstance(port, GatedRouter)
    with torch.no_grad():
        got, info = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(info["gate_weights"].numpy(), np.asarray(winfo["gate_weights"]),
                               rtol=0, atol=ATOL)
