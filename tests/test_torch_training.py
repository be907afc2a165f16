"""The port's trainer pieces against the JAX package, on the CPU: Adam
against optax (with and without weight decay, 1e-6), the plateau scheduler
step for step, checkpoints and resume, the batch plumbing, and one train
step of each default branch (32^2, tiny widths, augmentation off) against
the JAX step on the same seeded weights and loss nets: loss components at
1e-4, every gradient at 1e-4 of the branch's largest gradient magnitude
(fp32, matmul precision "highest"). Per tensor that bound is too tight for
f32 itself: against a float64 run, the attention MLP's small gradients
carry about 1e-4 of their own magnitude in both frameworks, and the
transposed convs' biases before a train-mode BN have a gradient that is 0
up to rounding."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adam_dehaze_tpu.config import default_config
from adam_dehaze_tpu.losses.dehazing import get_dehazing_loss as jget_loss
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.training import state as jstate
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.losses.dehazing import get_dehazing_loss
from adam_dehaze_tpu_torch.models import branches as PB
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training import common
from adam_dehaze_tpu_torch.training.logging import MetricsLogger
from adam_dehaze_tpu_torch.training.state import (
    ReduceLROnPlateau,
    TrainState,
    get_learning_rate,
    make_optimizer,
    set_learning_rate,
)
from adam_dehaze_tpu_torch.training.train_dehazing import make_train_step
from torch_port_util import ATOL, images, init_flax, port_loss_params, port_of

WIDTHS = {"low": (4, 1), "medium": (4, 2), "high": (8, 2)}


def tiny_configs():
    """(JAX config, port config): the tiny fp32 widths of
    tests/test_training.py, 32^2, augmentation off."""
    jcfg = default_config()
    pcfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for cfg in (jcfg, pcfg):
        for level, (c, b) in WIDTHS.items():
            cfg["dehazing"][level].update(channels=c, blocks=b)
        cfg["dataset"].update(img_size=32, batch_size=2, num_workers=2, augmentation=False)
        cfg["dehazing"]["epochs"] = 1
    jcfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    return jcfg, pcfg


# --------------------------------------------------------- the optimiser ---

@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_matches_optax(weight_decay):
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jstate.make_optimizer(1e-3, weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), 1e-3, weight_decay)
    for step in range(6):
        grads = {k: rng.normal(size=s).astype(np.float32) * 10 ** -step
                 for k, s in shapes.items()}
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)


def test_learning_rate_get_and_set_keep_the_moments():
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], 1e-3)
    p.grad = torch.ones(3)
    opt.step()
    moments = opt.state[p]["exp_avg"].clone()
    set_learning_rate(opt, 5e-4)
    assert get_learning_rate(opt) == 5e-4
    assert torch.equal(opt.state[p]["exp_avg"], moments)


@pytest.mark.parametrize("mode,patience", [("min", 2), ("max", 1), ("min", 0)])
def test_plateau_scheduler_step_for_step(mode, patience):
    metrics = [1.0, 0.9, 0.9, 0.95, 0.89995, 0.91, 0.92, 0.5, 0.6, 0.6, 0.6, 0.7, 0.4]
    jsch = jstate.ReduceLROnPlateau(factor=0.5, patience=patience, min_lr=1e-4, mode=mode)
    psch = ReduceLROnPlateau(factor=0.5, patience=patience, min_lr=1e-4, mode=mode)
    tx = jstate.make_optimizer(1e-3)
    jst = tx.init({"w": jnp.ones(())})
    opt = make_optimizer([torch.nn.Parameter(torch.ones(()))], 1e-3)
    for m in metrics:
        jst, j_red = jsch.step(m, jst)
        assert psch.step(m, opt) == j_red
        assert get_learning_rate(opt) == pytest.approx(jstate.get_learning_rate(jst), rel=1e-6)
        assert psch.num_bad == jsch.num_bad and psch.best == jsch.best


# ----------------------------------------------------------- checkpoints ---

def test_checkpoint_roundtrip_and_latest(tmp_path):
    d = str(tmp_path)
    assert ckpt.find_latest_checkpoint(d) is None
    assert ckpt.find_latest_checkpoint(str(tmp_path / "absent")) is None
    tree = {"model": {"w": torch.arange(4.0)}, "step": 3}
    path = ckpt.save_checkpoint(d, "best_model", tree, {"val_psnr": 31.5, "epoch": 2})
    assert path == ckpt.best_model_path(d) and path.endswith("best_model.pth")
    assert os.path.exists(os.path.join(d, "best_model.metrics.json"))
    state, metrics = ckpt.load_checkpoint(path)
    assert torch.equal(state["model"]["w"], torch.arange(4.0)) and state["step"] == 3
    assert metrics == {"val_psnr": 31.5, "epoch": 2.0}
    assert ckpt.find_latest_checkpoint(d) == path          # best_model as fallback
    for n in (2, 10, 9):
        ckpt.save_checkpoint(d, f"checkpoint_epoch_{n}", tree)
    assert ckpt.find_latest_checkpoint(d) == os.path.join(d, "checkpoint_epoch_10.pth")
    assert ckpt.load_checkpoint(ckpt.find_latest_checkpoint(d))[1] == {}
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_state_tree_roundtrip_continues_adam(tmp_path):
    """A saved state, loaded into a fresh module and optimiser, takes the
    next step exactly as the original does."""
    gen = torch.Generator().manual_seed(0)

    def fresh():
        m = torch.nn.Linear(4, 3)
        return TrainState(m, make_optimizer(m.parameters(), 1e-2, 1e-3))

    def step(state, x):
        state.optimizer.zero_grad()
        state.module(x).pow(2).sum().backward()
        state.optimizer.step()
        state.step += 1

    a = fresh()
    xs = [torch.randn(5, 4, generator=gen) for _ in range(3)]
    step(a, xs[0])
    step(a, xs[1])
    path = ckpt.save_checkpoint(str(tmp_path), "s", common.state_to_tree(a))
    b = common.tree_to_state(fresh(), ckpt.load_checkpoint(path)[0])
    assert b.step == 2
    step(a, xs[2])
    step(b, xs[2])
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------- plumbing ---

def test_masked_mean_device_batch_and_prefetch():
    v = torch.tensor([1.0, 2.0, 3.0, 4.0])
    assert float(common.masked_mean(v, torch.tensor([True, True, False, False]))) == 1.5
    assert float(common.masked_mean(v, torch.zeros(4, dtype=torch.bool))) == 0.0
    batches = [{"hazy": np.full((2, 4, 4, 3), i, np.float32), "mask": np.array([True, i > 0]),
                "name": ["a", "b"]} for i in range(5)]
    got = list(common.device_prefetch(batches, "cpu", depth=2))
    assert len(got) == 5 and set(got[0]) == {"hazy", "mask"}
    for i, b in enumerate(got):
        assert float(b["hazy"][0, 0, 0, 0]) == i and b["mask"].dtype == torch.bool
    assert list(common.device_prefetch([], "cpu")) == []


def test_metrics_logger_writes_jsonl(tmp_path):
    log = MetricsLogger(str(tmp_path / "logs"), enable_tensorboard=False)
    log.scalars(0, {"loss": 1.5, "psnr": np.float32(20.0)})
    log.scalars(1, {"loss": 1.0}, prefix="val/")
    log.images(0, "x", np.zeros((1, 4, 4, 3)))
    log.close()
    lines = [json.loads(s) for s in open(tmp_path / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in lines] == [0, 1]
    assert lines[0]["psnr"] == 20.0 and lines[1]["val/loss"] == 1.0


# ------------------------------------------------- one step of each branch ---

@pytest.fixture(scope="module")
def loss_nets():
    jcfg, pcfg = tiny_configs()
    jloss = jget_loss(jcfg)
    jlp = jax.jit(lambda k: jloss.init(k, (1, 32, 32, 3)))(jax.random.PRNGKey(0))
    return jloss, jlp, get_dehazing_loss(pcfg), port_loss_params(jlp)


JAX_FACTORY = {"low": JB.create_low_intensity_model,
               "medium": JB.create_medium_intensity_model,
               "high": JB.create_high_intensity_model}
PORT_FACTORY = {"low": PB.create_low_intensity_model,
                "medium": PB.create_medium_intensity_model,
                "high": PB.create_high_intensity_model}


@pytest.mark.parametrize("level", ["low", "medium", "high"])
def test_train_step_matches_jax(level, loss_nets):
    jloss, jlp, ploss, nets = loss_nets
    jcfg, pcfg = tiny_configs()
    hazy = images((2, 32, 32, 3), seed=10)
    clear = images((2, 32, 32, 3), seed=11)
    jmodel = JAX_FACTORY[level](jcfg)
    vs = init_flax(jmodel, hazy, seed=3)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": vs["batch_stats"]},
                              jnp.asarray(hazy), True, mutable=["batch_stats"])
        return jloss(jlp, out, jnp.asarray(clear), hazy=jnp.asarray(hazy))

    (_, jcomps), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(vs["params"])

    model = port_of(PORT_FACTORY[level](pcfg), vs).train()
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4))
    before = [p.detach().clone() for p in model.parameters()]
    comps = make_train_step(ploss, nets, augmentation=False)(
        state, {"hazy": torch.from_numpy(hazy), "clear": torch.from_numpy(clear)})
    assert state.step == 1
    for k in ("l1", "content", "perceptual", "total"):
        np.testing.assert_allclose(float(comps[k]), float(jcomps[k]), rtol=ATOL, atol=ATOL)
    want = port_of(PORT_FACTORY[level](pcfg), {
        "params": jax.tree_util.tree_map(np.asarray, jgrads),
        "batch_stats": vs["batch_stats"]})
    g_max = max(float(q.detach().abs().max()) for q in want.parameters())
    for (name, p), q, p0 in zip(model.named_parameters(), want.parameters(), before):
        assert p.grad is not None, name
        assert float((p.grad - q.detach()).abs().max()) <= ATOL * g_max, name
        # The first Adam step moves each weight by about lr, against the gradient.
        moved = (p.detach() - p0)[q.detach().abs() > 1e-3 * g_max]
        assert moved.numel() == 0 or float(moved.abs().max()) <= 1.01e-4


# ------------------------------------------------ the low-branch trainer ---

def _recording(module, records):
    """Wrap a trainer module's make_train_step so that every step's total
    loss lands in `records`."""
    original = module.make_train_step

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(*a):
            out = step(*a)
            comps = out[1] if isinstance(out, tuple) else out
            records.append(float(comps["total"]))
            return out
        return recorded
    return make


def test_train_dehazing_low_matches_jax_then_resumes(loss_nets, tmp_path, monkeypatch):
    """One epoch of the low branch on a corpus written by the JAX package:
    the port's trainer and the JAX trainer, on the same initial weights and
    loss nets, take the same steps with the same train losses (1e-3); the
    port writes its checkpoint, evaluates to a finite PSNR above 5, and a
    resume with two epochs continues from epoch 1 with the saved Adam
    state."""
    from adam_dehaze_tpu.data.preprocessing import generate_synthetic_dataset
    from adam_dehaze_tpu.training import train_dehazing as jtd
    from adam_dehaze_tpu_torch.training import train_dehazing as ptd

    root = str(tmp_path / "corpus")
    generate_synthetic_dataset(root, n_per_class=12, size=32, seed=0)
    jcfg, pcfg = tiny_configs()
    for cfg, tag in ((jcfg, "jax"), (pcfg, "port")):
        cfg["dataset"].update(train_path=root, val_path=root, test_path=root)
        cfg["dehazing"]["checkpoint_dir"] = str(tmp_path / tag / "ck")
        cfg["_logs_dir"] = str(tmp_path / tag / "logs")
    jloss, jlp, _, nets = loss_nets

    j_steps, p_steps = [], []
    monkeypatch.setattr(jtd, "make_train_step", _recording(jtd, j_steps))
    monkeypatch.setattr(ptd, "make_train_step", _recording(ptd, p_steps))
    jtd.train_dehazing_model("low", jcfg, loss_params=jlp)
    # The JAX trainer's own initial weights: model.init(PRNGKey(seed + 0), zeros).
    jmodel = JB.create_low_intensity_model(jcfg)
    init_vs = jmodel.init(jax.random.PRNGKey(jcfg["seed"]), jnp.zeros((1, 32, 32, 3)))
    monkeypatch.setattr(ptd, "init_branch", lambda level, config, device: port_of(
        PB.create_low_intensity_model(config), init_vs).to(device))
    model, state = ptd.train_dehazing_model("low", pcfg, loss_params=nets, device="cpu")

    assert len(p_steps) == len(j_steps) == 3          # 6 train images, batch 2
    np.testing.assert_allclose(p_steps, j_steps, rtol=0, atol=1e-3)
    ck_dir = os.path.join(pcfg["dehazing"]["checkpoint_dir"], "low")
    assert sorted(os.listdir(ck_dir)) == ["best_model.metrics.json", "best_model.pth"]
    out = ptd.evaluate_dehazing_model(model, state, "low", pcfg)
    assert np.isfinite(out["psnr"]) and out["psnr"] > 5 and 0 <= out["ssim"] <= 1
    assert state.step == 3

    p_steps.clear()
    pcfg["dehazing"]["epochs"] = 2
    _, resumed = ptd.train_dehazing_model("low", pcfg, resume=True, loss_params=nets,
                                          device="cpu")
    assert len(p_steps) == 3 and resumed.step == 6       # one more epoch
    adam = resumed.optimizer.state_dict()["state"]
    assert all(float(s["step"]) == 6 for s in adam.values())
    log = [json.loads(s) for s in open(os.path.join(pcfg["_logs_dir"], "dehazing", "low",
                                                    "metrics.jsonl"))]
    assert [r["step"] for r in log] == [0, 1]
