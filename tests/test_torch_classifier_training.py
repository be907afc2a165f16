"""The port's classifier trainer against the JAX package, on the CPU: one
train step (32^2, batch 2, augmentation and dropout off) against the JAX
step on the same seeded weights: loss and accuracy at 1e-4, every gradient
at 1e-4 of the largest gradient magnitude (fp32, matmul precision
"highest"), the BN running statistics as flax's once torch's unbiased batch
variance is mapped to flax's biased one; the head's dropout against its
stated rates and its generator; `classifier.pretrained`; the trainer end
to end against the JAX trainer on a corpus that the JAX package writes
(per-step losses at 1e-3), then a resume; and `evaluate_classifier`'s numpy
confusion matrix and report against sklearn's.

Dropout is off on both sides inside the tests that compare with JAX (the
two frameworks draw different masks): flax's Dropout is monkeypatched to
the identity and the port's dropouts get p = 0."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from adam_dehaze_tpu.config import default_config
from adam_dehaze_tpu.models.classifier import create_classifier as jcreate
from adam_dehaze_tpu_torch.config import load_config
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.nn.blocks import Dropout
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training import train_classifier as tc
from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
from torch_port_util import (
    ATOL,
    assert_bn_stats_match_flax,
    flax_dropout_off,
    images,
    init_flax,
    no_dropout_,
    port_of,
    recording,
)


def tiny_configs():
    """(JAX config, port config): resnet18 at 32^2, batch 2, fp32,
    augmentation off."""
    jcfg = default_config()
    pcfg = load_config(overrides={"cuda": {"compute_dtype": "float32"}})
    for cfg in (jcfg, pcfg):
        cfg["dataset"].update(img_size=32, batch_size=2, num_workers=2, augmentation=False)
        cfg["classifier"]["epochs"] = 1
    jcfg["tpu"].update(compute_dtype="float32", use_pallas=False)
    return jcfg, pcfg


@pytest.fixture
def no_flax_dropout(monkeypatch):
    flax_dropout_off(monkeypatch)


# --------------------------------------------------------------- dropout ---

@pytest.mark.parametrize("p", [0.3, 0.2])
def test_dropout_rate_scale_and_generator(p):
    drop = Dropout(p).train()
    x = torch.ones(400, 500)
    a = drop(x, torch.Generator().manual_seed(1))
    b = drop(x, torch.Generator().manual_seed(1))
    c = drop(x, torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    kept = a != 0
    assert abs(float(kept.float().mean()) - (1 - p)) < 5e-3      # 200000 draws
    torch.testing.assert_close(a[kept], torch.full_like(a[kept], 1 / (1 - p)))
    assert drop.eval()(x, torch.Generator()) is x
    assert Dropout(0.0).train()(x) is x


def test_classifier_dropout_draws_from_the_given_generator():
    pcfg = tiny_configs()[1]
    model = create_classifier(pcfg).train()
    x = torch.from_numpy(images((2, 32, 32, 3), seed=1))
    gens = [torch.Generator().manual_seed(s) for s in (5, 5, 6)]
    outs = [model(x, g)[0] for g in gens]
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], outs[2])
    # Both dropouts draw from it: a (2, 512) mask at 0.3, then (2, 256) at 0.2.
    g = torch.Generator().manual_seed(5)
    torch.empty(2, 512).bernoulli_(0.7, generator=g)
    torch.empty(2, 256).bernoulli_(0.8, generator=g)
    assert torch.equal(g.get_state(), gens[0].get_state())
    model.eval()
    torch.testing.assert_close(model(x, gens[2])[0], model(x)[0], rtol=0, atol=0)


# ------------------------------------------------------------ the step ---

def test_train_step_matches_jax(no_flax_dropout):
    """64^2, batch 4, the default resnet18. The JAX step runs in float64:
    in float32 its own gradients of the first conv and layer1 are up to
    1e-2 of the largest gradient off float64 (flax's train-mode BN takes
    the variance as E[x^2] - E[x]^2), where the port's float32 step stays
    within 1e-5 of it."""
    jcfg, pcfg = tiny_configs()
    # 64^2, batch 4: the last stage's train-mode BN then normalises 16
    # values a channel (at 32^2, batch 2, only 2: an ill-conditioned step).
    x = images((4, 64, 64, 3), seed=10)
    labels = np.array([2, 0, 1, 1])
    vs = init_flax(jcreate(jcfg), x, seed=3)
    with jax.enable_x64(True):
        jcfg["tpu"]["compute_dtype"] = "float64"
        jmodel = jcreate(jcfg)
        p64, bs64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), vs[c])
                     for c in ("params", "batch_stats"))

        def loss_fn(params):
            (logits, _), mut = jmodel.apply({"params": params, "batch_stats": bs64},
                                            jnp.asarray(x, jnp.float64), True,
                                            mutable=["batch_stats"],
                                            rngs={"dropout": jax.random.PRNGKey(0)})
            loss = jnp.mean(optax.softmax_cross_entropy_with_integer_labels(logits, labels))
            acc = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
            return loss, (mut["batch_stats"], acc)

        (jloss, (jbs, jacc)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p64)
        jloss, jacc = float(jloss), float(jacc)
        jbs, jgrads = (jax.tree_util.tree_map(np.asarray, t) for t in (jbs, jgrads))

    model = no_dropout_(port_of(create_classifier(pcfg), vs).train())
    state = TrainState(model, make_optimizer(model.parameters(), 1e-4, 1e-4))
    m = tc.make_train_step(augmentation=False)(
        state, {"hazy": torch.from_numpy(x), "intensity": torch.from_numpy(labels)})
    assert state.step == 1
    np.testing.assert_allclose(float(m["loss"]), jloss, rtol=ATOL, atol=ATOL)
    assert float(m["acc"]) == jacc
    want = port_of(create_classifier(pcfg), {"params": jgrads,
                                             "batch_stats": vs["batch_stats"]})
    g_max = max(float(q.detach().abs().max()) for q in want.parameters())
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        assert float((p.grad - q.detach()).abs().max()) <= ATOL * g_max, name
    # BN statistics, flax's mapped to torch's unbiased running variance.
    assert_bn_stats_match_flax(model, port_of(create_classifier(pcfg), vs),
                               port_of(create_classifier(pcfg), {
                                   "params": vs["params"], "batch_stats": jbs}),
                               torch.from_numpy(x))


# ------------------------------------------------------------ pretrained ---

def test_pretrained_whole_classifier_backbone_or_true(tmp_path, capsys):
    pcfg = tiny_configs()[1]
    source = tc.init_classifier(load_config(overrides={"seed": 7}), "cpu")
    whole = ckpt.save_checkpoint(str(tmp_path), "whole", {"model": source.state_dict()})
    # A torchvision resnet's own keys, its fc included (the backbone drops it).
    tv = {k.removeprefix("backbone."): v for k, v in source.state_dict().items()
          if k.startswith("backbone.")}
    tv.update({"fc.weight": torch.zeros(1000, 512), "fc.bias": torch.zeros(1000)})
    backbone = ckpt.save_checkpoint(str(tmp_path), "tv", tv)
    fresh = tc.init_classifier(pcfg, "cpu")

    pcfg["classifier"]["pretrained"] = whole
    got = tc.init_classifier(pcfg, "cpu")
    for (k, a), b in zip(got.state_dict().items(), source.state_dict().values()):
        assert torch.equal(a, b), k
    pcfg["classifier"]["pretrained"] = backbone
    got = tc.init_classifier(pcfg, "cpu").state_dict()
    for k, a in got.items():
        want = (source if k.startswith("backbone.") else fresh).state_dict()[k]
        assert torch.equal(a, want), k
    pcfg["classifier"]["pretrained"] = True
    got = tc.init_classifier(pcfg, "cpu").state_dict()
    assert all(torch.equal(a, fresh.state_dict()[k]) for k, a in got.items())
    assert "pretrained=true ignored" in capsys.readouterr().out


# --------------------------------------------------------------- trainer ---

def test_train_classifier_matches_jax_then_resumes(tmp_path, monkeypatch, no_flax_dropout):
    """One epoch on a corpus written by the JAX package: the port's trainer
    and the JAX trainer, from the same initial weights, take the same steps
    with the same losses (1e-3); the port writes best_model, a resume with
    two epochs continues from epoch 1 with the saved Adam state, and the
    test-split report is the numpy one."""
    from adam_dehaze_tpu.data.preprocessing import generate_synthetic_dataset
    from adam_dehaze_tpu.training import train_classifier as jtc

    root = str(tmp_path / "corpus")
    generate_synthetic_dataset(root, n_per_class=8, size=64, seed=0)
    jcfg, pcfg = tiny_configs()
    for cfg, tag in ((jcfg, "jax"), (pcfg, "port")):
        # 64^2, batch 4, as in test_train_step_matches_jax.
        cfg["dataset"].update(train_path=root, val_path=root, test_path=root,
                              img_size=64, batch_size=4)
        cfg["classifier"]["checkpoint_dir"] = str(tmp_path / tag / "ck")
        cfg["_logs_dir"] = str(tmp_path / tag / "logs")

    j_steps, p_steps, p_starts = [], [], []
    monkeypatch.setattr(jtc, "make_train_step",
                        recording(jtc, "make_train_step", "loss", j_steps))
    monkeypatch.setattr(tc, "make_train_step",
                        recording(tc, "make_train_step", "loss", p_steps, p_starts))
    # The JAX trainer computes in float64 (its parameters stay float32): in
    # float32 its own BN variance (E[x^2] - E[x]^2) puts its third step's
    # loss 1e-3 away from the port's (see test_train_step_matches_jax).
    with jax.enable_x64(True):
        jtc.train_classifier({**jcfg, "tpu": {**jcfg["tpu"], "compute_dtype": "float64"}})
    # The JAX trainer's own initial weights: model.init(PRNGKey(seed), zeros).
    key = jax.random.PRNGKey(jcfg["seed"])
    init_vs = jcreate(jcfg).init({"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)))
    monkeypatch.setattr(tc, "init_classifier", lambda config, device: no_dropout_(
        port_of(create_classifier(config), init_vs)).to(device))
    model, state = tc.train_classifier(pcfg, device="cpu")

    assert len(p_steps) == len(j_steps) == 3          # 12 train images, batch 4
    np.testing.assert_allclose(p_steps, j_steps, rtol=0, atol=1e-3)
    ck_dir = pcfg["classifier"]["checkpoint_dir"]
    assert sorted(os.listdir(ck_dir)) == ["best_model.metrics.json", "best_model.pth"]
    assert state.step == 3

    out = tc.evaluate_classifier(model, state, pcfg)
    cm = np.asarray(out["confusion_matrix"])
    assert cm.shape == (3, 3) and cm.sum() == 6       # 2 test images a class
    assert out["accuracy"] == pytest.approx(np.trace(cm) / 6)
    assert out["report"]["accuracy"] == pytest.approx(out["accuracy"])

    p_steps.clear()
    p_starts.clear()
    pcfg["classifier"]["epochs"] = 2
    _, resumed = tc.train_classifier(pcfg, resume=True, device="cpu")
    assert p_starts == [3, 4, 5]        # one more epoch, from the saved step
    # The returned state is the best by validation accuracy: epoch 1's
    # unless epoch 2 beat it.
    best_epoch = ckpt.load_checkpoint(ckpt.best_model_path(ck_dir))[1]["epoch"]
    assert resumed.step == 3 * best_epoch
    adam = resumed.optimizer.state_dict()["state"]
    assert all(float(s["step"]) == resumed.step for s in adam.values())
    log = [json.loads(s) for s in open(os.path.join(pcfg["_logs_dir"], "classifier",
                                                    "metrics.jsonl"))]
    assert [r["step"] for r in log] == [0, 1]


# ---------------------------------------------------------------- report ---

@pytest.mark.parametrize("case", ["random", "class_never_predicted", "class_absent"])
def test_confusion_matrix_and_report_match_sklearn(case):
    metrics = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(len(case))
    labels = rng.integers(0, 3, 40)
    preds = np.where(rng.random(40) < 0.6, labels, rng.integers(0, 3, 40))
    if case == "class_never_predicted":
        preds = np.where(preds == 1, 0, preds)
    elif case == "class_absent":
        keep = labels != 2
        labels, preds = labels[keep], preds[keep]
    cm = tc.confusion_matrix(labels, preds)
    np.testing.assert_array_equal(cm, metrics.confusion_matrix(labels, preds, labels=[0, 1, 2]))
    want = metrics.classification_report(labels, preds, labels=[0, 1, 2],
                                         target_names=["low", "medium", "high"],
                                         output_dict=True, zero_division=0)
    got = tc.classification_report(cm)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
            for m, x in v.items():
                assert got[k][m] == pytest.approx(x, abs=1e-12), (k, m)
        else:
            assert got[k] == pytest.approx(v, abs=1e-12), k
