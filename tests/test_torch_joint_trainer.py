"""The port's joint trainer end to end against the JAX trainer, on the CPU
(tiny branch widths, resnet18, 32^2, batch 4, fp32, augmentation and
dropout off): a soft epoch, then a hard fine-tune epoch
(hard_finetune_frac 0.5) on a corpus that the JAX package writes, per-step
losses at 1e-3; then a resume, and serving the best checkpoint.

Batch 4: the frozen classifier's last BN stage then normalises four values
a channel in train mode (two at batch 2, where float32 alone moves its
cross-entropy by 3e-4; tests/test_torch_joint_training.py). Both trainers
start from the same variables (`jax_router_variables`: the JAX trainer's
`build_router_state` draws them by flax's init, which takes minutes on the
CPU unjitted); with no checkpoint to graft, that is all it does."""
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np

from adam_dehaze_tpu.losses.dehazing import get_joint_loss as jget_joint_loss
from adam_dehaze_tpu.models import branches as JB
from adam_dehaze_tpu.models import classifier as JC
from adam_dehaze_tpu.models import routing as JR
from adam_dehaze_tpu_torch.models.branches import create_branch_models
from adam_dehaze_tpu_torch.models.classifier import create_classifier
from adam_dehaze_tpu_torch.models.routing import create_router
from adam_dehaze_tpu_torch.training import checkpoint as ckpt
from adam_dehaze_tpu_torch.training import train_joint as tj
from adam_dehaze_tpu_torch.training.checkpoint import load_flax_variables
from torch_port_util import (
    as_np,
    flax_dropout_off,
    images,
    jax_router_variables,
    joint_configs,
    no_dropout_,
    port_loss_params,
    recording,
)


def test_train_joint_matches_jax_then_resumes_and_serves(tmp_path, monkeypatch):
    """Two epochs (hard_finetune_frac 0.5: one soft, one hard) on a corpus
    written by the JAX package: the port's trainer and the JAX trainer, from
    the same initial weights and loss nets, take the same steps with the
    same total losses (1e-3); the port writes best_model, resumes from it,
    and its router serves the checkpoint through route_hard."""
    from adam_dehaze_tpu.data.preprocessing import generate_synthetic_dataset
    from adam_dehaze_tpu.training import state as jstate
    from adam_dehaze_tpu.training import train_joint as jtj
    from adam_dehaze_tpu_torch.serving import AdaptiveDehazer

    flax_dropout_off(monkeypatch)
    jcfg, pcfg = joint_configs()
    root = str(tmp_path / "corpus")
    generate_synthetic_dataset(root, n_per_class=8, size=32, seed=0)
    for cfg, tag in ((jcfg, "jax"), (pcfg, "port")):
        cfg["dataset"].update(train_path=root, val_path=root, test_path=root, batch_size=4)
        cfg["joint_training"].update(epochs=2, hard_finetune_frac=0.5,
                                     checkpoint_dir=str(tmp_path / tag / "joint"))
        cfg["classifier"]["checkpoint_dir"] = str(tmp_path / tag / "none")
        cfg["dehazing"]["checkpoint_dir"] = str(tmp_path / tag / "none")
        cfg["_logs_dir"] = str(tmp_path / tag / "logs")

    init_vs = jax_router_variables("soft", seed=5)

    def jax_build(config, key):
        router = JR.create_router(JB.create_branch_models(config),
                                  JC.create_classifier(config), config)
        params, stats = (jax.tree_util.tree_map(jnp.asarray, init_vs[c])
                         for c in ("params", "batch_stats"))
        tx = jstate.make_optimizer(config["joint_training"]["learning_rate"])
        return router, jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                         batch_stats=stats, opt_state=tx.init(params)), tx

    build = tj.build_router_state

    def port_build(config, device, generator=None):
        router, state = build(config, device, generator)
        load_flax_variables(router, init_vs)
        return no_dropout_(router), state

    # The loss nets' flax init (JointLoss.init(PRNGKey(0)) in the JAX
    # trainer), jitted: the same variables in seconds, not a minute.
    init = flax.linen.Module.init
    monkeypatch.setattr(flax.linen.Module, "init",
                        lambda self, rngs, *args: jax.jit(
                            lambda r, *a: init(self, r, *a))(rngs, *args))
    monkeypatch.setattr(jtj, "build_router_state", jax_build)
    monkeypatch.setattr(tj, "build_router_state", port_build)
    j_steps, p_steps, p_starts = [], [], []
    for name in ("make_train_step", "make_hard_branch_step"):
        monkeypatch.setattr(jtj, name, recording(jtj, name, "total", j_steps))
        monkeypatch.setattr(tj, name, recording(tj, name, "total", p_steps, p_starts))
    jtj.train_joint_model(jcfg)
    nets = port_loss_params(as_np(jget_joint_loss(jcfg).init(jax.random.PRNGKey(0),
                                                             (1, 32, 32, 3))))
    router, state = tj.train_joint_model(pcfg, device="cpu", loss_params=nets)

    assert len(p_steps) == len(j_steps) == 6      # 3 soft (12 images), 3 hard (4 a level)
    np.testing.assert_allclose(p_steps, j_steps, rtol=0, atol=1e-3)
    ck_dir = pcfg["joint_training"]["checkpoint_dir"]
    assert sorted(os.listdir(ck_dir)) == ["best_model.metrics.json", "best_model.pth"]
    out = tj.evaluate_joint_model(router, state, pcfg)
    assert np.isfinite(out["psnr"]) and 0 <= out["ssim"] <= 1 and 0 <= out["cls_acc"] <= 1

    # Resume (soft only now): from the best checkpoint's epoch and step.
    best_tree, best_metrics = ckpt.load_checkpoint(ckpt.best_model_path(ck_dir))
    best_epoch = int(best_metrics["epoch"])
    assert best_tree["step"] == 3             # the hard epoch steps the branches' own states
    p_steps.clear()
    p_starts.clear()
    pcfg["joint_training"].update(epochs=3, hard_finetune_frac=0.0)
    tj.train_joint_model(pcfg, resume=True, device="cpu", loss_params=nets)
    assert p_starts == list(range(3, 3 + 3 * (3 - best_epoch)))
    log = [json.loads(s) for s in open(os.path.join(pcfg["_logs_dir"], "joint",
                                                    "metrics.jsonl"))]
    assert [r["step"] for r in log] == [0, 1] + list(range(best_epoch, 3))

    # The best checkpoint serves: route_hard on a fresh router.
    fresh = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
    fresh.load_state_dict(ckpt.load_checkpoint(ckpt.best_model_path(ck_dir))[0]["model"])
    d = AdaptiveDehazer(fresh, None, pcfg, device="cpu")
    y, labels = d.route_hard(images((3, 32, 32, 3), seed=2))
    assert y.shape == (3, 32, 32, 3) and np.isfinite(y).all() and len(labels) == 3
