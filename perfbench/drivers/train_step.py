"""The soft joint train step, steps back to back.

The program's `make_train_step` (training/train_joint.py) over the
configuration's router (the classifier frozen, in train mode), the
JointLoss with its loss nets, Adam at `joint_training.learning_rate`, the
augmentation on, under autocast in the configuration's compute dtype. The
feed is a pool of `pool_batches` triplets of `batch` images (hazy, clear and
a stand-in for the dataset's dehazed image, fog level i.i.d. per image),
made on the card from the seed, cycled; the step's generator is seeded from
the seed.

Set-up builds the one train state the window uses and drives it through its
first `compared_steps` steps on distinct batches: their losses, the first
gradient as Adam holds it, and the parameters after them are what the
reference is compared with once the window has closed.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from perfbench import harness
from perfbench.inputs import draw_state, generator, hazy_images, make_weights
from perfbench.reference import train as ref_train
from perfbench.reference.layers import set_rounding
from perfbench.reference.models import INTENSITY_ORDER, Router

SPANS = ("step",)


def loss_states(seed: int, device) -> dict:
    """The loss nets' weights, drawn from the seed."""
    with torch.device("meta"):
        nets = ref_train.loss_nets()
    return {name: draw_state(net, seed, 2 + i, device) for i, (name, net) in
            enumerate(sorted(nets.items()))}


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(program) - norm(reference)| over the larger of
    the reference leaf's norm and the median leaf's, over the leaves in
    `keep` (all by default); NaN where the program's leaf is not finite."""
    names = [k for k in ref if keep is None or k in keep]
    ref_n = {k: float(ref[k].norm()) for k in names}
    median = float(np.median(list(ref_n.values())))
    return {k: abs(float(prog[k].norm()) - ref_n[k]) / max(ref_n[k], median) for k in names}


def worst(gaps: dict) -> float:
    """The largest gap; NaN where any is."""
    values = list(gaps.values())
    return float("nan") if any(v != v for v in values) else float(max(values))


class Cell:
    """One run of the train cell: set-up with the compared steps, the timed
    window, the traced window, the comparison with the reference."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.port = config["port"]
        self.size = self.port["dataset"]["img_size"]
        self.batch = traffic["batch"]
        self.rng = np.random.default_rng(self.seed % 2 ** 63)

    # --- set-up -------------------------------------------------------------

    def _pool(self):
        t, n = self.traffic, self.batch
        gen = generator(self.seed, 3, self.device)
        labels = torch.as_tensor(self.rng.choice(
            len(t["levels"]), p=t["level_probs"], size=t["pool_batches"] * n),
            device=self.device)
        hazy, clear = hazy_images(labels, self.size, t["beta"], t["depth_m"], t["airlight"], gen)
        dehazed = 0.5 * (hazy + clear)
        return [{"hazy": hazy[i * n:(i + 1) * n], "clear": clear[i * n:(i + 1) * n],
                 "dehazed": dehazed[i * n:(i + 1) * n],
                 "intensity": labels[i * n:(i + 1) * n]} for i in range(t["pool_batches"])]

    def setup(self) -> None:
        mark = harness.Marks()
        from adam_dehaze_tpu_torch.config import compute_dtype
        from adam_dehaze_tpu_torch.losses.dehazing import CONTENT_TAPS, get_joint_loss
        from adam_dehaze_tpu_torch.losses.lpips import LPIPS
        from adam_dehaze_tpu_torch.models.branches import create_branch_models
        from adam_dehaze_tpu_torch.models.classifier import create_classifier
        from adam_dehaze_tpu_torch.models.routing import create_router
        from adam_dehaze_tpu_torch.nn.vgg import VGG16Features
        from adam_dehaze_tpu_torch.training import train_joint
        from adam_dehaze_tpu_torch.training.remat import remat_mode
        from adam_dehaze_tpu_torch.training.state import TrainState, make_optimizer
        mark("program imports")
        pcfg = self.pcfg = harness.port_config(self.config)
        self.state = make_weights(self.port, self.seed, self.device)
        self.loss_state = loss_states(self.seed, self.device)
        mark("weights")
        with torch.device("meta"):
            router = create_router(create_branch_models(pcfg), create_classifier(pcfg), pcfg)
        router = router.to_empty(device=self.device)
        router.load_state_dict(self.state)
        router.classifier.requires_grad_(False)
        router.train()
        with torch.device(self.device):
            nets = {"content": VGG16Features(taps=CONTENT_TAPS), "lpips": LPIPS()}
        for name, net in nets.items():
            net.load_state_dict(self.loss_state[name])
            net.requires_grad_(False).eval()
        self.names = [k for k, p in router.named_parameters() if p.requires_grad]
        params = [p for p in router.parameters() if p.requires_grad]
        self.train_state = TrainState(router, make_optimizer(
            params, pcfg["joint_training"]["learning_rate"]))
        self.step = train_joint.make_train_step(
            get_joint_loss(pcfg), nets, augmentation=bool(pcfg["dataset"]["augmentation"]),
            remat=remat_mode(pcfg), dtype=compute_dtype(pcfg))
        mark("program")
        self.pool = self._pool()
        self.order = self.rng.permutation(len(self.pool))
        mark("inputs")
        self.gen = generator(self.seed, 4, self.device)
        self.steps_done = 0
        # The compared steps, through the window's own call and feed.
        named = dict(router.named_parameters())
        self.theta0 = {k: named[k].detach().clone() for k in self.names}
        self.losses = []
        for i in range(self.traffic["compared_steps"]):
            self.losses.append(self.call()["total"])
            if i == 0:
                opt = self.train_state.optimizer
                beta1 = opt.param_groups[0]["betas"][0]
                # An optimizer that took no step holds no moment: a zero one.
                self.grad1 = {k: opt.state.get(named[k], {}).get(
                    "exp_avg", torch.zeros_like(named[k])) / (1 - beta1) for k in self.names}
        self.sync()
        self.theta3 = {k: named[k].detach().clone() for k in self.names}
        self.losses = [float(v) for v in self.losses]
        mark("compared steps")
        for _ in range(self.traffic["warmup_steps"]):
            self.call()
        self.sync()
        mark("warm-up")
        self.setup_phases = mark.phases

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self, spans: bool = False) -> dict:
        """One step on the next batch of the pool."""
        k = self.order[self.steps_done % len(self.order)]
        self.steps_done += 1
        span = torch.profiler.record_function("step") if spans else contextlib.nullcontext()
        with span:
            return self.step(self.train_state, self.pool[k], self.gen)

    # --- the window ---------------------------------------------------------

    def window(self, seconds: float) -> dict:
        """Steps back to back until `seconds` have passed; the clock stops
        once the card has finished every step started before then."""
        steps = 0
        self.sync()
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            last = self.call()
            steps += 1
        self.sync()
        elapsed = time.perf_counter() - start
        failed = int(not bool(torch.isfinite(last["total"]))) if steps else 0
        return {"attempted": steps, "failed": failed, "elapsed_s": elapsed, "steps": steps,
                "train_step_ms": elapsed * 1e3 / steps if steps else float("inf")}

    def traced(self) -> dict:
        from adam_dehaze_tpu_torch.ops.kernels import launch_counters
        n = self.traffic["trace_steps"]
        counters = launch_counters()
        self.sync()
        before = {k: f.launches for k, f in counters.items()}
        with harness.profiled() as prof:
            with torch.profiler.record_function("perfbench.window"):
                for _ in range(n):
                    self.call(spans=True)
                self.sync()
        return {"trace": harness.Trace.from_profiler(prof, "perfbench.window"),
                "launches": {k: f.launches - before[k] for k, f in counters.items()},
                "calls": n, "spans": SPANS,
                "images_by_branch": {lvl: n * self.batch for lvl in INTENSITY_ORDER}}

    def flops(self) -> dict:
        """Model FLOPs of one step, forward and backward, counted by
        FlopCounterMode on the reference step on the meta device."""
        from torch.utils.flop_counter import FlopCounterMode
        with torch.device("meta"):
            ref = Router(self.port)
            ref.classifier.requires_grad_(False)
            nets = ref_train.loss_nets()
            for net in nets.values():
                net.requires_grad_(False).eval()
            n, s = self.batch, self.size
            batch = {"hazy": torch.empty(n, s, s, 3), "clear": torch.empty(n, s, s, 3),
                     "intensity": torch.zeros(n, dtype=torch.long)}
            counter = FlopCounterMode(display=False)
            with counter:
                ref_train.train_step(ref.train(), nets, None, batch, None, self.pcfg)
        return {"step": float(counter.get_total_flops())}

    # --- correctness ----------------------------------------------------------

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.step, self.train_state
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, control=None, detail=False) -> dict:
        """The numbers compared against the float32 reference replaying the
        compared steps from the same weights, batches and seed: the worst
        step's relative loss gap, and the median leaf's gap in the norm of
        the first gradient and in the norm of the parameters' change over
        the compared steps (leaves whose reference gradient is under
        `still_leaf` of the median leaf's left out). `control`: a dtype;
        the reference rounded to it stands in the program's place.
        `detail`: also the worst leaf's gaps, the number of leaves left out,
        and the six worst leaves of each (name, size, reference gradient
        norm over the median leaf's, gap)."""
        ref_losses, ref_g1, ref_theta = self.replay(None)
        if control is not None:
            losses, g1, theta = self.replay(control)
        else:
            losses, g1, theta = self.losses, self.grad1, self.theta3
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        g_norms = {k: float(v.norm()) for k, v in ref_g1.items()}
        floor = self.traffic["still_leaf"] * float(np.median(list(g_norms.values())))
        moving = {k for k, v in g_norms.items() if v >= floor}
        delta = {k: theta[k] - self.theta0[k] for k in ref_theta}
        ref_delta = {k: ref_theta[k] - self.theta0[k] for k in ref_theta}
        grads = leaf_gaps(g1, ref_g1)
        updates = leaf_gaps(delta, ref_delta, moving)
        out = {"loss_gap": loss_gap,
               "grad_gap_median": float(np.median(list(grads.values()))),
               "update_gap_median": float(np.median(list(updates.values())))}
        if detail:
            out.update(grad_gap=worst(grads), update_gap=worst(updates),
                       still_leaves=len(ref_theta) - len(moving))
            median = float(np.median(list(g_norms.values())))
            for name, gaps in (("grad_top", grads), ("update_top", updates)):
                top = sorted(gaps, key=gaps.get, reverse=True)[:6]
                out[name] = [[k, ref_g1[k].numel(), g_norms[k] / median, gaps[k]] for k in top]
        return out

    def replay(self, rounding):
        """The reference's compared steps: (losses, first gradients by
        leaf, parameters after them by leaf)."""
        ref = Router(self.port).to(self.device)
        ref.load_state_dict(self.state)
        ref.classifier.requires_grad_(False)
        set_rounding(ref.train(), rounding)
        nets = ref_train.loss_nets()
        for name, net in nets.items():
            net.to(self.device).load_state_dict(self.loss_state[name])
            set_rounding(net.requires_grad_(False).eval(), rounding)
        named = dict(ref.named_parameters())
        opt = ref_train.Adam([named[k] for k in self.names],
                             self.pcfg["joint_training"]["learning_rate"])
        gen = generator(self.seed, 4, self.device)
        mask_dtype = harness.compute_dtype(self.config)
        losses, g1 = [], None
        with harness.fp32_exact():
            for i in range(self.traffic["compared_steps"]):
                batch = self.pool[self.order[i % len(self.order)]]
                losses.append(float(ref_train.train_step(ref, nets, None, batch, gen,
                                                         self.pcfg, mask_dtype)))
                if i == 0:
                    g1 = {k: named[k].grad.detach().clone() for k in self.names}
                opt.step()
        return losses, g1, {k: named[k].detach().clone() for k in self.names}
