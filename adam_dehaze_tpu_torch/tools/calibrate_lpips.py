"""Fit the LPIPS heads on synthetic ranked distortions.

    python -m adam_dehaze_tpu_torch.tools.calibrate_lpips \\
        --corpus data/synthetic_corpus_v2 --out experiments/full_system/lpips_cal \\
        [--patches 160] [--size 64] [--steps 400] [--uniform] [--seed 0] [--device cpu]

The counterpart of tools/calibrate_lpips.py, with its flags. No published
LPIPS weights are at hand, so the metric's AlexNet trunk is the seeded one
every `ImageQualityMetrics` builds (`init_params_(LPIPS(), seed 0)`), and its
per-channel heads are fitted on distortion pairs whose order is known by
construction:

- within a family (blur, noise, fog, quantisation, pixelation, contrast),
  a stronger level is worse than a weaker one;
- across families, a pair is ranked only where PSNR and gray SSIM agree by
  a margin (1.5 dB and 0.02): consensus labels.

The loss is a logistic ranking loss over the distances with the heads
ReLU'd (as losses/lpips.py uses them), plus a pull towards the uniform heads
1/C. The result is a port checkpoint `OUT.pth` ({"state_dict": the LPIPS
net's}) for `loss.lpips_weights`; its sidecar marks `calibration_synthetic`,
so `ImageQualityMetrics` reports `lpips_cal_synth`, never `lpips`.
`--uniform` keeps the uniform heads (the JAX rounds' default, after
tools/justify_lpips_calibration.py found that fitting does not carry over
to a held-out family) and writes the validation metrics beside them.

Distortions and pairs are drawn from one `numpy.random.default_rng(seed)`
in the JAX tool's order, so the two tools label the same pairs of the same
corpus. The heads are fitted with torch.optim.Adam on `--device` (the card
unless `cpu`).
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

FAMILIES = ("blur", "contrast", "fog", "noise", "pixelate", "quant")   # sorted, as the JAX tool
LEVELS = 3
# Pairs across families: ranked only where PSNR (dB) and SSIM agree by these.
PSNR_MARGIN, SSIM_MARGIN = 1.5, 0.02
# The ranking loss: softplus(-(d_worse - d_better) * SHARPNESS), mean, plus
# ANCHOR times the heads' mean squared distance from uniform.
SHARPNESS, ANCHOR = 50.0, 0.1
LEARNING_RATE, BATCH = 3e-3, 2048


def _blur(img, lvl):
    import cv2
    return cv2.GaussianBlur(img, (0, 0), (0.8, 1.6, 3.0)[lvl])


def _noise(rng):
    def f(img, lvl):
        return np.clip(img + rng.normal(0, (0.03, 0.08, 0.16)[lvl], img.shape), 0, 1)
    return f


def _fog(img, lvl):
    # The corpus's scattering model with a flat transmission: ranking does
    # not need the depth structure.
    t = (0.75, 0.55, 0.35)[lvl]
    return img * t + 0.9 * (1 - t)


def _quant(img, lvl):
    levels = (24, 12, 6)[lvl]
    return np.round(img * levels) / levels


def _pixelate(img, lvl):
    import cv2
    f = (2, 4, 8)[lvl]
    h, w = img.shape[:2]
    small = cv2.resize(img, (w // f, h // f), interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST)


def _contrast(img, lvl):
    return 0.5 + (img - 0.5) * (0.7, 0.45, 0.25)[lvl]


def families(rng) -> dict:
    """name -> distortion(img, level), the noise drawing from `rng`."""
    return {"blur": _blur, "noise": _noise(rng), "fog": _fog, "quant": _quant,
            "pixelate": _pixelate, "contrast": _contrast}


def load_patches(corpus: str, n: int, size: int, rng) -> np.ndarray:
    """`n` random size x size crops of the corpus's clear training frames,
    (n, size, size, 3) float32 in [0, 1]."""
    import cv2
    paths = sorted(glob.glob(os.path.join(corpus, "train", "*", "clear", "*.png")))
    if not paths:
        raise SystemExit(f"no clear frames under {corpus}/train/*/clear")
    sel = rng.choice(len(paths), size=min(n, len(paths)), replace=False)
    out = []
    for i in sel:
        img = cv2.cvtColor(cv2.imread(paths[i]), cv2.COLOR_BGR2RGB)
        h, w = img.shape[:2]
        y = rng.integers(0, max(h - size, 1))
        x = rng.integers(0, max(w - size, 1))
        out.append(img[y:y + size, x:x + size].astype(np.float32) / 255.0)
    return np.stack(out)


def distort(refs: np.ndarray, rng) -> np.ndarray:
    """Every family at every level of every patch: (P, F, L, H, W, 3)."""
    fams = families(rng)
    return np.stack([np.stack([np.stack([fams[f](r, lvl) for lvl in range(LEVELS)])
                               for f in FAMILIES])
                     for r in refs]).astype(np.float32)


def quality_scores(flat: np.ndarray, rep: np.ndarray, device) -> tuple:
    """PSNR and gray SSIM of each distorted image against its reference."""
    from adam_dehaze_tpu_torch.ops.image import psnr, ssim_gray
    a = torch.from_numpy(flat).to(device)
    b = torch.from_numpy(rep).to(device)
    return psnr(a, b).cpu().numpy(), ssim_gray(a, b).cpu().numpy()


def ranking_pairs(psnr: np.ndarray, ssim: np.ndarray):
    """(better, worse) indices into the flattened (P, F, L) stack and, for
    each pair, the two families it involves: every level pair within a
    family, and the cross-family pairs where PSNR and SSIM agree."""
    P, F_, L = psnr.shape

    def idx(p, f, lvl):
        return (p * F_ + f) * L + lvl

    pairs, fams = [], []
    for p_i in range(P):
        for f_i in range(F_):
            for l_a in range(L):
                for l_b in range(l_a + 1, L):
                    pairs.append((idx(p_i, f_i, l_a), idx(p_i, f_i, l_b)))
                    fams.append((f_i, f_i))
        for f_a in range(F_):
            for f_b in range(f_a + 1, F_):
                for l_a in range(L):
                    for l_b in range(L):
                        dp = psnr[p_i, f_a, l_a] - psnr[p_i, f_b, l_b]
                        ds = ssim[p_i, f_a, l_a] - ssim[p_i, f_b, l_b]
                        if dp > PSNR_MARGIN and ds > SSIM_MARGIN:
                            pairs.append((idx(p_i, f_a, l_a), idx(p_i, f_b, l_b)))
                            fams.append((f_a, f_b))
                        elif dp < -PSNR_MARGIN and ds < -SSIM_MARGIN:
                            pairs.append((idx(p_i, f_b, l_b), idx(p_i, f_a, l_a)))
                            fams.append((f_a, f_b))
    return np.asarray(pairs, np.int64).reshape(-1, 2), np.asarray(fams, np.int64).reshape(-1, 2)


def seeded_lpips(device):
    """The LPIPS net `ImageQualityMetrics` seeds (seed 0), uniform heads."""
    from adam_dehaze_tpu_torch.losses.lpips import LPIPS
    from adam_dehaze_tpu_torch.nn.blocks import init_params_
    return init_params_(LPIPS(), torch.Generator().manual_seed(0)).to(device).eval()


@torch.no_grad()
def feature_distances(lpips, flat: np.ndarray, rep: np.ndarray, device,
                      batch: int = 64) -> List[torch.Tensor]:
    """Per layer, the channel-unit-normalised squared feature differences
    of each (distorted, reference) pair averaged over the image, (N, C_l):
    the LPIPS distance is sum_l d_l @ relu(w_l)."""
    out = []
    for i in range(0, len(flat), batch):
        a = torch.from_numpy(flat[i:i + batch]).to(device)
        b = torch.from_numpy(rep[i:i + batch]).to(device)
        fa = lpips.net(((2.0 * a - 1.0) - lpips.shift) / lpips.scale)
        fb = lpips.net(((2.0 * b - 1.0) - lpips.shift) / lpips.scale)
        part = []
        for x, y in zip(fa, fb):
            xn = x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-10)
            yn = y * torch.rsqrt((y * y).sum(-1, keepdim=True) + 1e-10)
            part.append(((xn - yn) ** 2).mean(dim=(1, 2)))
        out.append(part)
    return [torch.cat([p[k] for p in out]) for k in range(len(out[0]))]


def uniform_heads(dms: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.full((d.shape[-1],), 1.0 / d.shape[-1], dtype=d.dtype, device=d.device)
            for d in dms]


def distance(ws, dms, sel) -> torch.Tensor:
    return sum(d[sel] @ torch.relu(w) for d, w in zip(dms, ws))


def ranking_loss(ws, dms, pairs, init_ws) -> torch.Tensor:
    """The logistic ranking loss of the pairs (better, worse) plus the pull
    towards the uniform heads."""
    db, dw = distance(ws, dms, pairs[:, 0]), distance(ws, dms, pairs[:, 1])
    rank = F.softplus(-(dw - db) * SHARPNESS).mean()
    anchor = sum(((w - w0) ** 2).mean() for w, w0 in zip(ws, init_ws)) / len(ws)
    return rank + ANCHOR * anchor


def margins(ws, dms, pairs) -> np.ndarray:
    """(d_worse - d_better) / (d_worse + d_better) of each pair."""
    with torch.no_grad():
        db, dw = distance(ws, dms, pairs[:, 0]), distance(ws, dms, pairs[:, 1])
        return ((dw - db) / torch.clamp(dw + db, min=1e-12)).cpu().numpy()


def rank_accuracy(ws, dms, pairs) -> float:
    return float((margins(ws, dms, pairs) > 0).mean())


def fit_heads(dms, train_pairs, steps: int, rng, log_every: int = 0, val_pairs=None):
    """Adam on the heads from uniform, a random batch of the training pairs
    a step drawn from `rng`; returns the heads."""
    init_ws = uniform_heads(dms)
    ws = [w.clone().requires_grad_() for w in init_ws]
    opt = torch.optim.Adam(ws, lr=LEARNING_RATE)
    device = dms[0].device
    for s in range(steps):
        sel = rng.integers(0, len(train_pairs), size=min(BATCH, len(train_pairs)))
        loss = ranking_loss(ws, dms, torch.from_numpy(train_pairs[sel]).to(device), init_ws)
        opt.zero_grad()
        loss.backward()
        opt.step()
        if log_every and val_pairs is not None and (s % log_every == 0 or s == steps - 1):
            print(f"step {s}: loss={float(loss):.4f} "
                  f"val_acc={rank_accuracy(ws, dms, val_pairs):.4f} "
                  f"(uniform {rank_accuracy(init_ws, dms, val_pairs):.4f})")
    return [w.detach() for w in ws]


def prepare(corpus: str, patches: int, size: int, rng, device):
    """The patches' distortions, their quality scores, the feature
    distances on the seeded trunk and the ranking pairs:
    (lpips, dms (per layer, flattened (P*F*L, C)), pairs, pair families,
    P)."""
    refs = load_patches(corpus, patches, size, rng)
    dist = distort(refs, rng)
    P, F_, L = dist.shape[:3]
    flat = dist.reshape(P * F_ * L, size, size, 3)
    rep = np.repeat(refs, F_ * L, axis=0)
    psnr, ssim = quality_scores(flat, rep, device)
    lpips = seeded_lpips(device)
    dms = feature_distances(lpips, flat, rep, device)
    pairs, fams = ranking_pairs(psnr.reshape(P, F_, L), ssim.reshape(P, F_, L))
    return lpips, dms, pairs, fams, P


def _device(name: str) -> torch.device:
    return torch.device("cpu" if name == "cpu" else "cuda")


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus", default="data/synthetic_corpus_v2")
    p.add_argument("--out", required=True, help="the checkpoint, written as OUT.pth")
    p.add_argument("--patches", type=int, default=160)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--uniform", action="store_true",
                   help="keep the uniform heads; write the validation metrics beside them")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "default", "cpu"],
                   help="cuda (or default: the card) or cpu")
    args = p.parse_args(argv)
    from adam_dehaze_tpu_torch.training import checkpoint as ckpt

    device = _device(args.device)
    rng = np.random.default_rng(args.seed)
    lpips, dms, pairs, _, P = prepare(args.corpus, args.patches, args.size, rng, device)
    rng.shuffle(pairs)
    n_val = max(len(pairs) // 10, 1)
    val, train = pairs[:n_val], pairs[n_val:]
    print(f"{P} patches x {len(FAMILIES)} families x {LEVELS} levels; "
          f"{len(train)} train / {len(val)} val ranking pairs")
    init_ws = uniform_heads(dms)
    steps = 0 if args.uniform else args.steps
    ws = fit_heads(dms, train, steps, rng, log_every=100, val_pairs=val)
    acc_fit, acc_uniform = rank_accuracy(ws, dms, val), rank_accuracy(init_ws, dms, val)
    with torch.no_grad():
        for i, w in enumerate(ws):
            getattr(lpips, f"lin{i}").copy_(w)
    out = os.path.abspath(args.out)
    path = ckpt.save_checkpoint(
        os.path.dirname(out), os.path.basename(out),
        {"state_dict": {k: v.cpu() for k, v in lpips.state_dict().items()}},
        {"calibration_synthetic": 1.0, "uniform_heads": 1.0 if args.uniform else 0.0,
         "val_rank_acc": acc_fit, "val_rank_acc_uniform": acc_uniform,
         "patches": float(P), "pairs": float(len(pairs))})
    print(f"wrote {path}: val ranking accuracy {acc_fit:.4f} (uniform heads {acc_uniform:.4f})")
    return path


if __name__ == "__main__":
    main()
