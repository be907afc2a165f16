"""Plain PyTorch reference of ADAM-Dehaze's soft joint train step.

One step: the triplet augmentation (per-image flips and brightness and
contrast jitter, drawn from the step's generator), the router's train-mode
soft forward (the frozen classifier in train mode, its head's dropouts
drawn from the same generator; all three branches blended by softmax of the
logits over the temperature), the joint loss (L1 + content MSE on VGG16's
relu2_2, relu3_3 and relu4_3 + LPIPS on AlexNet's five taps with linear
heads; + the classifier's cross-entropy), backward, and Adam. The loss
nets' key names are torchvision's (`features.N`; LPIPS `net.features.N`,
`lin0`..`lin4`), so the benchmark's state dicts load as they load into the
program. Imports nothing of the program.

The generator's draws are taken in the order the upstream step takes them
(flip bits, brightness, contrast, then the head's two dropout masks), each
in the dtype its tensor has under the configuration's compute dtype, so that
the same seed gives the same draws.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.layers import Conv2d
from perfbench.reference.models import INTENSITY_ORDER, Router

GRAY = (0.299, 0.587, 0.114)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3))      # up to relu4_3
CONTENT_TAPS = ("relu2_2", "relu3_3", "relu4_3")
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)
LPIPS_WIDTHS = (64, 192, 384, 256, 256)


class VGG16Features(nn.Module):
    """torchvision's VGG16 `features` up to relu4_3; NHWC [0, 1] in, the
    three taps out (NCHW)."""

    def __init__(self):
        super().__init__()
        layers, cin, self.taps = [], 3, {}
        for si, (width, n) in enumerate(VGG_STAGES, start=1):
            for ci in range(1, n + 1):
                layers += [Conv2d(cin, width, 3, padding=1), nn.ReLU()]
                cin = width
                if f"relu{si}_{ci}" in CONTENT_TAPS:
                    self.taps[len(layers) - 1] = f"relu{si}_{ci}"
            if si < len(VGG_STAGES):
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        mean = torch.tensor(IMAGENET_MEAN, device=x.device)
        std = torch.tensor(IMAGENET_STD, device=x.device)
        x = ((x - mean) / std).permute(0, 3, 1, 2)
        out = {}
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                out[self.taps[i]] = x
        return out


class LPIPS(nn.Module):
    """LPIPS over AlexNet's five post-ReLU taps: unit-normalised channels,
    squared differences weighted by relu(lin_i), spatial mean, summed."""
    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.net = nn.Module()
        self.net.features = nn.Sequential(
            Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            Conv2d(256, 256, 3, padding=1), nn.ReLU())
        for i, c in enumerate(LPIPS_WIDTHS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.full((c,), 1.0 / c)))

    def forward(self, x, y):
        """x, y NHWC in [-1, 1] -> (N,) distances."""
        n = x.shape[0]
        shift = torch.tensor(LPIPS_SHIFT, device=x.device)
        scale = torch.tensor(LPIPS_SCALE, device=x.device)
        h = ((torch.cat([x, y]) - shift) / scale).permute(0, 3, 1, 2)
        total = x.new_zeros(n)
        tap = 0
        for i, layer in enumerate(self.net.features):
            h = layer(h)
            if i in self.TAPS:
                a, b = h[:n], h[n:]
                a = a * torch.rsqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
                b = b * torch.rsqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
                w = torch.relu(getattr(self, f"lin{tap}"))[None, :, None, None]
                total = total + (((a - b) ** 2) * w).sum(dim=1).mean(dim=(1, 2))
                tap += 1
        return total


def loss_nets() -> Dict[str, nn.Module]:
    return {"content": VGG16Features(), "lpips": LPIPS()}


def joint_loss(nets, pred, clear, logits, intensity, lambdas: dict, loss_cfg: dict):
    """lambda_dehazing * (l1 + content + perceptual terms) +
    lambda_classification * CE; the detection term is 0 (no detector)."""
    n = pred.shape[0]
    l1 = (pred - clear).abs().mean()
    f = nets["content"](torch.cat([pred, clear]))
    content = sum(((f[t][:n] - f[t][n:]) ** 2).mean() for t in CONTENT_TAPS) / len(CONTENT_TAPS)
    perceptual = nets["lpips"](2.0 * pred - 1.0, 2.0 * clear - 1.0).mean()
    dehazing = (loss_cfg["lambda_l1"] * l1 + loss_cfg["lambda_content"] * content
                + loss_cfg["lambda_perceptual"] * perceptual)
    cls = F.cross_entropy(logits, intensity.long())
    return lambdas["lambda_dehazing"] * dehazing + lambdas["lambda_classification"] * cls


def augment(gen, images: List[torch.Tensor], brightness=0.1, contrast=0.1):
    """The same flips and jitter on each of `images` (N, H, W, 3)."""
    n, dev = images[0].shape[0], images[0].device
    hflip = torch.rand(n, generator=gen, device=dev) < 0.5
    vflip = torch.rand(n, generator=gen, device=dev) < 0.5
    bf = (1 - brightness) + 2 * brightness * torch.rand(n, generator=gen, device=dev)
    cf = (1 - contrast) + 2 * contrast * torch.rand(n, generator=gen, device=dev)
    gray_w = torch.tensor(GRAY, device=dev)
    out = []
    for x in images:
        x = torch.where(hflip[:, None, None, None], x.flip(2), x)
        x = torch.where(vflip[:, None, None, None], x.flip(1), x)
        x = x * bf[:, None, None, None]
        gm = (x @ gray_w).mean(dim=(1, 2))[:, None, None, None]
        out.append(((x - gm) * cf[:, None, None, None] + gm).clamp(0.0, 1.0))
    return out


def soft_forward(router: Router, x, gen, temperature: float, mask_dtype: torch.dtype):
    """The router's soft forward: (blended output, logits). The head's
    dropout masks are drawn in `mask_dtype` (the second one's activation is
    in the compute dtype under autocast)."""
    clf = router.classifier
    drop0, fc0, relu, drop1, fc1 = clf.classifier
    feats = clf.backbone(x.permute(0, 3, 1, 2))
    keep0 = torch.empty_like(feats).bernoulli_(1.0 - drop0.p, generator=gen)
    h = relu(fc0(feats * keep0 / (1.0 - drop0.p)))
    keep1 = torch.empty(h.shape, dtype=mask_dtype, device=h.device).bernoulli_(
        1.0 - drop1.p, generator=gen)
    logits = fc1(h * keep1.to(h.dtype) / (1.0 - drop1.p))
    w = torch.softmax(logits / temperature, dim=1)
    ys = [router.models[lvl](x) for lvl in INTENSITY_ORDER]
    blended = sum(w[:, i, None, None, None] * y for i, y in enumerate(ys))
    return blended, logits


class Adam:
    """torch-Adam semantics (no weight decay): m, v, bias corrections,
    p -= lr * m_hat / (sqrt(v_hat) + eps)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.params, self.lr, self.betas, self.eps = list(params), lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = m / (1 - b1 ** self.t)
            v_hat = v / (1 - b2 ** self.t)
            p.sub_(self.lr * m_hat / (v_hat.sqrt() + self.eps))


def train_step(router, nets, opt: Optional[Adam], batch, gen, cfg: dict,
               mask_dtype=torch.float32):
    """One soft joint step on `batch` {hazy, clear, intensity}; returns the
    loss (a 0-d tensor). Without `opt` the gradients are left in .grad."""
    hazy, clear = augment(gen, [batch["hazy"], batch["clear"]])
    pred, logits = soft_forward(router, hazy, gen, cfg["routing"]["temperature"], mask_dtype)
    total = joint_loss(nets, pred, clear, logits, batch["intensity"], cfg["joint_training"],
                       cfg["loss"])
    for p in router.parameters():
        p.grad = None
    total.backward()
    if opt is not None:
        opt.step()
    return total.detach()
