"""What the benchmark makes from `--seed` and hands to both sides: the
router's weights and the hazy images.

Everything is drawn on the run's device from `torch.Generator`s seeded from
the seed, in a few large calls: one normal and one uniform draw for all the
weights, one draw a quantity for a whole pool of images.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from perfbench.reference.models import Router

SEED_MOD = 2 ** 63


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of draws of a run."""
    return torch.Generator(device).manual_seed((int(seed) * 1_000_003 + stream) % SEED_MOD)


def make_weights(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The router's weights: `draw_state` over the reference Router."""
    with torch.device("meta"):
        ref = Router(config)
    return draw_state(ref, seed, 1, device)


def draw_state(model: nn.Module, seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """`model`'s state dict drawn from the seed, float32 on `device`.

    Conv and linear weights lecun-normal (std 1 / sqrt(fan in)), their
    biases normal with std 0.02; BN scales 1 + N(0, 0.1), shifts N(0, 0.1),
    running means N(0, 0.1) and variances uniform in [0.5, 1.5], so that
    every folded BN does work; the low branch's skip weight uniform in
    [0.3, 0.9]; LPIPS's channel weights uniform in [0.5 / C, 1.5 / C]."""
    owner = {}
    for mname, m in model.named_modules():
        for pname, _ in list(m.named_parameters(recurse=False)) + list(
                m.named_buffers(recurse=False)):
            owner[f"{mname}.{pname}" if mname else pname] = m
    state = model.state_dict()
    floats = [(k, v) for k, v in state.items() if v.is_floating_point()]
    total = sum(v.numel() for _, v in floats)
    normal = torch.randn(total, generator=generator(seed, 10 * stream, device), device=device)
    uniform = torch.rand(total, generator=generator(seed, 10 * stream + 1, device),
                         device=device)
    out, at = {}, 0
    for k, v in state.items():
        if not v.is_floating_point():
            out[k] = torch.zeros(v.shape, dtype=v.dtype, device=device)
            continue
        n = v.numel()
        z, u = normal[at:at + n].view(v.shape), uniform[at:at + n].view(v.shape)
        at += n
        m, leaf = owner[k], k.rsplit(".", 1)[-1]
        if isinstance(m, nn.BatchNorm2d):
            out[k] = {"weight": 1.0 + 0.1 * z, "bias": 0.1 * z, "running_mean": 0.1 * z,
                      "running_var": 0.5 + u}[leaf]
        elif leaf == "skip_alpha":
            out[k] = 0.3 + 0.6 * u
        elif leaf.startswith("lin"):
            out[k] = (0.5 + u) / n
        elif leaf == "bias":
            out[k] = 0.02 * z
        else:
            fan_in = (v.shape[0] if isinstance(m, nn.ConvTranspose2d) else v.shape[1]) * \
                math.prod(v.shape[2:])
            out[k] = z * fan_in ** -0.5
    return out


def hazy_images(labels: torch.Tensor, size: int, beta, depth_m, airlight,
                gen: torch.Generator):
    """(hazy, clear), each (N, size, size, 3) float32 in [0, 1]: the hazy
    image I = J t + A (1 - t) of the clear scene J, t =
    exp(-beta d) (the atmospheric scattering model of Foggy Cityscapes),
    with J a smooth random scene, d a smooth depth in `depth_m` metres, A a
    grey airlight in `airlight`, and beta the level's attenuation
    (labels index `beta`)."""
    n, dev = labels.numel(), labels.device

    def smooth(channels, cells):
        coarse = torch.rand(n, channels, cells, cells, generator=gen, device=dev)
        return torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                               align_corners=False)

    scene = (0.7 * smooth(3, 8) + 0.3 * torch.rand(n, 3, size, size, generator=gen,
                                                    device=dev)).clamp(0, 1)
    depth = depth_m[0] + (depth_m[1] - depth_m[0]) * smooth(1, 4)
    b = torch.as_tensor(beta, dtype=torch.float32, device=dev)[labels].view(n, 1, 1, 1)
    t = torch.exp(-b * depth)
    a = airlight[0] + (airlight[1] - airlight[0]) * torch.rand(n, 1, 1, 1, generator=gen,
                                                                device=dev)
    hazy = (scene * t + a * (1.0 - t)).clamp(0, 1)
    return (hazy.permute(0, 2, 3, 1).contiguous(), scene.permute(0, 2, 3, 1).contiguous())
