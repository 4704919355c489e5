"""The train step of the configurations: a family's loss (HDenseFormer's
deep-supervision focal loss below), its gradients and Adam with coupled L2,
for the first steps of a run.

Step t (from 0) draws its augmentation from a generator on the device
seeded ``augment_seed(seed, t)`` and its dropout masks from one seeded
``step_seed(seed, t)``: the run's seeding rule, JAX's ``fold_in`` of the
step into the run's key, stated by numpy's SeedSequence.

Loss: for each head i (full resolution first) the focal loss (gamma 2,
alpha 1: only the target class's term; probabilities clipped to [1e-7,
1 - 1e-7], logs clamped at -100) summed over the real samples' voxels and
classes against the one-hot target sampled nearest at the head's grid,
times 1 / 2^i. Adam: betas (0.9, 0.999), eps 1e-8, bias-corrected; a kernel
(more than one dim) takes the L2 term ``weight_decay * p`` into its gradient.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

AUGMENT_STREAM = 777


def step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])


def augment_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, AUGMENT_STREAM, step])
               .generate_state(1, np.uint64)[0])


def focal_sum(logits: torch.Tensor, target: torch.Tensor, weight: torch.Tensor):
    p = torch.softmax(logits.float(), dim=-1).clamp(1e-7, 1.0 - 1e-7)
    ce = -(target * torch.log(p).clamp_min(-100.0)
           + (1.0 - target) * torch.log(1.0 - p).clamp_min(-100.0))
    p_t = p * target + (1.0 - p) * (1.0 - target)
    loss = target * ce * (1.0 - p_t) ** 2
    return (loss * weight.view((-1,) + (1,) * (loss.dim() - 1))).sum()


def ds_loss(outs: Sequence[torch.Tensor], target: torch.Tensor, weight: torch.Tensor):
    total = torch.zeros((), device=target.device)
    for i, out in enumerate(outs):
        steps = [t // o for t, o in zip(target.shape[1:-1], out.shape[1:-1])]
        tgt = target[(slice(None),) + tuple(slice(None, None, s) for s in steps)]
        total = total + focal_sum(out, tgt, weight) / 2.0 ** i
    return total


def run_steps(net: torch.nn.Module, batches: List[Dict[str, torch.Tensor]], seed: int,
              lr: float, weight_decay: float, device_augment: Optional[Callable] = None,
              half_batch: bool = False, loss_fn: Callable = ds_loss) -> dict:
    """``len(batches)`` steps from the model's present weights, trained in
    place. Each batch holds the sample "weight" (B,) and, with
    ``device_augment(generator, image, label) -> (image, onehot)``, the raw
    "image" (B, *spatial, C) and class "label" (B, *spatial) that it
    augments from the step's generator; without it the augmented "image"
    and one-hot "onehot". Returns each step's loss, the first step's
    gradients as the optimizer took them (L2 term included) and the
    weights after the last. ``half_batch`` is a planted fault: each step
    learns from the first half of its rows alone, its loss scaled up to the
    whole batch's. ``loss_fn(outs, onehot, weight)`` is the family's loss
    (the deep-supervision focal loss above by default). The net's buffers,
    such as running statistics, start as loaded and move as its forward
    in training moves them."""
    params = dict(net.named_parameters())
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first_grads = [], None
    net.train()
    for t, batch in enumerate(batches):
        dev = batch["image"].device
        if device_augment is None:
            image, onehot = batch["image"], batch["onehot"]
        else:
            aug = torch.Generator(device=dev).manual_seed(augment_seed(seed, t))
            image, onehot = device_augment(aug, batch["image"], batch["label"])
        drop = torch.Generator(device=dev).manual_seed(step_seed(seed, t))
        weight = batch["weight"]
        if half_batch:
            keep = image.shape[0] // 2
            image, onehot, weight = image[:keep], onehot[:keep], weight[:keep] * 2.0
        loss = loss_fn(net(image, drop), onehot, weight)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {n: g + weight_decay * p if p.dim() > 1 else g
                     for (n, p), g in zip(params.items(), grads)}
            if first_grads is None:
                first_grads = {n: g.clone() for n, g in grads.items()}
            for n, p in params.items():
                m[n].mul_(b1).add_(grads[n], alpha=1 - b1)
                v[n].mul_(b2).addcmul_(grads[n], grads[n], value=1 - b2)
                denom = (v[n] / (1 - b2 ** (t + 1))).sqrt_().add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** (t + 1)))
        del grads, loss, image, onehot
    return {"losses": losses, "first_grads": first_grads,
            "params": {n: p.detach().clone() for n, p in params.items()}}
