"""Serving of one volume: PET/CT normalisation, then the sliding window.

Normalisation: CT (channel 0) clipped to +-1024 HU and divided by 1024; PET
(channel 1) less its mean, over its population standard deviation plus
1e-3. Sliding window (nnU-Net's grid): along each axis of size S > patch P
at step T, ceil((S - P) / T) + 1 origins spread evenly over [0, S - P] and
rounded, else the one origin 0. Each window's head-0 logits are
softmaxed; the probabilities of the windows over a voxel are averaged
(the class with the largest average is the label).
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch


def normalize(image: np.ndarray, device) -> torch.Tensor:
    """(C, *spatial) raw host volume -> (*spatial, C) fp32 on ``device``."""
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device, torch.float64)
    ct = x[0].clamp(-1024.0, 1024.0) / 1024.0
    pet = x[1]
    pet = (pet - pet.mean()) / ((pet - pet.mean()).square().mean().sqrt() + 1e-3)
    return torch.stack([ct, pet] + list(x[2:]), dim=-1).float()


def origins(shape: Sequence[int], patch: Sequence[int], step: Sequence[int]) -> list:
    axes = []
    for s, p, t in zip(shape, patch, step):
        if s <= p:
            axes.append([0])
            continue
        n = int(np.ceil((s - p) / t)) + 1
        axes.append([int(np.round((s - p) / (n - 1) * i)) for i in range(n)])
    return list(itertools.product(*axes))


@torch.no_grad()
def mean_probs(net: torch.nn.Module, volume: torch.Tensor, patch: Sequence[int],
               step: Sequence[int], num_classes: int, batch: int = 2) -> torch.Tensor:
    """(*spatial, num_classes) fp32: the windows' softmax averaged per voxel."""
    net.eval()
    spatial = volume.shape[:-1]
    acc = torch.zeros(tuple(spatial) + (num_classes,), device=volume.device)
    count = torch.zeros(tuple(spatial) + (1,), device=volume.device)
    wins = origins(spatial, patch, step)
    for i in range(0, len(wins), batch):
        boxes = [tuple(slice(o, o + p) for o, p in zip(org, patch)) for org in wins[i:i + batch]]
        probs = torch.softmax(net(torch.stack([volume[b] for b in boxes]))[0].float(), dim=-1)
        for b, p in zip(boxes, probs):
            acc[b] += p
            count[b] += 1.0
    return acc / count
