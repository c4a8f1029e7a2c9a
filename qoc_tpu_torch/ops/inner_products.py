"""Fidelity inner product on the real isomorphism (port of
``qoc_tpu.ops.inner_products.inner_product_2d``; get_inner_product_2D,
tensorflow_state.py:282-300)."""

from __future__ import annotations

import torch


def inner_product_2d(psi1: torch.Tensor, psi2: torch.Tensor,
                     state_num: int) -> torch.Tensor:
    """psi1, psi2: [2N, V] stacked iso vectors -> |sum_v <psi1_v|psi2_v>|^2 / V^2."""
    n = state_num
    a, b = psi1[:n, :], psi1[n: 2 * n, :]
    c, d = psi2[:n, :], psi2[n: 2 * n, :]
    ac = torch.sum(a * c, dim=0)
    bd = torch.sum(b * d, dim=0)
    bc = torch.sum(b * c, dim=0)
    ad = torch.sum(a * d, dim=0)
    reals = torch.square(torch.sum(ac + bd))
    imags = torch.square(torch.sum(bc - ad))
    V = psi1.shape[-1]
    return (reals + imags) / (V * V)
