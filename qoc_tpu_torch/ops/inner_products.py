"""Fidelity inner products on the real isomorphism (port of
``qoc_tpu.ops.inner_products``):

  * ``inner_product_1d``: get_inner_product (tensorflow_state.py:263-280);
  * ``inner_product_2d``: get_inner_product_2D (:282-300), the coherent
    gate fidelity over V stacked vectors;
  * ``inner_product_3d``: get_inner_product_3D (:302-321), the same per
    timestep, summed over time (the speed_up cost).
"""

from __future__ import annotations

import torch


def inner_product_1d(psi1: torch.Tensor, psi2: torch.Tensor,
                     state_num: int) -> torch.Tensor:
    """psi1, psi2: [2N] iso vectors -> |<psi1|psi2>|^2."""
    n = state_num
    a, b = psi1[:n], psi1[n: 2 * n]
    c, d = psi2[:n], psi2[n: 2 * n]
    reals = torch.square(torch.sum(a * c) + torch.sum(b * d))
    imags = torch.square(torch.sum(b * c) - torch.sum(a * d))
    return reals + imags


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


def inner_product_3d(psi1: torch.Tensor, psi2: torch.Tensor,
                     state_num: int) -> torch.Tensor:
    """psi1, psi2: [T, 2N, V] (time-major) -> sum_t of the 2D overlap at t."""
    n = state_num
    a, b = psi1[:, :n, :], psi1[:, n: 2 * n, :]
    c, d = psi2[:, :n, :], psi2[:, n: 2 * n, :]
    ac = torch.sum(a * c, dim=1)   # [T, V]
    bd = torch.sum(b * d, dim=1)
    bc = torch.sum(b * c, dim=1)
    ad = torch.sum(a * d, dim=1)
    reals = torch.sum(torch.square(torch.sum(ac + bd, dim=1)))
    imags = torch.sum(torch.square(torch.sum(bc - ad, dim=1)))
    V = psi1.shape[-1]
    return (reals + imags) / (V * V)
