"""Batched Taylor matrix exponentials in torch (port of ``qoc_tpu.ops.expm``).

Same truncation and association order as qoc_tpu, so both packages build
the same per-step propagators to float32 rounding:

  * ``taylor_expm`` (unitary mode) keeps Taylor powers 0..order and applies
    ``scaling`` squarings to the series of ``A / 2**scaling``
    (tensorflow_state.py:31,37-44).
  * ``taylor_expm_matvec`` (state transfer) keeps powers 0..order-1 and no
    squaring (tensorflow_state.py:85,92-97), the reference's off-by-one
    that qoc_tpu reproduces for parity.

Matrix products run in full float32: the package turns TF32 off on CUDA
(``qoc_tpu_torch.__init__``), because the unitarity budget needs it
(qoc_tpu's ``ops/expm.py`` ``_bmm`` note).
"""

from __future__ import annotations

import torch


def taylor_expm(A: torch.Tensor, order: int, scaling: int) -> torch.Tensor:
    """exp(A) for a batch ``[..., M, M]`` by Taylor series + squaring.

    E = I + A + A^2/2! + ... + A^order/order!, on ``A / 2**scaling``, then
    squared ``scaling`` times.  A^n is built as A @ A^(n-1).
    """
    if scaling:
        A = A / (2.0 ** scaling)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    E = eye + A
    An = A
    factorial = 1.0
    for n in range(2, order + 1):
        factorial *= n
        An = torch.matmul(A, An)
        E = E + An / factorial
    for _ in range(scaling):
        E = torch.matmul(E, E)
    return E


def taylor_expm_matvec(A: torch.Tensor, psi: torch.Tensor,
                       order: int) -> torch.Tensor:
    """exp(A) @ psi by the Taylor mat-vec recurrence, powers 0..order-1."""
    out = psi
    pn = psi
    factorial = 1.0
    for n in range(1, order):
        factorial *= n
        pn = torch.matmul(A, pn)
        out = out + pn / factorial
    return out


def weighted_hamiltonians(mats: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """A_t = sum_k w[k, t] mats[k]: mats [K, M, M], weights [K, T] -> [T, M, M]."""
    return torch.einsum("kt,kij->tij", weights, mats)
