"""Fused batched Taylor matrix exponential (port of
``qoc_tpu.ops.pallas_expm``).

    E_t = (sum_{n <= order} (A_t / 2^s)^n / n!)^(2^s),   A [T, M, M]

``fused_taylor_expm`` computes what ``ops.expm.taylor_expm`` computes
(same truncation and squarings) as a ``torch.autograd.Function``: on a
CUDA tensor its forward is kernel 7 and its backward kernel 8
(``csrc/expm.cu``: both series by Horner, which keeps no power of A, from
shared memory up to M = 120 and with products tiled from a scratch sized
by the resident grid above); on the CPU both are the plain versions
below.  The propagation engines take it for their batched Taylor step
wherever ``fused_expm_supported`` admits the shape.

``fused_expm_reference`` and ``fused_expm_backward_reference`` are the
plain torch versions that the kernels are held against: the series with
``torch.matmul``, and the reverse sweep of qoc_tpu's ``_bwd_kernel``
(recompute the powers and the pre-squaring E's, reverse the squarings as
``Ebar <- Ebar Es^T + Es^T Ebar``, then the Taylor reverse).
``fused_expm_backward_horner`` is the same cotangent in kernel 8's
association order.
"""

from __future__ import annotations

import torch

from . import _cuda
from .expm import taylor_expm


def _time_block(M: int) -> int:
    """qoc_tpu's timesteps per grid program, kept for its admission rule."""
    per_mat = M * M * 4
    budget = 24 * (1 << 20)
    tb = max(1, budget // (per_mat * 16))
    return int(min(tb, 16))


def fused_expm_supported(M: int, order: int, scaling: int) -> bool:
    """qoc_tpu's admission rule (``pallas_expm.py:36-42``), kept so that
    both packages route alike: 32 <= M <= 512, M % 8 == 0, and a per-block
    working set sized for TPU VMEM.  The CUDA kernels take any M % 8 == 0
    (above M = 120 from a scratch sized by the resident grid; PERF.md has
    their times against the plain chain)."""
    if M < 32 or M > 512 or M % 8 != 0:
        return False
    TB = _time_block(M)
    work = 4 * TB * M * M * (max(order - 1, 1) + scaling + 4)
    return work < 40 * (1 << 20)


def fused_expm_reference(A: torch.Tensor, order: int,
                         scaling: int) -> torch.Tensor:
    """Plain version of kernel 7: the port's ``taylor_expm``."""
    return taylor_expm(A, order, scaling)


def fused_expm_backward_reference(A: torch.Tensor, Ebar: torch.Tensor,
                                  order: int, scaling: int) -> torch.Tensor:
    """Plain version of kernel 8: the cotangent of A given Ebar, the
    cotangent of ``taylor_expm(A, order, scaling)``."""
    inv = 1.0 / (2.0 ** scaling)
    A = A * inv
    an = [A]                     # A^1 .. A^(order-1)
    E = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device) + A
    An = A
    factorial = 1.0
    for n in range(2, order + 1):
        factorial *= n
        An = torch.matmul(A, An)
        if n < order:
            an.append(An)
        E = E + An / factorial
    sq = []                      # the pre-squaring E's
    for s in range(scaling):
        sq.append(E)
        if s + 1 < scaling:
            E = torch.matmul(E, E)
    for Es in reversed(sq):
        Ebar = torch.matmul(Ebar, Es.mT) + torch.matmul(Es.mT, Ebar)
    anbar = Ebar * (1.0 / factorial)
    Abar = torch.zeros_like(A)
    fac_n = factorial
    for n in range(order, 1, -1):
        Abar = Abar + torch.matmul(anbar, an[n - 2].mT)
        fac_n = fac_n / n
        anbar = torch.matmul(A.mT, anbar) + Ebar * (1.0 / fac_n)
    return (Abar + anbar) * inv


def fused_expm_backward_horner(A: torch.Tensor, Ebar: torch.Tensor,
                               order: int, scaling: int) -> torch.Tensor:
    """The same cotangent as ``fused_expm_backward_reference``, in kernel
    8's association order, which keeps no power of A.

    With X = (A / 2^s)^T and G the cotangent of the pre-squaring series
    (Ebar after the squarings' reverse), the Taylor part of Abar is the
    upper-right block of p([[X, G], [0, X]]), p(B) = sum_{n <= order}
    B^n / n!, by Horner from the top term: R11 = I, R12 = 0, then for k =
    order .. 1, R12 <- (X R12 + G R11) / k (with the old R11) and R11 <- I
    + X R11 / k; Abar = 2^-s R12.  The kernel's plain twin, for tests and
    ``chip_smoke.py``; nothing on the main path calls it."""
    inv = 1.0 / (2.0 ** scaling)
    A = A * inv
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    G = Ebar
    if scaling:
        E = eye + A              # the series, then the pre-squaring E's
        An = A
        factorial = 1.0
        for n in range(2, order + 1):
            factorial *= n
            An = torch.matmul(A, An)
            E = E + An / factorial
        sq = [E]
        for _ in range(scaling - 1):
            sq.append(torch.matmul(sq[-1], sq[-1]))
        for Es in reversed(sq):
            G = torch.matmul(G, Es.mT) + torch.matmul(Es.mT, G)
    X = A.mT
    n = max(order, 1)            # order 0 keeps I + A, as the forward does
    R12 = G / n
    R11 = eye + X / n
    for k in range(n - 1, 0, -1):
        R12 = (torch.matmul(X, R12) + torch.matmul(G, R11)) / k
        if k > 1:
            R11 = eye + torch.matmul(X, R11) / k
    return R12 * inv


def _fold(x: torch.Tensor, bdim, batch_size: int) -> torch.Tensor:
    """A vmapped operand [..B.., T, M, M] as one batch [B*T, M, M] of
    timesteps (``bdim`` None: the same operand for every vmapped entry)."""
    x = (x.expand(batch_size, *x.shape) if bdim is None
         else x.movedim(bdim, 0))
    return x.reshape(-1, *x.shape[-2:])


def _unfold(x: torch.Tensor, batch_size: int) -> torch.Tensor:
    return x.reshape(batch_size, -1, *x.shape[-2:])


class _ExpmBackward(torch.autograd.Function):
    """Kernel 8 on a CUDA tensor, its plain version on the CPU.  A
    Function of its own so that ``torch.func.vmap`` over a gradient (the
    batch layer's vmapped backend) folds the seeds into the timesteps and
    launches it once."""

    @staticmethod
    def forward(A, Ebar, order, scaling):
        if A.device.type == "cpu":
            return fused_expm_backward_reference(A, Ebar, order, scaling)
        return _cuda.expm_backward(A.contiguous(), Ebar.contiguous(), order,
                                   scaling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "fused_taylor_expm is differentiable once (no second derivative)")

    @staticmethod
    def vmap(info, in_dims, A, Ebar, order, scaling):
        Abar = _ExpmBackward.apply(_fold(A, in_dims[0], info.batch_size),
                                   _fold(Ebar, in_dims[1], info.batch_size),
                                   order, scaling)
        return _unfold(Abar, info.batch_size), 0


class _FusedTaylorExpm(torch.autograd.Function):
    """Kernels 7 and 8 on a CUDA tensor; the plain versions on the CPU."""

    @staticmethod
    def forward(A, order, scaling):
        if A.device.type == "cpu":
            return fused_expm_reference(A, order, scaling)
        return _cuda.expm_forward(A.contiguous(), order, scaling)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, order, scaling = inputs
        ctx.save_for_backward(A)
        ctx.order, ctx.scaling = order, scaling

    @staticmethod
    def backward(ctx, Ebar):
        (A,) = ctx.saved_tensors
        return _ExpmBackward.apply(A, Ebar, ctx.order, ctx.scaling), None, None

    @staticmethod
    def vmap(info, in_dims, A, order, scaling):
        E = _FusedTaylorExpm.apply(_fold(A, in_dims[0], info.batch_size),
                                   order, scaling)
        return _unfold(E, info.batch_size), 0


def fused_taylor_expm(A: torch.Tensor, order: int,
                      scaling: int) -> torch.Tensor:
    """exp(A_t) for a batch [T, M, M] of generators; differentiable in A,
    and under ``torch.func`` transforms (a vmapped batch [B, T, M, M] is
    one launch of B*T timesteps)."""
    return _FusedTaylorExpm.apply(A, order, scaling)
