"""Carry problems and optimizer state across: numpy -> torch tensors, and
Adam state in the optax layout qoc_tpu checkpoints use.

``adam_state_from_numpy`` takes the leaves that
``qoc_tpu.ops.pallas_mega.mega_state_to_optax`` (or qoc_tpu's optax Adam
chain) holds: ``u`` [K, T], ``mu``/``nu`` (the ScaleByAdamState moments),
``count`` (its step count) and ``lr`` (the exponential-decay state's
``{"lr": ...}``).  A run saved by qoc_tpu can therefore continue in the
port; ``adam_state_to_numpy`` gives the same leaves back.
"""

from __future__ import annotations

import numpy as np
import torch

from .optim.adam import AdamState


def full_fp32_matmul() -> None:
    """No TF32 anywhere: the unitarity budget needs full float32 products
    (qoc_tpu PERF.md "Matmul precision")."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def entry_device(device) -> torch.device:
    """The device of an entry point (``Grape``, ``batched_grape_adam``):
    ``None`` means the CUDA card, and raises when torch sees none; the CPU
    is only ever taken when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device=None runs on the CUDA card, and torch sees no CUDA "
                "device; pass device='cpu' to run the plain torch versions "
                "on the CPU")
        device = "cuda"
    return torch.device(device)


def problem_tensors(problem, device) -> dict:
    """The problem's device arrays as float32 tensors on ``device``:
    mats [K+1, 2N, 2N], U0_iso [2N, 2N], initial_vectors / target_vectors
    [2N, V], ops_max_amp [K], u0_base [K, T], one_minus_gauss [K, T], and
    v_sorted_iso [2N, 2N] when the problem is dressed."""
    device = torch.device(device)
    if device.type == "cuda":
        full_fp32_matmul()
    names = ("mats", "U0_iso", "initial_vectors", "target_vectors",
             "ops_max_amp", "u0_base", "one_minus_gauss")
    if problem.v_sorted_iso is not None:
        names += ("v_sorted_iso",)
    return {
        n: torch.as_tensor(np.asarray(getattr(problem, n), dtype=np.float32),
                           device=device)
        for n in names
    }


def adam_state_from_numpy(u, mu, nu, count, lr, steps: int, Tp: int,
                          device="cpu") -> AdamState:
    """An AdamState on ``device`` whose pulse and moments are zero-padded
    from ``steps`` to ``Tp`` lanes (``Tp = steps`` for the per-iteration
    runner, the power-of-two lane count for the segment kernel)."""
    def pad(x):
        x = np.asarray(x, dtype=np.float32)[:, :steps]
        x = np.pad(x, ((0, 0), (0, Tp - steps)))
        return torch.as_tensor(x, device=torch.device(device))

    return AdamState(
        u_base=pad(u), m=pad(mu), v=pad(nu),
        lr=float(np.float32(np.asarray(lr))), iteration=int(count),
        loss=float("inf"), reg_loss=float("inf"),
        grad_squared=float("inf"), unitary_scale=0.0, done=False,
    )


def adam_state_to_numpy(state: AdamState, steps: int):
    """(u, mu, nu, count, lr) as numpy, trimmed to ``steps`` lanes."""
    def host(x):
        return x.detach().cpu().numpy()[:, :steps]

    return (host(state.u_base), host(state.m), host(state.v),
            np.int32(state.iteration), np.float32(state.lr))


def batch_state_from_numpy(u, mu, nu, count, lr, iteration: int = 0,
                           done=None, device="cpu"):
    """A ``parallel.batch.BatchState`` of the per-iteration backends from
    the leaves of qoc_tpu's vmapped optax state: u [S, K, T], mu/nu (the
    ScaleByAdamState moments), count [S] and lr [S] (the decay state's
    ``{"lr": ...}``), the global ``iteration`` and the frozen flags."""
    from .optim.adam import BatchAdamState
    from .parallel.batch import BatchState

    device = torch.device(device)

    def dev(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    u = dev(u)
    S = u.shape[0]
    inf = torch.full((S,), float("inf"), device=device)
    done = (torch.zeros(S, dtype=torch.bool, device=device) if done is None
            else torch.as_tensor(np.array(done, dtype=bool), device=device))
    opt = BatchAdamState(
        mu=dev(mu), nu=dev(nu),
        count=torch.as_tensor(np.array(count, dtype=np.int32),
                              device=device),
        lr=dev(lr))
    return BatchState(u_base=u, opt_state=opt, iteration=int(iteration),
                      loss=inf, reg_loss=inf, grad_squared=inf, done=done)


def batch_state_to_numpy(state):
    """(u, mu, nu, count, lr) of a per-iteration BatchState as numpy."""
    opt = state.opt_state
    return tuple(x.detach().cpu().numpy() for x in (
        state.u_base, opt.mu, opt.nu, opt.count, opt.lr))


_MEGA_FIELDS = ("u_cols", "m_cols", "v_cols", "it_cols", "done_cols")
_MEGA_METRICS = ("losses", "grad_squared", "reg_losses")


def mega_batch_state_from_numpy(state, device="cpu"):
    """A ``parallel.mega_batch.MegaBatchState`` from any object with
    qoc_tpu's MegaBatchState fields (u/m/v_cols [T, Kc, C], it_cols and
    done_cols [1, C], iteration, losses, grad_squared, reg_losses)."""
    from .parallel.mega_batch import MegaBatchState

    device = torch.device(device)

    def dev(x):
        if x is None:
            return None
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return MegaBatchState(
        **{f: dev(getattr(state, f)) for f in _MEGA_FIELDS + _MEGA_METRICS},
        iteration=int(state.iteration))


def mega_batch_state_to_numpy(state) -> dict:
    """The fields of a MegaBatchState as numpy, keyed as qoc_tpu's
    ``MegaBatchState(**fields)`` takes them."""
    out = {f: (None if getattr(state, f) is None
               else getattr(state, f).detach().cpu().numpy())
           for f in _MEGA_FIELDS + _MEGA_METRICS}
    out["iteration"] = int(state.iteration)
    return out
