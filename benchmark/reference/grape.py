"""The plain GRAPE reference: exact propagators, the loss, the gradient by
the adjoint, and Adam, in plain torch.

It imports nothing of the program.  It works from the complex matrices a
configuration's system file makes (H0, the control Hamiltonians, the extra
swept operators, the initial and target vectors) and from the pulses in
their base domain, and works out everything else again: the time step,
the sin-bounded control weights, each step's propagator, the costs.

Propagators are exact: ``expm`` is a degree-18 Taylor series on the
matrix scaled to a 1-norm of at most 1/2, then squared back (truncation
below 1e-22, far under float64 rounding).  The gradient runs the adjoint
chain backward and pairs each step's co-state with the Frechet derivative
of the exponential (``expm_frechet``, the same series differentiated), so
no derivative is approximated.

``Precision`` chooses the arithmetic: ``FLOAT64`` is the reference;
``TF32`` is the control, the same algorithm in complex64 whose every
matrix product first rounds its operands to TF32 (10 mantissa bits, as
the tensor cores do) and accumulates in float32.

The costs are written from the upstream formulas
(``regularization_functions.py`` of the GRAPE package the configurations
come from), each cited where it is defined, with their gradients by hand:
``dwdt``, ``envelope`` and ``bandpass`` act on the pulses, the forbidden
levels and ``speed_up`` on the trajectory, whose derivative enters the
co-states.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
TAYLOR_DEGREE = 18


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    complex_dtype: torch.dtype
    real_dtype: torch.dtype
    tf32: bool


FLOAT64 = Precision("float64", torch.complex128, torch.float64, False)
TF32 = Precision("tf32", torch.complex64, torch.float32, True)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _round_operand(a: torch.Tensor) -> torch.Tensor:
    if a.is_complex():
        return torch.complex(tf32_round(a.real), tf32_round(a.imag))
    return tf32_round(a)


def mm(a: torch.Tensor, b: torch.Tensor, prec: Precision) -> torch.Tensor:
    """A matrix product in ``prec``."""
    if prec.tf32:
        a, b = _round_operand(a), _round_operand(b)
    return torch.matmul(a, b)


def _squarings(A: torch.Tensor) -> int:
    norm = float(A.abs().sum(-2).amax()) if A.numel() else 0.0
    return max(0, math.ceil(math.log2(norm / 0.5))) if norm > 0.5 else 0


def expm(A: torch.Tensor, prec: Precision) -> torch.Tensor:
    """exp(A) for a batch [..., n, n]."""
    s = _squarings(A)
    X = A / 2.0 ** s
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    P = eye + X / TAYLOR_DEGREE
    for k in range(TAYLOR_DEGREE - 1, 0, -1):
        P = eye + mm(X, P, prec) / k
    for _ in range(s):
        P = mm(P, P, prec)
    return P


def expm_frechet(A: torch.Tensor, E: torch.Tensor,
                 prec: Precision) -> torch.Tensor:
    """The Frechet derivative of exp at A in the direction E: the series
    of ``expm`` and its squarings carried with their derivatives."""
    s = _squarings(A)
    X, dX = A / 2.0 ** s, E / 2.0 ** s
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    P, dP = eye + X / TAYLOR_DEGREE, dX / TAYLOR_DEGREE
    for k in range(TAYLOR_DEGREE - 1, 0, -1):
        P, dP = (eye + mm(X, P, prec) / k,
                 (mm(dX, P, prec) + mm(X, dP, prec)) / k)
    for _ in range(s):
        P, dP = mm(P, P, prec), mm(P, dP, prec) + mm(dP, P, prec)
    return dP


@dataclasses.dataclass
class Problem:
    """A GRAPE problem as the reference holds it (complex, [N, N])."""

    H0: np.ndarray                # [N, N]
    Hops: np.ndarray              # [K, N, N]
    maxA: np.ndarray              # [K]
    total_time: float
    steps: int
    psi0: np.ndarray              # [N, V] initial vectors
    targets: np.ndarray           # [N, V] target vectors
    reg_coeffs: dict
    extra_ops: Optional[np.ndarray] = None   # [E, N, N], weights per seed

    @property
    def dt(self) -> float:
        return self.total_time / self.steps


def problem_from_system(system: dict, swept: bool = False) -> Problem:
    """The reference's problem from a configuration's system: target vectors are
    the target gate applied to the initial basis states, or the target
    states of a state transfer; ``swept``: with the extra operators."""
    H0 = np.asarray(system["H0"], dtype=complex)
    N = H0.shape[0]
    if system["state_transfer"]:
        psi0 = np.stack([np.asarray(s, dtype=complex)
                         for s in system["states"]], axis=1)
        targets = np.stack([np.asarray(t, dtype=complex)
                            for t in system["target"]], axis=1)
    else:
        psi0 = np.eye(N, dtype=complex)[:, list(system["states"])]
        targets = np.asarray(system["target"], dtype=complex) @ psi0
    extra = system.get("extra_ops") if swept else None
    return Problem(
        H0=H0, Hops=np.stack([np.asarray(h, dtype=complex)
                              for h in system["Hops"]]),
        maxA=np.asarray(system["maxA"], dtype=float),
        total_time=float(system["total_time"]), steps=int(system["steps"]),
        psi0=psi0, targets=targets,
        reg_coeffs=dict(system.get("reg_coeffs") or {}),
        extra_ops=None if extra is None else np.asarray(extra, dtype=complex))


def draw_seed_pulses(n_seeds: int, ops: int, steps: int,
                     seed: int) -> torch.Tensor:
    """The batch entry's documented initial pulses [S, K, T] in the base
    domain: ``torch.randn`` from a CPU generator seeded with ``seed``, in
    float32, divided by sqrt(steps)."""
    u = torch.randn((n_seeds, ops, steps),
                    generator=torch.Generator().manual_seed(int(seed)),
                    dtype=torch.float32)
    return u / np.sqrt(steps)


def _pad_diff(w: torch.Tensor, dt: float):
    """First differences of the pulse padded with two zeros at each end,
    [.., K, T+3], over dt."""
    wp = torch.nn.functional.pad(w, (2, 2))
    return (wp[..., 1:] - wp[..., :-1]) / dt


def gauss_mask(steps: int) -> np.ndarray:
    """The envelope cost's mask [T]: one minus a Gaussian over
    linspace(-2, 2, steps), clipped at 0, plus 0.01 (upstream
    ``system_parameters.py:253-266``)."""
    gauss = np.exp(-np.linspace(-2.0, 2.0, steps) ** 2 / 2.0)
    shape = 1.0 - gauss
    return shape * (shape > 0) + 0.01


def band_bins(band, total_time: float, steps: int) -> np.ndarray:
    """The bandpass cost's bins [T] (1 where counted): [0, b0) and
    [b1, steps / 2), with b = int(band * total_time) (upstream
    ``regularization_functions.py:47-67``)."""
    b0, b1 = (np.asarray(band, dtype=float) * float(total_time)).astype(int)
    m = np.zeros(steps)
    m[0:b0] = 1.0
    m[b1:int(steps / 2)] = 1.0
    return m


def _pulse_costs(u: torch.Tensor, prob: Problem, prec: Precision,
                 want_grad: bool):
    """The costs on the pulses alone, and their gradient in u.
    u: [S, K, T] real.  Each is coeff / steps times its sum, on the
    weights w = sin(u)."""
    rc, T, dt = prob.reg_coeffs, prob.steps, prob.dt
    w, cosu = torch.sin(u), torch.cos(u)
    cost = torch.zeros(u.shape[0], dtype=u.dtype, device=u.device)
    gw = torch.zeros_like(u)
    if "dwdt" in rc:
        # l2 of the first differences of w padded with two zeros at each
        # end (regularization_functions.py:28-35)
        a = rc["dwdt"] / T
        d = _pad_diff(w, dt)                       # [S, K, T+3]
        cost = cost + a * 0.5 * (d * d).sum((1, 2))
        # d[j] = (wp[j+1] - wp[j]) / dt, w[i] = wp[i+2]
        gw = gw + a / dt * (d[..., 1:T + 1] - d[..., 2:T + 2])
    if "envelope" in rc:
        # l2 of w outside a Gaussian envelope
        # (regularization_functions.py:21-25)
        a = rc["envelope"] / T
        g = torch.as_tensor(gauss_mask(T), dtype=u.dtype, device=u.device)
        cost = cost + a * 0.5 * ((g * w) ** 2).sum((1, 2))
        gw = gw + a * g * g * w
    if "bandpass" in rc:
        # the sum of |FFT(w)| over the bins outside the band
        # (regularization_functions.py:47-67); d|F_k|/dw_t is
        # Re(conj(F_k) e^(-2 pi i k t / T)) / |F_k|, so the gradient is T
        # times the real part of the inverse FFT of the bins' F / |F|
        a = rc["bandpass"] / T
        m = torch.as_tensor(band_bins(rc["band"], prob.total_time, T),
                            dtype=u.dtype, device=u.device)
        F = torch.fft.fft(w.to(prec.complex_dtype), dim=-1)
        mag = F.abs()
        cost = cost + a * (mag * m).sum((1, 2))
        phase = torch.where(mag > 0, F / torch.where(mag > 0, mag, 1.0), 0)
        gw = gw + a * T * torch.fft.ifft(m * phase, dim=-1).real
    if not want_grad:
        return cost, None
    return cost, gw * cosu


# the costs the configurations use, and their parameters
KNOWN_COSTS = ("dwdt", "envelope", "bandpass", "band", "speed_up",
               "forbidden_coeff_list", "states_forbidden_list")


def _forbidden_levels(rc: dict):
    coeffs = rc.get("forbidden_coeff_list")
    if coeffs is None:
        return []
    return list(zip(coeffs, rc["states_forbidden_list"]))


def propagate(prob: Problem, u: torch.Tensor,
              extra_w: Optional[torch.Tensor] = None,
              prec: Precision = FLOAT64):
    """(A, P, traj): each step's -i dt H [S, T, N, N] and its propagator,
    and the trajectory [S, T+1, N, V] from the initial vectors, of the
    pulses ``u`` [S, K, T] in the base domain with the extra operators
    weighted by ``extra_w`` [S, E]."""
    dev = u.device
    cdt, rdt = prec.complex_dtype, prec.real_dtype
    S = u.shape[0]
    H0 = torch.as_tensor(prob.H0, dtype=cdt, device=dev)
    Hops = torch.as_tensor(prob.Hops, dtype=cdt, device=dev)
    maxA = torch.as_tensor(prob.maxA, dtype=rdt, device=dev)
    psi0 = torch.as_tensor(prob.psi0, dtype=cdt, device=dev)
    theta = maxA[None, :, None] * torch.sin(u.to(rdt))        # [S, K, T]
    H = H0 + torch.einsum("skt,kij->stij", theta.to(cdt), Hops)
    if prob.extra_ops is not None:
        Ex = torch.as_tensor(prob.extra_ops, dtype=cdt, device=dev)
        H = H + torch.einsum("se,eij->sij", extra_w.to(device=dev, dtype=cdt),
                             Ex)[:, None]
    A = (-1j * prob.dt) * H                                  # [S, T, N, N]
    P = expm(A, prec)
    psi = [psi0.expand(S, -1, -1)]
    for t in range(prob.steps):
        psi.append(mm(P[:, t], psi[-1], prec))
    return A, P, torch.stack(psi, dim=1)


def loss_and_grad(prob: Problem, u: torch.Tensor,
                  extra_w: Optional[torch.Tensor] = None,
                  prec: Precision = FLOAT64, want_grad: bool = True):
    """(loss [S], reg_loss [S], grad [S, K, T] or None) of the pulses
    ``u`` [S, K, T] in the base domain, with the extra operators weighted
    by ``extra_w`` [S, E].  The loss is 1 - |sum_v <target_v|psi_v(T)>|^2
    / V^2; reg_loss adds the configuration's costs; the gradient is of
    reg_loss."""
    for key in prob.reg_coeffs:
        if key not in KNOWN_COSTS:
            raise NotImplementedError(f"the reference has no cost {key!r}")
    dev = u.device
    cdt, rdt = prec.complex_dtype, prec.real_dtype
    u = u.to(rdt)
    S, K, T = u.shape
    dt = prob.dt
    Hops = torch.as_tensor(prob.Hops, dtype=cdt, device=dev)
    maxA = torch.as_tensor(prob.maxA, dtype=rdt, device=dev)
    tgt = torch.as_tensor(prob.targets, dtype=cdt, device=dev)
    V = tgt.shape[1]
    A, P, traj = propagate(prob, u, extra_w, prec)
    overlap = (tgt.conj() * traj[:, -1]).sum((1, 2))         # [S]
    loss = 1.0 - (overlap.abs() ** 2) / (V * V)
    rc = prob.reg_coeffs
    cost, g_pulse = _pulse_costs(u, prob, prec, want_grad)
    pops = traj.real ** 2 + traj.imag ** 2                   # [S, T+1, N, V]
    forb = _forbidden_levels(rc)
    for coeff, level in forb:
        # l2 of each forbidden level's population over the trajectory
        # (regularization_functions.py:71-85)
        a = coeff / prob.steps
        cost = cost + a * 0.5 * (pops[:, :, level] ** 2).sum((1, 2))
    if "speed_up" in rc:
        # the target overlap at every step, psi_0 included: coeff / steps
        # times l2(T + 1 - sum_t |sum_v <target_v|psi_v(t)>|^2 / V^2)
        # (regularization_functions.py:88-95)
        a_su = rc["speed_up"] / prob.steps
        ov_t = (tgt.conj() * traj).sum(-2).sum(-1)            # [S, T+1]
        short = (T + 1) - (ov_t.abs() ** 2).sum(1) / (V * V)  # [S]
        cost = cost + a_su * 0.5 * short ** 2
    reg = loss + cost
    if not want_grad:
        return loss, reg, None

    # co-states: Gamma_t = d reg / d psi_t (conjugate-gradient convention)
    gam = torch.zeros_like(traj)
    gam[:, -1] = (-2.0 / (V * V)) * overlap[:, None, None] * tgt
    for coeff, level in forb:
        a = coeff / prob.steps
        gam[:, :, level] += 2 * a * pops[:, :, level] * traj[:, :, level]
    if "speed_up" in rc:
        gam += ((-2.0 * a_su / (V * V)) * short[:, None, None, None]
                * ov_t[:, :, None, None] * tgt)
    lam = gam[:, -1]
    gP = torch.empty_like(P)
    for t in range(T - 1, -1, -1):
        gP[:, t] = mm(lam, traj[:, t].conj().transpose(-1, -2), prec)
        lam = mm(P[:, t].conj().transpose(-1, -2), lam, prec) + gam[:, t]
    G = expm_frechet(A.conj().transpose(-1, -2), gP, prec)   # [S, T, N, N]
    dA = (-1j * dt) * Hops                                   # [K, N, N]
    g_theta = torch.einsum("stij,kij->skt", G.conj(), dA).real
    grad = g_theta * maxA[None, :, None] * torch.cos(u) + g_pulse
    return loss, reg, grad


def loss_and_grad_blocked(prob: Problem, u: torch.Tensor,
                          extra_w: Optional[torch.Tensor] = None,
                          prec: Precision = FLOAT64, want_grad: bool = True,
                          max_matrices: int = 1 << 16):
    """``loss_and_grad`` over blocks of seeds, each holding at most
    ``max_matrices`` step matrices of the size 2N x 2N, so that large
    problems fit."""
    N = prob.H0.shape[0]
    per_seed = prob.steps * max(1, (2 * N * 2 * N) // 1024)
    block = max(1, max_matrices // per_seed)
    outs = []
    for s0 in range(0, u.shape[0], block):
        w = None if extra_w is None else extra_w[s0:s0 + block]
        outs.append(loss_and_grad(prob, u[s0:s0 + block], w, prec,
                                  want_grad))
    loss = torch.cat([o[0] for o in outs])
    reg = torch.cat([o[1] for o in outs])
    grad = torch.cat([o[2] for o in outs]) if want_grad else None
    return loss, reg, grad


def adam_steps(prob: Problem, u0: torch.Tensor, conv: dict,
               extra_w: Optional[torch.Tensor] = None,
               prec: Precision = FLOAT64, n_steps: int = 3,
               **blocked) -> dict:
    """Follow GRAPE's Adam for ``n_steps`` iterations from ``u0`` [S, K, T]
    as the reference runs it: at iteration j the loss and gradient at the
    current pulses, then the convergence test (loss < conv_target,
    0.5 |g|^2 < min_grad, j >= max_iterations) freezes the seed, else TF1
    Adam (bias-corrected, eps after the square root) steps with the rate
    ``rate * exp(-j / learning_rate_decay)``.

    Returns each iteration's loss and reg_loss [S, n_steps + 1], the
    first and the last gradient [S, K, T] (the last at the pulses after
    the steps), the pulses before and after the steps [S, K, T] and the
    frozen flags [S]."""
    rate = float(conv["rate"])
    decay = float(conv.get("learning_rate_decay", 2500.0))
    target = float(conv["conv_target"])
    min_grad = float(conv.get("min_grad", 1e-25))
    max_it = int(conv["max_iterations"])
    u = u0.to(prec.real_dtype).clone()
    m = torch.zeros_like(u)
    v = torch.zeros_like(u)
    count = torch.zeros(u.shape[0], dtype=torch.int64, device=u.device)
    frozen = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
    losses, regs, g0 = [], [], None
    for j in range(n_steps + 1):
        loss, reg, g = loss_and_grad_blocked(prob, u, extra_w, prec,
                                             **blocked)
        losses.append(loss)
        regs.append(reg)
        if j == 0:
            g0 = g
        g2 = 0.5 * (g * g).sum((1, 2))
        frozen = (frozen | (loss < target) | (g2 < min_grad)
                  | torch.tensor(j >= max_it, device=u.device))
        if j == n_steps:
            break
        live = ~frozen
        c = (count + 1).to(u.dtype)[:, None, None]
        m_new = B1 * m + (1 - B1) * g
        v_new = B2 * v + (1 - B2) * g * g
        lr = torch.as_tensor(rate * np.exp(-count.cpu().numpy() / decay),
                             dtype=u.dtype, device=u.device)[:, None, None]
        step = lr * (m_new / (1 - B1 ** c)) / (
            torch.sqrt(v_new / (1 - B2 ** c)) + EPS)
        keep = frozen[:, None, None]
        u = torch.where(keep, u, u - step)
        m = torch.where(keep, m, m_new)
        v = torch.where(keep, v, v_new)
        count = count + live.to(count.dtype)
    return {"losses": torch.stack(losses, 1), "reg_losses": torch.stack(regs, 1),
            "grad0": g0, "grad_last": g, "u0": u0, "u": u,
            "frozen": frozen}
