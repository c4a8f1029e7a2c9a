"""The comparison that decides ``correct``: the program's readings against
the plain reference (``reference/grape.py``), number by number.

Two kinds of readings come from the timed entry at the cell's sizes:

* the check: the set-up's call, through the same entry with the
  window's ``update_step``, from pulses made from ``--seed``, cut to
  ``CHECK_STEPS`` Adam iterations, so that one segment (one launch of a
  fused kernel) runs them all.  Its settings (``Cell.check_conv``) give
  the learning rate a short decay and the loss a target that the seeds'
  losses straddle, so that seeds freeze at different iterations inside
  the segment.  The reference follows the same iterations from the same
  pulses, with the same settings;
* the answers: the final pulses and losses of calls that completed in
  the window (a sample drawn from ``--seed``), whose loss the reference
  works out again.

A checked seed whose reference loss lies within ``FREEZE_MARGIN`` of the
target at an iteration where the test could stop it is left out of the
check: there float32 rounding decides whether it freezes.  The numbers
(each against ``limits/<cell>.json``):

* ``loss_gap``: |loss - reference| at the end of the call;
* ``reg_gap``: the same for the loss with the costs (only where the
  configuration has costs);
* ``grad_gap``: |norm of the last gradient - reference| / reference,
  where the entry reports it (``Grape``'s history);
* ``step_gap``: the root mean square of du - du_ref over the rate (the
  gap in units of one first Adam step), du the pulses' change over the
  call, over the pulse entries whose first reference gradient is at
  least ``ROUNDOFF`` times the seed's median: Adam moves an entry whose
  gradient is nought to rounding by g / (|g| + eps), by round-off alone;
* ``answer_gap``: the largest |loss - reference| and |reg_loss -
  reference| over the sampled answers.

``step_gap`` is the largest over the checked seeds.  ``loss_gap`` and
``reg_gap`` are their 90th percentile (``LOSS_QUANTILE``; the value
itself with one seed): a seed with a round-off entry parts from the
reference's trajectory, and its loss with it, while its step stays
within the limit once that entry is left out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .reference import grape as ref

CHECK_STEPS = 3
LOSS_QUANTILE = 0.9
ROUNDOFF = 1e-3
FREEZE_MARGIN = 1e-3


def _np(x) -> np.ndarray:
    return x.double().cpu().numpy()


def follow(prob: ref.Problem, prog: dict,
           prec: ref.Precision = ref.FLOAT64, device="cpu",
           **conv) -> dict:
    """The reference's ``adam_steps`` over the check call: from the
    call's pulses, with its settings (changed by ``conv``)."""
    u0 = torch.as_tensor(np.asarray(prog["u0"], dtype=np.float64),
                         device=device)
    w = prog.get("extra_w")
    w = None if w is None else torch.as_tensor(
        np.asarray(w, dtype=np.float64), device=device)
    return ref.adam_steps(prob, u0, dict(prog["conv"], **conv), w, prec,
                          n_steps=CHECK_STEPS)


def check_numbers(prob: ref.Problem, prog: dict, device="cpu",
                  loss_quantile: float = LOSS_QUANTILE,
                  roundoff: float = ROUNDOFF, r: dict = None) -> dict:
    """The check's numbers.  ``prog``: ``conv`` (the call's settings),
    ``u0`` [S, K, T] (base domain), ``extra_w`` [S, E] or None, and at
    the end of the call ``loss`` and ``reg_loss`` [S], ``grad_norm`` [S]
    or None, ``u`` [S, K, T].  ``r``: the reference's ``follow`` of the
    call, where it is already made.  ``loss_quantile`` 1 and
    ``roundoff`` 0 give the widest gaps, every seed and entry counted.
    Empty where every checked seed lies at the freezing margin."""
    conv = prog["conv"]
    if r is None:
        r = follow(prob, prog, device=device)
    u0 = r["u0"]
    ref_losses = _np(r["losses"])
    # the test can stop a seed at iterations 0..CHECK_STEPS-1
    sure = np.all(np.abs(ref_losses[:, :CHECK_STEPS]
                         - float(conv["conv_target"])) >= FREEZE_MARGIN,
                  axis=1)
    if not sure.any():
        return {}

    def over(per_seed: np.ndarray, q: float) -> float:
        return float(np.quantile(per_seed[sure], q))

    out = {"loss_gap": over(np.abs(np.asarray(prog["loss"], np.float64)
                                   - ref_losses[:, -1]), loss_quantile)}
    if prob.reg_coeffs:
        out["reg_gap"] = over(np.abs(
            np.asarray(prog["reg_loss"], np.float64)
            - _np(r["reg_losses"][:, -1])), loss_quantile)
    if prog.get("grad_norm") is not None:
        g = _np(r["grad_last"])
        g_ref = np.sqrt((g ** 2).reshape(len(g), -1).sum(1))
        out["grad_gap"] = over(np.abs(
            np.asarray(prog["grad_norm"], np.float64) - g_ref) / g_ref, 1.0)
    g0 = np.abs(_np(r["grad0"])).reshape(len(ref_losses), -1)
    keep = g0 >= roundoff * np.median(g0, axis=1, keepdims=True)
    u0n = _np(u0).reshape(len(g0), -1)
    du_p = np.asarray(prog["u"], np.float64).reshape(len(g0), -1) - u0n
    du_r = _np(r["u"]).reshape(len(g0), -1) - u0n
    rms = np.sqrt((((du_p - du_r) * keep) ** 2).sum(1) / keep.sum(1))
    out["step_gap"] = over(rms / float(conv["rate"]), 1.0)
    return out


def answer_gap(prob: ref.Problem, answers: dict,
               prec: ref.Precision = ref.FLOAT64,
               device="cpu") -> Optional[float]:
    """The answers' number.  ``answers``: ``u`` [A, K, T] (final pulses,
    base domain), ``extra_w`` [A, E] or None, ``losses`` and
    ``reg_losses`` [A] as the program reported them."""
    if answers is None or len(answers["u"]) == 0:
        return None
    u = torch.as_tensor(np.asarray(answers["u"], dtype=np.float64),
                        device=device)
    w = answers.get("extra_w")
    w = None if w is None else torch.as_tensor(
        np.asarray(w, dtype=np.float64), device=device)
    loss, reg, _ = ref.loss_and_grad_blocked(prob, u, w, prec,
                                             want_grad=False)
    gaps = [np.abs(np.asarray(answers["losses"], dtype=np.float64)
                   - loss.double().cpu().numpy())]
    if prob.reg_coeffs:
        gaps.append(np.abs(np.asarray(answers["reg_losses"],
                                      dtype=np.float64)
                           - reg.double().cpu().numpy()))
    return float(np.max(gaps))


def reference_readings(prob: ref.Problem, prog: dict,
                       prec: ref.Precision = ref.FLOAT64, device="cpu",
                       **conv) -> dict:
    """The readings the check takes from the program, made instead by the
    reference in ``prec`` with the call's settings changed by ``conv``:
    the control (TF32), or a fault planted in the reference put in the
    program's place (no decay, no freezing)."""
    r = follow(prob, prog, prec, device, **conv)
    return dict(prog, loss=_np(r["losses"][:, -1]),
                reg_loss=_np(r["reg_losses"][:, -1]),
                grad_norm=(None if prog.get("grad_norm") is None
                           else _np(r["grad_last"].flatten(1).norm(dim=1))),
                u=_np(r["u"]))


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number without a limit fails, and so does a run with no
    number."""
    rows, ok = [], bool(numbers)
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        passed = (lim is not None and value is not None
                  and np.isfinite(value) and value <= lim)
        ok = ok and passed
        rows.append((name, value, lim))
    return ok, rows
