"""Minimal qutip-API-compatible shim for the verification oracle.

A copy of ``qoc_tpu.utils.qutip_shim`` (numpy and scipy only).

The reference's ground-truth harness is built on three qutip calls —
``qt.Qobj``, ``qt.sesolve`` with the time-dependent ``[H0, [Hk, u_fn]]``
list format, and ``state.full()`` readout
(helper_functions/qutip_verification.py:35-71).  Real qutip is an
optional extra that cannot be installed in a zero-egress environment, so
this module provides the *same call surface* backed by scipy's DOP853
adaptive integrator.  It exists so the qutip branch of
``utils.verification._qutip_states`` has executed coverage: the test
suite injects this module in place of ``qutip`` and checks the branch's
states against the independent Pade-expm oracle.

THIS IS NOT QUTIP.  It is deliberately never installed under the name
``qutip`` — requesting ``oracle='qutip'`` without the real package still
raises the documented ImportError.  Use ``oracle='qutip-shim'`` (or pass
this module explicitly) to run the reference's oracle construction
against the shim's integrator.
"""

from __future__ import annotations

import numpy as np


class Qobj:
    """Array wrapper with qutip's ``.full()`` readout (the only Qobj
    surface the verification harness touches)."""

    def __init__(self, data):
        self._data = np.asarray(data, dtype=complex)
        if self._data.ndim == 1:
            self._data = self._data[:, None]

    def full(self) -> np.ndarray:
        return np.array(self._data)

    @property
    def shape(self):
        return self._data.shape


class _Result:
    def __init__(self, states):
        self.states = states


def sesolve(Ht_list, psi0: Qobj, tlist, e_ops=None, rtol=1e-9, atol=1e-11):
    """Schroedinger evolution i dpsi/dt = H(t) psi with qutip's
    time-dependent Hamiltonian list format:
    ``[H0, [H1, u1(t)], [H2, u2(t)], ...]`` (qutip_verification.py:43-61).
    Adaptive DOP853 with max_step bounded by the tlist spacing so the
    integrator never steps across a piecewise-constant pulse boundary.
    """
    from scipy.integrate import solve_ivp

    tlist = np.asarray(tlist, dtype=float)
    H0 = None
    td_terms = []
    for term in Ht_list:
        if isinstance(term, (list, tuple)):
            Hk, fn = term
            td_terms.append((Hk.full() if isinstance(Hk, Qobj)
                             else np.asarray(Hk, complex), fn))
        else:
            H = term.full() if isinstance(term, Qobj) else np.asarray(
                term, complex)
            H0 = H if H0 is None else H0 + H
    if H0 is None:
        H0 = np.zeros_like(td_terms[0][0])

    y0 = psi0.full()[:, 0]
    max_step = float(np.min(np.diff(tlist))) if len(tlist) > 1 else np.inf

    def rhs(t, y):
        H = H0
        for Hk, fn in td_terms:
            H = H + fn(t, None) * Hk
        return -1j * (H @ y)

    sol = solve_ivp(rhs, (float(tlist[0]), float(tlist[-1])), y0,
                    method="DOP853", t_eval=tlist, rtol=rtol, atol=atol,
                    max_step=max_step)
    if not sol.success:
        raise RuntimeError(f"qutip-shim sesolve failed: {sol.message}")
    return _Result([Qobj(sol.y[:, i]) for i in range(sol.y.shape[1])])
