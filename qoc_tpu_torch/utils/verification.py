"""Independent differential verification of saved runs.

A copy of ``qoc_tpu.utils.verification`` (numpy and scipy only):
h5py is imported when a run file is read, so importing this module
needs no h5py.

Plays the role of helper_functions/qutip_verification.py:5-86: re-simulate
the optimized pulses stored in a run file with an *independent* integrator
and compare the stored intermediate states.  Four oracles:

  * ``scipy`` (always available): dense piecewise-constant propagation with
    ``scipy.linalg.expm`` in float64 — a different algorithm (Pade) and a
    different precision from the on-device Taylor kernel.
  * ``ode`` (always available): adaptive Runge-Kutta integration of the
    Schroedinger equation (scipy ``solve_ivp``, DOP853) with the
    reference's piecewise-constant ``uks[int(t/dt)]`` Hamiltonian lookup
    (qutip_verification.py:51-64) — the same algorithm CLASS as the
    reference's ``qt.sesolve`` oracle, with no qutip dependency.
  * ``qutip``: ``qt.sesolve`` itself, byte-for-byte the reference's oracle
    construction.  qutip is an OPTIONAL EXTRA (``pip install
    qoc_tpu[qutip]``), deliberately not vendored: requesting this oracle
    without it raises a documented error (tested), and everything shared
    with it — run-file loading and the piecewise-constant
    ``uks[k][int(t/dt)]`` pulse lookup (qutip_verification.py:51-61) — is
    factored into ``piecewise_uks_fns`` and exercised by the ``ode``
    oracle's tests.  The qutip-exclusive surface is three qt.* calls.
  * ``qutip-shim`` (always available): the SAME ``_qutip_states`` branch —
    Qobj wrapping, the time-dependent ``[H0, [Hk, u_fn]]`` list, sesolve,
    ``.full()`` readout — executed against ``utils.qutip_shim``, a
    clearly-labeled API-compatible stand-in backed by DOP853.  This gives
    the qutip branch executed coverage in environments where the real
    package cannot be installed; it never masquerades as qutip itself.

All read the identical h5 schema the reference writes (H0, Hops,
total_time, steps, uks[-1], inter_vecs_raw_{real,imag}[-1],
initial_vectors_c).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as la


def _load_run(datafile: str):
    import h5py

    with h5py.File(datafile, "r") as hf:
        gate_time = float(np.array(hf.get("total_time")))
        gate_steps = int(np.array(hf.get("steps")))
        H0 = np.array(hf.get("H0"))
        Hops = np.array(hf.get("Hops"))
        initial_vectors_c = np.array(hf.get("initial_vectors_c"))
        uks = np.array(hf.get("uks"))[-1]
        ivr = np.array(hf.get("inter_vecs_raw_real"))[-1]
        ivi = np.array(hf.get("inter_vecs_raw_imag"))[-1]
    return gate_time, gate_steps, H0, Hops, initial_vectors_c, uks, ivr + 1j * ivi


def scipy_oracle_states(H0, Hops, uks, total_time, steps, psi0_c):
    """Dense float64 piecewise-constant propagation (independent of the
    Taylor kernel): psi_{t+1} = expm(-i dt (H0 + sum_k u[k,t] H_k)) psi_t."""
    dt = total_time / steps
    psi = np.asarray(psi0_c, dtype=complex)
    states = [psi]
    for t in range(steps):
        H = np.asarray(H0, dtype=complex)
        for k in range(len(Hops)):
            H = H + uks[k, t] * np.asarray(Hops[k], dtype=complex)
        psi = la.expm(-1j * dt * H) @ psi
        states.append(psi)
    return np.stack(states, axis=1)  # [N, steps+1]


def verify_run(datafile: str, atol: float = 1e-4, oracle: str = "scipy"):
    """Compare stored intermediate states against an independent solver.

    Returns dict {max_abs_diff: [...], all_close: [...]}, one entry per
    initial vector — the reference's report shape
    (qutip_verification.py:82-86).
    """
    gate_time, steps, H0, Hops, init_vecs, uks, inter_vecs = _load_run(datafile)
    return verify_states(H0, Hops, uks, gate_time, steps, init_vecs,
                         inter_vecs, atol=atol, oracle=oracle)


def verify_states(H0, Hops, uks, gate_time, steps, init_vecs, inter_vecs,
                  atol: float = 1e-4, oracle: str = "scipy"):
    """``verify_run``'s comparison on arrays: the run's pulses ``uks`` [K,
    T], its initial vectors ``init_vecs`` [V, N] and intermediate states
    ``inter_vecs`` [V, N, T+1] (complex, the run file's
    ``inter_vecs_raw_*`` layout) against the oracle's re-simulation.  A
    run that was not saved (``Grape(save=False)``) is checked from its
    ``GrapeResult`` this way."""
    max_abs_diff_list, all_close_list = [], []
    for vid in range(len(init_vecs)):
        psi0 = init_vecs[vid]
        if oracle == "qutip":
            states = _qutip_states(H0, Hops, uks, gate_time, steps, psi0)
        elif oracle == "qutip-shim":
            from . import qutip_shim

            states = _qutip_states(H0, Hops, uks, gate_time, steps, psi0,
                                   qt=qutip_shim)
        elif oracle == "ode":
            states = ode_oracle_states(H0, Hops, uks, gate_time, steps, psi0)
        else:
            states = scipy_oracle_states(H0, Hops, uks, gate_time, steps, psi0)
        stored = inter_vecs[vid]  # [N, steps+1]
        abs_diff = np.abs(states) - np.abs(stored)
        max_abs_diff_list.append(float(np.max(np.abs(abs_diff))))
        all_close_list.append(bool(np.allclose(states, stored, atol=atol)))
    return {"max_abs_diff": max_abs_diff_list, "all_close": all_close_list}


def piecewise_uks_fns(uks, gate_time, steps):
    """Per-channel callables ``u_k(t)`` with the reference's
    piecewise-constant lookup ``uks[k][int(t/dt)]`` zero-padded one step
    past the horizon (qutip_verification.py:51-61).  Shared by the ``ode``
    and ``qutip`` oracles so the lookup semantics are tested even where
    qutip is not installed."""
    dt = gate_time / steps
    uks_pad = np.hstack([np.asarray(uks, dtype=float),
                         np.zeros((np.shape(uks)[0], 1))])

    def make(idx):
        def _fn(t, args=None):
            return uks_pad[idx][min(int(t / dt), steps)]

        return _fn

    return [make(k) for k in range(np.shape(uks)[0])]


def ode_oracle_states(H0, Hops, uks, gate_time, steps, psi0_c,
                      rtol=1e-9, atol=1e-11):
    """Adaptive ODE integration of i dpsi/dt = H(t) psi — the reference
    oracle's algorithm class (qt.sesolve is an adaptive ODE solver) built
    on scipy's DOP853, with the reference's piecewise-constant Hamiltonian
    lookup ``uks[k][int(t/dt)]`` (qutip_verification.py:51-64).  max_step
    = dt keeps the integrator from stepping across pulse discontinuities.
    """
    from scipy.integrate import solve_ivp

    dt = gate_time / steps
    u_fns = piecewise_uks_fns(uks, gate_time, steps)
    H0c = np.asarray(H0, dtype=complex)
    Hkc = [np.asarray(h, dtype=complex) for h in Hops]

    def rhs(t, y):
        H = H0c
        for fn, Hk in zip(u_fns, Hkc):
            H = H + fn(t) * Hk
        return -1j * (H @ y)

    tlist = np.linspace(0.0, gate_time, steps + 1)
    sol = solve_ivp(rhs, (0.0, gate_time),
                    np.asarray(psi0_c, dtype=complex), method="DOP853",
                    t_eval=tlist, rtol=rtol, atol=atol, max_step=dt)
    if not sol.success:
        raise RuntimeError(f"ODE oracle failed: {sol.message}")
    return sol.y  # [N, steps+1]


def _qutip_states(H0, Hops, uks, gate_time, steps, psi0_c, qt=None):
    """QuTiP sesolve oracle, reference construction
    (qutip_verification.py:35-71).  Requires the optional ``qutip`` extra
    (``pip install qoc_tpu[qutip]``); the pulse-lookup callables come from
    the shared, ode-oracle-tested ``piecewise_uks_fns``.

    ``qt`` injects a qutip-API-compatible module — utils.qutip_shim uses
    this to give the branch executed coverage (Qobj wrapping, the
    time-dependent Ht_list format, sesolve, .full() readout) where real
    qutip cannot be installed."""
    if qt is None:
        try:
            import qutip as qt
        except ImportError as e:
            raise ImportError(
                "oracle='qutip' needs the optional qutip extra: "
                "pip install qoc_tpu[qutip] (the 'ode' oracle is the "
                "dependency-free stand-in with the same algorithm class; "
                "oracle='qutip-shim' runs this exact construction on the "
                "built-in API-compatible shim)"
            ) from e

    tlist = np.linspace(0, gate_time, steps + 1)
    Ht_list = [qt.Qobj(H0)]
    for Hk, u_fn in zip(Hops, piecewise_uks_fns(uks, gate_time, steps)):
        Ht_list.append([qt.Qobj(Hk), u_fn])
    out = qt.sesolve(Ht_list, qt.Qobj(psi0_c), tlist, [])
    states = np.array([s.full() for s in out.states])[:, :, 0]
    return np.transpose(states)


def qutip_verification(datafile: str, atol: float):
    """Reference-compatible entry point (qutip_verification.py:5); falls
    back to the ``ode`` oracle (same adaptive-ODE algorithm class as
    sesolve) when qutip is unavailable — which it is in this environment."""
    try:
        import qutip  # noqa: F401

        oracle = "qutip"
    except ImportError:
        oracle = "ode"
    result = verify_run(datafile, atol=atol, oracle=oracle)
    print("simulation verification result for each initial state (%s oracle)"
          % oracle)
    print("================================================")
    print("max abs diff: " + str(result["max_abs_diff"]))
    print("all close: " + str(result["all_close"]))
    print("================================================")
    return result
