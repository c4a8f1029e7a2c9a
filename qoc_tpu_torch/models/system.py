"""Problem preprocessing: complex Hamiltonians -> device-ready arrays.

A numpy copy of ``qoc_tpu.models.system`` (the port never imports jax, so
the front end is copied; ``tests/test_torch_frontend.py`` pins the copy to
the original bit for bit).  ``interop.problem_tensors`` carries the arrays
onto a torch device.

Replacement for core/system_parameters.py.  Instead of a mutable
god-object, ``ControlProblem.build`` performs all host-side precomputation
once and returns an immutable spec whose array fields are ready to ship to
device:

  * dt, real-isomorphism generators ``mats = [-i dt H0, -i dt H_k]``
    (system_parameters.py:163-165, :194-251) — *without* the trailing
    identity of the reference's matrix_list; the identity term lives inside
    the Taylor kernel.
  * initial/target vectors, bare or dressed (system_parameters.py:168-191);
  * Taylor order + scaling auto-search (delegated to ops/taylor.py);
  * the 1-Gaussian envelope mask (system_parameters.py:253-266);
  * the initial pulse guess in base (arcsin) domain
    (system_parameters.py:272-284), with a loud error when a guess exceeds
    maxA (fixing the reference's max-only check, :44).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from ..ops.isomorphism import c_to_r_mat, c_to_r_vec
from ..ops.taylor import choose_taylor_terms
from ..utils.profiling import spanned
from .dressed import get_state_index, sort_ev


@dataclasses.dataclass(frozen=True)
class ControlProblem:
    """Immutable, device-ready GRAPE problem specification."""

    # static configuration
    state_num: int           # complex dimension N
    steps: int
    total_time: float
    dt: float
    ops_len: int             # number of control Hamiltonians K
    taylor_terms: int
    taylor_scaling: int
    state_transfer: bool
    use_inter_vecs: bool
    is_dressed: bool

    # arrays (host numpy; interop.problem_tensors moves them to a device)
    mats: np.ndarray             # [K+1, 2N, 2N]  -i*dt*H real iso, row 0 = H0
    mats_c: np.ndarray           # [K+1, N, N]  -i*dt*H complex64
    U0_iso: np.ndarray           # [2N, 2N]
    U0_c: np.ndarray             # [N, N] complex128 (full input precision;
    #                              device paths cast to f32/c64 themselves)
    target_unitary_iso: Optional[np.ndarray]   # [2N, 2N] (unitary mode)
    initial_vectors: np.ndarray  # [2N, V] stacked columns
    target_vectors: np.ndarray   # [2N, V] stacked columns
    ops_max_amp: np.ndarray      # [K]
    one_minus_gauss: np.ndarray  # [K, T]
    u0_base: np.ndarray          # [K, T] initial weights (base domain)
    v_sorted_iso: Optional[np.ndarray]  # [2N, 2N] dressed rotation or None

    # original complex inputs (for persistence / verification)
    H0_c: np.ndarray = None
    ops_c: Any = None
    Hnames: Any = None
    initial_vectors_c: np.ndarray = None
    dressed_info: Any = None
    states_concerned_list: Any = None
    U_c: np.ndarray = None       # original complex target (unitary [N,N]
    #                              or stacked target vectors [V, N])

    @staticmethod
    @spanned("qoc.problem.build")
    def build(
        H0,
        Hops,
        Hnames,
        U,
        total_time,
        steps,
        states_concerned_list,
        U0=None,
        dressed_info=None,
        maxA=None,
        initial_guess=None,
        unitary_error: float = 1e-4,
        state_transfer: bool = False,
        no_scaling: bool = False,
        Taylor_terms: Optional[Sequence[int]] = None,
        use_inter_vecs: bool = True,
        seed: Optional[int] = None,
    ) -> "ControlProblem":
        import warnings

        # --- loud input validation with shape context (the reference's
        # only check is the initial-guess amplitude bound,
        # system_parameters.py:38-46) ---
        H0 = np.asarray(H0, dtype=complex)
        if H0.ndim != 2 or H0.shape[0] != H0.shape[1]:
            raise ValueError(
                f"H0 must be a square [N, N] matrix; got shape {H0.shape}")
        Hops = [np.asarray(h, dtype=complex) for h in Hops]
        state_num = len(H0)
        ops_len = len(Hops)
        for i, h in enumerate(Hops):
            if h.shape != H0.shape:
                raise ValueError(
                    f"Hops[{i}] has shape {h.shape}; every control "
                    f"Hamiltonian must match H0's shape {H0.shape}")
        if Hnames is not None and len(Hnames) != ops_len:
            raise ValueError(
                f"Hnames has {len(Hnames)} entries for {ops_len} Hops")
        if int(steps) <= 0:
            raise ValueError(f"steps must be positive; got {steps}")
        if float(total_time) <= 0:
            raise ValueError(f"total_time must be positive; got {total_time}")
        herm_err = float(np.max(np.abs(H0 - H0.conj().T))) if state_num else 0.0
        if herm_err > 1e-8 * max(1.0, float(np.max(np.abs(H0)))):
            # stacklevel 3: past build's span wrapper, to build's caller
            warnings.warn(
                f"H0 is not Hermitian (max |H0 - H0^dag| = {herm_err:.2e}); "
                "propagation will not be unitary", stacklevel=3)
        dt = float(total_time) / steps

        if U0 is None:
            U0 = np.identity(state_num)
        U0 = np.asarray(U0, dtype=complex)
        if U0.shape != H0.shape:
            raise ValueError(
                f"U0 has shape {U0.shape}; expected {H0.shape} to match H0")

        # maxA defaulting (grape.py:95-101)
        if maxA is None:
            if initial_guess is None:
                ops_max_amp = 4.0 * np.ones(ops_len)
            else:
                ops_max_amp = 1.5 * np.max(np.abs(initial_guess)) * np.ones(ops_len)
        else:
            ops_max_amp = np.atleast_1d(np.asarray(maxA, dtype=float))
            if ops_max_amp.shape != (ops_len,):
                raise ValueError(
                    f"maxA has length {ops_max_amp.shape[0]}; expected one "
                    f"amplitude bound per control (K={ops_len})")

        # dressed info (system_parameters.py:75-80)
        is_dressed = False
        v_c = dressed_id = None
        v_sorted_iso = None
        if dressed_info is not None:
            v_c = np.asarray(dressed_info["eigenvectors"])
            dressed_id = list(dressed_info["dressed_id"])
            is_dressed = bool(dressed_info["is_dressed"])
            if is_dressed:
                v_sorted = sort_ev(v_c, dressed_id)
                v_sorted_iso = c_to_r_mat(v_sorted).astype(np.float32)

        # initial vectors (system_parameters.py:168-191)
        initial_vectors = []
        initial_vectors_c = []
        for i, state in enumerate(states_concerned_list):
            if state_transfer:
                vec_c = np.asarray(state, dtype=complex)
                if vec_c.shape != (state_num,):
                    raise ValueError(
                        f"states_concerned_list[{i}] has shape "
                        f"{vec_c.shape}; state-transfer mode takes state "
                        f"VECTORS of length N={state_num}")
            elif is_dressed:
                vec_c = v_c[:, get_state_index(state, dressed_id)]
            else:
                idx = int(state)
                if not 0 <= idx < state_num:
                    raise ValueError(
                        f"states_concerned_list[{i}]={idx} is outside the "
                        f"{state_num}-dimensional Hilbert space")
                vec_c = np.zeros(state_num, dtype=complex)
                vec_c[idx] = 1
            initial_vectors_c.append(vec_c)
            initial_vectors.append(c_to_r_vec(vec_c))
        initial_vectors = np.stack(initial_vectors, axis=1).astype(np.float32)
        initial_vectors_c = np.array(initial_vectors_c)

        # targets (system_parameters.py:56-65, tensorflow_state.py:158-165)
        if state_transfer:
            target_unitary_iso = None
            target_vectors = np.stack(
                [c_to_r_vec(np.asarray(t, dtype=complex)) for t in U], axis=1
            ).astype(np.float32)
        else:
            U = np.asarray(U, dtype=complex)
            if U.shape != H0.shape:
                raise ValueError(
                    f"target U has shape {U.shape}; expected {H0.shape} to "
                    "match H0 (or pass state_transfer=True with target "
                    "vectors)")
            target_unitary_iso = c_to_r_mat(U).astype(
                np.float32
            )
            target_vectors = (
                target_unitary_iso @ initial_vectors
            ).astype(np.float32)

        # Taylor order / scaling (system_parameters.py:208-230)
        if Taylor_terms is not None:
            taylor_terms, taylor_scaling = int(Taylor_terms[0]), int(Taylor_terms[1])
        else:
            taylor_terms, taylor_scaling = choose_taylor_terms(
                H0, Hops, ops_max_amp, U0, dt, steps, unitary_error,
                state_transfer, no_scaling,
            )

        # generators in real iso (system_parameters.py:194-206) and in
        # native complex64 (the alternative representation SURVEY sec 2.1
        # contemplates; kept for parity with qoc_tpu's problem spec)
        mats = np.stack(
            [c_to_r_mat(-1j * dt * H0)]
            + [c_to_r_mat(-1j * dt * op) for op in Hops]
        ).astype(np.float32)
        mats_c = np.stack(
            [-1j * dt * H0] + [-1j * dt * op for op in Hops]
        ).astype(np.complex64)

        # Gaussian envelope mask (system_parameters.py:253-266)
        gauss = np.exp(-np.power(np.linspace(-2, 2, steps), 2.0) / 2.0)
        shape = np.ones(steps) - gauss
        shape = shape * (shape > 0) + 0.01
        one_minus_gauss = np.tile(shape, (ops_len, 1)).astype(np.float32)

        # initial guess (system_parameters.py:38-46, :272-284)
        if initial_guess is not None:
            u0 = np.asarray(initial_guess, dtype=float).reshape(ops_len, steps)
            u0_norm = u0 / ops_max_amp[:, None]
            if np.max(np.abs(u0_norm)) > 1.0:
                bad = int(np.argmax(np.max(np.abs(u0_norm), axis=1)))
                raise ValueError(
                    f"Initial guess has strength > max_amp for op {bad}"
                )
            u0_base = np.arcsin(u0_norm)
        else:
            rng = np.random.default_rng(seed) if seed is not None else np.random
            u0_base = rng.normal(0, 1.0 / np.sqrt(steps), (ops_len, steps))
        u0_base = u0_base.astype(np.float32)

        return ControlProblem(
            state_num=state_num,
            steps=int(steps),
            total_time=float(total_time),
            dt=dt,
            ops_len=ops_len,
            taylor_terms=taylor_terms,
            taylor_scaling=taylor_scaling,
            state_transfer=bool(state_transfer),
            use_inter_vecs=bool(use_inter_vecs),
            is_dressed=is_dressed,
            mats=mats,
            mats_c=mats_c,
            U0_iso=c_to_r_mat(U0).astype(np.float32),
            U0_c=U0.astype(np.complex128),
            target_unitary_iso=target_unitary_iso,
            initial_vectors=initial_vectors,
            target_vectors=target_vectors,
            ops_max_amp=ops_max_amp.astype(np.float32),
            one_minus_gauss=one_minus_gauss,
            u0_base=u0_base,
            v_sorted_iso=v_sorted_iso,
            H0_c=H0,
            ops_c=Hops,
            Hnames=list(Hnames) if Hnames is not None else None,
            initial_vectors_c=initial_vectors_c,
            dressed_info=dressed_info,
            states_concerned_list=list(states_concerned_list),
            U_c=(np.stack([np.asarray(t, dtype=complex) for t in U])
                 if state_transfer else np.asarray(U, dtype=complex)),
        )
