"""Build and bind the port's CUDA kernels (``qoc_tpu_torch/csrc``).

``nvcc`` compiles each source of ``SOURCES`` (the tree chain, the fused
segment's two instances, the state chain, the fused batched optimizer's
two instances, the batched Taylor exponential, and the pscan engine's
sweeps) for ``sm_90a`` (one
process per source, all started together), then links them into one
shared library with a plain C interface, loaded with ctypes.  The build
runs at the first launch, never at import, into
``<repo>/.torch_ext_build/<hash of sources and flags>/`` (no PyTorch
headers are compiled).  ptxas' register and spill
report is kept beside the library as ``build.log``.

There is no fallback: a missing ``nvcc``, a failed build or a failed
launch raises.  Each launch wrapper checks its tensors, launches on
PyTorch's current stream, raises on a non-zero ``cudaGetLastError`` and
adds one to its entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("tree_chain.cu", "mega.cu", "mega_costs.cu", "state_chain.cu",
           "mega_batch.cu", "mega_batch_costs.cu", "expm.cu",
           "pscan_sweep.cu")
HEADERS = ("tree_chain.cuh", "mega.cuh", "state_chain.cuh", "mega_batch.cuh",
           "expm.cuh", "pscan_sweep.cuh", "sm90.cuh", "team.cuh")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SUPPORTED_M = (2, 4, 6, 8, 10, 12)
SMEM_LIMIT = 48 * 1024     # the kernels' dynamic shared memory (mats)
MAX_V = 16                 # kMaxV in mega.cuh
MAX_V_TRAJ = 8             # kMaxVTraj in mega.cuh (trajectory mode)
MEGA_THREADS = 512         # kMegaThreads in mega.cuh (kernel 3's block)
MEGA_SMEM_MAX = 232448     # kMegaSmemMax in mega.cuh
MAX_K = 16                 # kMaxK in state_chain.cuh (generators per step)
MAX_V_BATCH = 8            # kMaxVBatch in mega_batch.cuh
TEAM_THREADS = 32          # kTeamThreads in state_chain.cu (kernels 4-5)
CHAIN_SMEM_MAX = 232448    # dynamic shared memory a block may opt into
EXPM_SHARED_MAX_M = 120    # kExpmSharedMaxM in expm.cuh
EXPM_MAX_GRID = 264        # kExpmMaxGrid in expm.cuh (two blocks per SM)
EXPM_SLOTS = {"forward": 3, "backward": 5}   # kForwardSlots, kBackwardSlots
# kernel 6's clock64 phases, in the order of its counters (kClockPhases)
CLOCK_PHASES = ("sin", "forward", "fidelity", "reverse", "penalties",
                "gradient", "adam")
# kernel 3's clock64 phases, in the order of its counters
# (kMegaClockPhases in mega.cuh)
MEGA_CLOCK_PHASES = ("taylor_forward", "penalties", "chain_forward", "loss",
                     "trajectory", "chain_reverse", "taylor_reverse",
                     "grad2_convergence", "adam")

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"tree_forward": 0, "tree_backward": 0, "mega_segment": 0,
            "mega_segment_costs": 0, "state_chain_forward": 0,
            "state_chain_backward": 0, "mega_batch_segment": 0,
            "mega_batch_segment_costs": 0, "expm_forward": 0,
            "expm_backward": 0, "pscan_forward": 0, "pscan_reverse": 0}

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class CostArgs(ctypes.Structure):
    """Mirror of ``qoc::CostArgs`` (mega.cuh), field for field."""

    _fields_ = ([(n, _P) for n in ("env", "forb", "dftc", "dfts", "dftct",
                                    "dftst", "spec")]
                + [(n, _I) for n in ("nforb", "F", "traj")]
                + [(n, _F) for n in ("a_amp", "a_env", "a_dwdt", "a_d2",
                                      "inv_dt", "a_bp", "a_spd", "spd_c0",
                                      "forb_c0")])


class BatchAdam(ctypes.Structure):
    """Mirror of ``qoc::BatchAdam`` (mega_batch.cuh)."""

    _fields_ = [(n, _F) for n in ("b1", "b2", "one_minus_b1", "one_minus_b2",
                                  "eps", "ln_b1", "ln_b2", "ln_f", "rate",
                                  "conv_target", "min_grad",
                                  "max_iterations")]


class BatchCostArgs(ctypes.Structure):
    """Mirror of ``qoc::BatchCostArgs`` (mega_batch.cuh), field for field."""

    _fields_ = ([(n, _P) for n in ("env2", "forb", "dftc", "dfts", "spec",
                                    "ov")]
                + [(n, _I) for n in ("nforb", "F")]
                + [(n, _F) for n in ("a_amp", "a_env", "a_dwdt", "c_dwdt",
                                      "a_d2", "c_d2", "inv_dt", "idt2",
                                      "a_bp", "a_spd", "spd_c0", "forb_c0")])


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from csrc/ at first use")
    return found


def build() -> Path:
    """Compile the kernels if this exact source + flag set is not built yet;
    return the library path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / "libqoc_tpu_torch_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = str(os.getpid())
    objs = [out_dir / f"{Path(src).stem}-{tag}.o" for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
            for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    failed = [o for p, o in zip(procs, outs) if p.returncode != 0]
    tmp = out_dir / f"build-{tag}.so"
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(proc.stdout + proc.stderr)
    (out_dir / "build.log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.qoc_tree_forward.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                                             _P, _P, _P, _P]
            lib.qoc_tree_backward.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                                              _P, _P, _P, _P, _P]
            mega = ([_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I]
                    + [_P] * 12 + [_F] * 11)
            lib.qoc_mega_segment.argtypes = mega + [_P]
            lib.qoc_mega_segment_costs.argtypes = mega + [
                ctypes.POINTER(CostArgs), _P]
            lib.qoc_state_chain_forward.argtypes = ([_P] * 3 + [_I] * 6
                                                    + [_P] * 3)
            lib.qoc_state_chain_backward.argtypes = ([_P] * 4 + [_I] * 6
                                                     + [_P] * 3)
            batch = ([_P] + [_I] * 9 + [_P] * 15
                     + [ctypes.POINTER(BatchAdam)])
            lib.qoc_mega_batch_segment.argtypes = batch + [_P]
            lib.qoc_mega_batch_segment_costs.argtypes = batch + [
                ctypes.POINTER(BatchCostArgs), _P]
            _L = ctypes.c_long
            lib.qoc_expm_forward.argtypes = [_P, _I, _I, _I, _I, _P, _P, _L,
                                             _P]
            lib.qoc_expm_backward.argtypes = [_P, _P, _I, _I, _I, _I, _P, _P,
                                              _L, _P]
            lib.qoc_expm_scratch_floats.argtypes = [_I, _I, _I, _I]
            lib.qoc_expm_scratch_floats.restype = _L
            lib.qoc_pscan_geometry.argtypes = [_I, _I, _I, _I, _P]
            lib.qoc_pscan_geometry.restype = None
            lib.qoc_pscan_forward.argtypes = [_P, _L, _P, _L, _P] + [_I] * 5 + [
                _P]
            lib.qoc_pscan_reverse.argtypes = [_P, _L, _P, _L, _P, _P] + [
                _I] * 5 + [_P]
            lib.qoc_error_string.argtypes = [_I]
            lib.qoc_error_string.restype = ctypes.c_char_p
            for fn in (lib.qoc_tree_forward, lib.qoc_tree_backward,
                       lib.qoc_mega_segment, lib.qoc_mega_segment_costs,
                       lib.qoc_state_chain_forward,
                       lib.qoc_state_chain_backward,
                       lib.qoc_mega_batch_segment,
                       lib.qoc_mega_batch_segment_costs,
                       lib.qoc_expm_forward, lib.qoc_expm_backward,
                       lib.qoc_pscan_forward, lib.qoc_pscan_reverse):
                fn.restype = _I
            _lib = lib
    return _lib


def _check(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for x in tensors:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"CUDA kernel operand on {x.device}; all "
                             f"operands must be on one CUDA device")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("CUDA kernel operands must be contiguous "
                             f"float32 (got {x.dtype}, contiguous="
                             f"{x.is_contiguous()})")
    return dev


def _check_shape(K: int, M: int, Tp: int) -> None:
    if Tp < 2 or Tp & (Tp - 1):
        raise ValueError(f"lane count Tp={Tp} is not a power of two >= 2")
    if M not in SUPPORTED_M:
        raise ValueError(f"matrix dimension M={M} is not one of {SUPPORTED_M}")
    if K * M * M * 4 > SMEM_LIMIT:
        raise ValueError(f"{K} generators of {M}x{M} exceed the kernels' "
                         f"{SMEM_LIMIT}-byte shared-memory copy")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _library().qoc_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def _stream(dev: torch.device) -> int:
    """PyTorch's current stream on ``dev``, as a raw handle (the call
    Inductor's generated code uses: no Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


class TreeGeometry(NamedTuple):
    """The launch of kernels 1 and 2 (``tree_geometry`` in tree_chain.cuh)."""

    blocks: int     # G blocks on G SMs, a cluster in kernel 1 (0: no fit)
    threads: int    # per block
    team: int       # lanes per team (team_lanes(M))
    teams: int      # per block, one segment each
    lanes_per_block: int   # Tp / G
    segment: int    # lanes a team walks
    smem_fwd: int   # dynamic shared memory of a block, bytes: kernel 1
    smem_bwd: int   # kernel 2


TREE_THREADS = 512         # kTreeThreads in tree_chain.cuh
TREE_MAX_BLOCKS = 8        # kTreeMaxBlocks
TREE_SMEM_MAX = 232448     # kTreeSmemMax
TREE_TEAM_MATS = 3         # kTreeTeamMats: kernel 2's team scratch


def _tree_layout(G: int, M: int, Tp: int, K: int, order: int,
                 cap: int) -> TreeGeometry:
    """``tree_layout`` in tree_chain.cuh: the block's threads and the
    floats of both kernels' shared memory.  Both: the generators
    [K][M][M+1] and 1/k for k <= order.  Kernel 1: the block's tree of
    segment products, the cluster's products, each team's P_t.  Kernel 2:
    the prefix at each lane, nu at each segment boundary, and the tree with
    the cluster's products, or (later, in the same place) each team's
    three matrices of scratch."""
    L = team_lanes(M)
    TB = Tp // G
    NT = min(max(TB * L, 32), cap)
    teams = NT // L
    S = TB // teams if TB > teams else 1
    mat = M * ((M + 3) & ~3)
    head = _al4(K * M * (M + 1)) + _al4(order + 1)
    fwd = head + (2 * teams - 1 + G + teams) * mat
    bwd = head + (teams * S + teams + 1) * mat + max(
        (2 * teams - 1 + G) * mat, teams * TREE_TEAM_MATS * mat)
    return TreeGeometry(G, NT, L, teams, TB, S, 4 * fwd, 4 * bwd)


@functools.lru_cache(maxsize=256)
def tree_geometry(M: int, Tp: int, K: int, order: int,
                  scaling: int) -> TreeGeometry:
    """Kernels 1-2's rule (``tree_geometry`` in tree_chain.cuh): G = Tp / 32
    blocks, between 1 and 8 (a portable cluster), of at most 64 teams and
    512 threads; where kernel 2's shared memory would not fit, half the
    threads, down to one warp; ``blocks`` is 0 where nothing fits.
    ``scaling`` does not enter: no squaring is stored, the pre-squaring
    values are recomputed in the team's scratch."""
    G = min(max(Tp // 32, 1), TREE_MAX_BLOCKS)
    cap = min(64 * team_lanes(M), TREE_THREADS)
    g = _tree_layout(G, M, Tp, K, order, cap)
    while g.smem_bwd > TREE_SMEM_MAX and cap > 32:
        cap //= 2
        g = _tree_layout(G, M, Tp, K, order, cap)
    return g if g.smem_bwd <= TREE_SMEM_MAX else g._replace(blocks=0)


@functools.lru_cache(maxsize=256)
def residual_shape(M: int, Tp: int, K: int, order: int, scaling: int):
    """Shape of kernel 1's residuals: each segment's product (G teams of
    them), then each block's, [G teams + G, M, M]: about (Tp / S + G) M^2
    floats."""
    g = tree_geometry(M, Tp, K, order, scaling)
    return (g.blocks * (g.teams + 1), M, M)


# kernels 1-2's clock64 phases, in the order of their counters
# (kTreeFwdPhases, kTreeBwdPhases in tree_chain.cuh)
TREE_FWD_CLOCK_PHASES = ("walks", "block_tree", "cluster")
TREE_BWD_CLOCK_PHASES = ("block_tree", "cluster", "down_tree", "walks",
                         "reverse_walks", "taylor_reverse")


def _tree_checks(K: int, M: int, Tp: int, order: int,
                 scaling: int) -> TreeGeometry:
    _check_shape(K, M, Tp)
    if order < 0 or not 0 <= scaling <= 30:
        raise ValueError(f"Taylor order {order}, scaling {scaling} outside "
                         "the tree kernels' bounds (order >= 0, scaling "
                         "<= 30)")
    geo = tree_geometry(M, Tp, K, order, scaling)
    if geo.blocks == 0:
        raise ValueError(
            f"tree kernels at M={M}, Tp={Tp}, K={K}, order {order} need more "
            f"than {TREE_SMEM_MAX} bytes of shared memory per block")
    return geo


def tree_forward(mats, w, order: int, scaling: int, clocks=None):
    """Kernel 1: mats [K, M, M], w [K, Tp] (Tp a power of two, padded lanes
    all zero) -> (E [M, M], res): E = P_{Tp-1} ... P_0 and the residuals
    of ``residual_shape``.  The launch is one cluster of
    ``tree_geometry(...).blocks`` blocks.  ``clocks`` (int64 [rows >= those
    blocks, len(TREE_FWD_CLOCK_PHASES)], zeroed by the caller) receives
    each block's clock64 cycles per phase."""
    dev = _check(mats, w)
    K, M, M2 = mats.shape
    Tp = w.shape[1]
    geo = _tree_checks(K, M, Tp, order, scaling)
    if M2 != M or tuple(w.shape) != (K, Tp):
        raise ValueError(f"generators {tuple(mats.shape)} and weights "
                         f"{tuple(w.shape)} do not match")
    _check_clocks(clocks, dev, geo.blocks, TREE_FWD_CLOCK_PHASES)
    E = torch.empty((M, M), dtype=torch.float32, device=dev)
    res = torch.empty(residual_shape(M, Tp, K, order, scaling),
                      dtype=torch.float32, device=dev)
    code = _library().qoc_tree_forward(
        mats.data_ptr(), w.data_ptr(), K, M, Tp, order, scaling,
        E.data_ptr(), res.data_ptr(),
        None if clocks is None else clocks.data_ptr(), _stream(dev))
    _raise_on(code, "tree_forward")
    LAUNCHES["tree_forward"] += 1
    return E, res


def tree_backward(mats, w, res, gbar, order: int, scaling: int,
                  clocks=None):
    """Kernel 2: the forward's operands and residuals, gbar [M, M] (the
    cotangent of E) -> wbar [K, Tp].  ``clocks``: as ``tree_forward``'s,
    with ``TREE_BWD_CLOCK_PHASES``."""
    dev = _check(mats, w, res, gbar)
    K, M, M2 = mats.shape
    Tp = w.shape[1]
    geo = _tree_checks(K, M, Tp, order, scaling)
    if (M2 != M or tuple(w.shape) != (K, Tp) or tuple(gbar.shape) != (M, M)
            or tuple(res.shape) != residual_shape(M, Tp, K, order, scaling)):
        raise ValueError("tree backward operands do not match the forward's")
    _check_clocks(clocks, dev, geo.blocks, TREE_BWD_CLOCK_PHASES)
    wbar = torch.empty((K, Tp), dtype=torch.float32, device=dev)
    code = _library().qoc_tree_backward(
        mats.data_ptr(), w.data_ptr(), K, M, Tp, order, scaling,
        res.data_ptr(), gbar.data_ptr(), wbar.data_ptr(),
        None if clocks is None else clocks.data_ptr(), _stream(dev))
    _raise_on(code, "tree_backward")
    LAUNCHES["tree_backward"] += 1
    return wbar


class MegaGeometry(NamedTuple):
    """Kernel 3's launch (``mega_geometry`` in mega.cuh)."""

    blocks: int     # the cluster: G blocks on G SMs (0: nothing fits)
    threads: int    # per block
    team: int       # lanes per team (team_lanes(M))
    teams: int      # per block, one segment each
    lanes_per_block: int   # Tp / G
    segment: int    # lanes a team walks
    smem: int       # dynamic shared memory of a block, bytes


def _al4(n: int) -> int:
    return (n + 3) & ~3


def _mega_layout(G: int, M: int, Tp: int, K: int, V: int, order: int,
                 scaling: int, traj: bool, cap: int) -> MegaGeometry:
    """``mega_layout`` in mega.cuh: the block's threads and the floats of
    its shared memory (generators, series coefficients, the segment tree,
    the states and cotangents at every lane and segment boundary, the
    cluster's products, each team's walk scratch, reductions; in
    trajectory mode the costs' overlaps and direct cotangents per lane)."""
    L = team_lanes(M)
    TB = Tp // G
    NT = min(max(TB * L, 32), cap)
    teams = NT // L
    S = TB // teams if TB > teams else 1
    nterms, reps, MP = order + 1, 1 << scaling, (M + 3) & ~3
    mat, vec = M * MP, V * MP
    TS = _al4(max(2 * mat, (reps + nterms + 2 + L) * MP) + vec)
    floats = (_al4(K * M * (M + 1)) + _al4(nterms) + _al4(K)
              + (2 * teams - 1) * mat + (2 * teams - 1) * vec * traj
              + (teams * S + 1) * vec + (teams + 1) * vec + G * mat
              + G * vec * traj + 2 * (V + 1) * MP + 3 * vec + teams * TS
              + NT + 8 + (2 * teams * S + (teams * S + 1) * vec) * traj)
    return MegaGeometry(G, NT, L, teams, TB, S, 4 * floats)


def mega_geometry(M: int, Tp: int, K: int, V: int, order: int, scaling: int,
                  *, costs: bool = False, traj: bool = False) -> MegaGeometry:
    """Kernel 3's rule (``mega_geometry`` in mega.cuh): G = Tp / 32 blocks,
    between 1 and 8 (a portable cluster), of at most 64 teams and 512
    threads (256 for the costs instance, ``costs``; ``traj``: its
    trajectory mode); where that would not fit a block's shared memory, 16
    blocks, then 16 blocks of half the threads; ``blocks`` is 0 where
    nothing fits."""
    G = min(max(Tp // 32, 1), 8)
    costs = costs or traj
    cap = min(64 * team_lanes(M),   # mega_max_threads
              MEGA_THREADS // 2 if costs else MEGA_THREADS)
    g = _mega_layout(G, M, Tp, K, V, order, scaling, traj, cap)
    if g.smem > MEGA_SMEM_MAX and Tp >= 32:
        g = _mega_layout(16, M, Tp, K, V, order, scaling, traj, cap)
    if g.smem > MEGA_SMEM_MAX and Tp >= 32 and cap > 32:
        g = _mega_layout(16, M, Tp, K, V, order, scaling, traj, cap // 2)
    return g if g.smem <= MEGA_SMEM_MAX else g._replace(blocks=0)


def _check_clocks(clocks, dev, blocks: int, phases) -> None:
    if clocks is not None and (
            clocks.device != dev or clocks.dtype != torch.int64
            or not clocks.is_contiguous() or clocks.dim() != 2
            or clocks.shape[0] < blocks or clocks.shape[1] != len(phases)):
        raise ValueError("clocks must be a contiguous int64 tensor of "
                         f"[>= {blocks}, {len(phases)}] on the kernel's "
                         "device")


def _mega_args(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, met,
               scratch, clocks, costs, traj, N, T, order, scaling, n_iters,
               unitary_mode, b1, b2, eps, rate_factor, conv_target, min_grad,
               max_iterations):
    """The operands both segment entry points share, in C order; raises
    where the problem is outside kernel 3's bounds."""
    K, M, _ = mats.shape
    Kc, Tp = u.shape
    V = psi0p.shape[1]
    vmax = MAX_V_TRAJ if traj else MAX_V
    if V > vmax:
        raise ValueError(f"V={V} concerned vectors exceed {vmax}")
    if not 0 <= scaling <= 20 or order < 0:
        raise ValueError(f"Taylor order {order}, scaling {scaling} outside "
                         "kernel 3's bounds (order >= 0, scaling <= 20)")
    geo = mega_geometry(M, Tp, K, V, order, scaling, costs=costs, traj=traj)
    if geo.blocks == 0:
        raise ValueError(
            f"kernel 3 at M={M}, Tp={Tp}, K={K}, V={V}, order {order}, "
            f"scaling {scaling} needs more than {MEGA_SMEM_MAX} bytes of "
            "shared memory per block even over 16 blocks")
    sw, g = scratch[:2]
    if (tuple(sw.shape) != (Kc, Tp) or tuple(g.shape) != (Kc, Tp)
            or tuple(m.shape) != (Kc, Tp) or tuple(v.shape) != (Kc, Tp)):
        raise ValueError("segment scratch does not match the problem")
    _check_clocks(clocks, mats.device, geo.blocks, MEGA_CLOCK_PHASES)
    return (mats.data_ptr(), K, M, N, T, Tp, V, order, scaling, int(n_iters),
            int(bool(unitary_mode)), psi0p.data_ptr(), target.data_ptr(),
            maxamp.data_ptr(), u0rows.data_ptr(), u.data_ptr(), m.data_ptr(),
            v.data_ptr(), sf.data_ptr(), met.data_ptr(), sw.data_ptr(),
            g.data_ptr(), None if clocks is None else clocks.data_ptr(), b1,
            b2, float(1.0 - b1), float(1.0 - b2), eps, math.log(b1),
            math.log(b2), rate_factor, conv_target, min_grad,
            float(max_iterations))


def mega_segment(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, *,
                 N: int, T: int, order: int, scaling: int, n_iters: int,
                 unitary_mode: bool, b1: float, b2: float, eps: float,
                 rate_factor: float, conv_target: float, min_grad: float,
                 max_iterations: float, scratch, clocks=None):
    """Kernel 3, fidelity-only instance: ``n_iters`` Adam iterations in one
    launch.  u, m, v [Kc, Tp] are updated IN PLACE; sf [3] = (lr,
    iteration, done).  Returns met [8] = (loss, grad^2, unitary_scale, lr,
    iteration, done, reg_loss, 0).  ``scratch`` comes from
    ``mega_scratch`` and may be reused across launches on one stream.
    The launch is one cluster of ``mega_geometry(...).blocks`` blocks.
    ``clocks`` (int64 [rows >= those blocks, len(MEGA_CLOCK_PHASES)],
    zeroed by the caller) receives each block's clock64 cycles per phase,
    summed over the iterations."""
    dev = _check(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, *scratch)
    K, M, _ = mats.shape
    _check_shape(K, M, u.shape[1])
    met = torch.empty(8, dtype=torch.float32, device=dev)
    code = _library().qoc_mega_segment(
        *_mega_args(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, met,
                    scratch, clocks, False, False, N, T, order, scaling,
                    n_iters, unitary_mode, b1, b2, eps, rate_factor,
                    conv_target, min_grad, max_iterations), _stream(dev))
    _raise_on(code, "mega_segment")
    LAUNCHES["mega_segment"] += 1
    return met


def mega_segment_costs(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, *,
                       costs, N: int, T: int, order: int, scaling: int,
                       n_iters: int, unitary_mode: bool, b1: float,
                       b2: float, eps: float, rate_factor: float,
                       conv_target: float, min_grad: float,
                       max_iterations: float, scratch, clocks=None):
    """Kernel 3, costs instance: as ``mega_segment`` with the penalties of
    ``costs`` (``ops.mega.SegmentCosts``); ``scratch`` comes from
    ``mega_costs_scratch``.  met[6] is loss + penalties."""
    c = costs
    dev = _check(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, c.env,
                 c.forb, c.dftc, c.dfts, c.dftct, c.dftst, *scratch)
    K, M, _ = mats.shape
    Tp = u.shape[1]
    _check_shape(K, M, Tp)
    F = c.dftc.shape[1]
    spec = scratch[2]
    G = mega_geometry(M, Tp, K, psi0p.shape[1], order, scaling, costs=True,
                      traj=c.traj).blocks
    if (c.env.shape != (K - 1, Tp) or c.forb.shape[-1] != 1 + 2 * M
            or c.dftct.shape != (F, Tp)
            or spec.numel() < 2 * G * (K - 1) * F * 2):
        raise ValueError("segment cost operands do not match the problem")
    met = torch.empty(8, dtype=torch.float32, device=dev)
    args = CostArgs(
        c.env.data_ptr(), c.forb.data_ptr(), c.dftc.data_ptr(),
        c.dfts.data_ptr(), c.dftct.data_ptr(), c.dftst.data_ptr(),
        spec.data_ptr(), c.forb.shape[0], F, int(c.traj), c.a_amp, c.a_env,
        c.a_dwdt, c.a_d2, c.inv_dt, c.a_bp, c.a_spd, c.spd_c0, c.forb_c0)
    code = _library().qoc_mega_segment_costs(
        *_mega_args(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, met,
                    scratch, clocks, True, c.traj, N, T, order, scaling,
                    n_iters, unitary_mode, b1, b2, eps, rate_factor,
                    conv_target, min_grad, max_iterations),
        ctypes.byref(args), _stream(dev))
    _raise_on(code, "mega_segment_costs")
    LAUNCHES["mega_segment_costs"] += 1
    return met


def mega_scratch(K: int, Tp: int, dev: torch.device):
    """(sw, g) scratch of kernel 3's fidelity-only instance: sin(u) and the
    gradient [K-1, Tp]; nothing of order M^2 Tp (the kernel keeps its
    chain in shared memory and replays the Taylor powers)."""
    return tuple(torch.empty((K - 1, Tp), dtype=torch.float32, device=dev)
                 for _ in range(2))


def mega_costs_scratch(K: int, M: int, Tp: int, V: int, order: int,
                       scaling: int, F: int, traj: bool, dev: torch.device):
    """(sw, g, spec) scratch of kernel 3's costs instance: as
    ``mega_scratch``, plus the bandpass spectra [2, G, K-1, F, 2] (each
    block's partial sums, then each block's finished spectrum)."""
    G = mega_geometry(M, Tp, K, V, order, scaling, costs=True,
                      traj=traj).blocks
    spec = torch.empty((2, max(G, 1), max(K - 1, 1), max(F, 1), 2),
                       dtype=torch.float32, device=dev)
    return mega_scratch(K, Tp, dev) + (spec,)


def team_lanes(M: int) -> int:
    """Lanes of a column's team in kernels 5 and 6 (``team_lanes`` in
    state_chain.cuh): the least power of two >= M."""
    return 2 if M <= 2 else 4 if M <= 4 else 8 if M <= 8 else 16


def team_slots(K: int) -> int:
    """Generator slots of kernels 5 and 6 (``team_slots`` in
    state_chain.cuh): the least of 4, 8, 16 that holds K."""
    return 4 if K <= 4 else 8 if K <= 8 else 16


class BatchGeometry(NamedTuple):
    """Kernel 6's launch (``batch_geometry`` in mega_batch.cuh)."""

    lanes: int      # per column (team_lanes(M))
    groups: int     # seed groups (V teams each) per block
    threads: int    # per block, whole warps
    blocks: int


def batch_geometry(M: int, V: int, C: int) -> BatchGeometry:
    """A seed group of V * L lanes never straddles a block: where it fits a
    warp, a block is one warp of 32 // (V * L) groups, else one group;
    blocks are whole warps (the lanes past the groups idle)."""
    L = team_lanes(M)
    G = V * L
    groups = 32 // G if G <= 32 else 1
    return BatchGeometry(L, groups, -(-groups * G // 32) * 32,
                         -(-(C // V) // groups))


def _smem_floats(K: int, M: int, order: int, scaling: int, threads: int,
                 group_sums: bool) -> int:
    return (team_slots(K) * M * (M + 1) + order
            + (threads // team_lanes(M) if group_sums else 0)
            + (order << scaling) * threads)


class ChainGeometry(NamedTuple):
    """The launch of kernels 4 and 5 (``team_blocks`` in state_chain.cu)."""

    lanes: int      # per column (team_lanes(M))
    threads: int    # per block: one warp
    blocks: int


def chain_geometry(M: int, C: int) -> ChainGeometry:
    """A team of ``team_lanes(M)`` lanes per column, 32 / L columns in a
    one-warp block, a grid over the column groups."""
    L = team_lanes(M)
    return ChainGeometry(L, TEAM_THREADS, -(-C * L // TEAM_THREADS))


def state_chain_forward_smem(K: int, M: int, order: int) -> int:
    """Bytes of kernel 4's shared memory (``chain_forward_smem_floats``):
    the generators [team_slots(K)][M][M+1] and the Taylor coefficients."""
    return 4 * (team_slots(K) * M * (M + 1) + order)


def state_chain_backward_smem(K: int, M: int, order: int,
                              scaling: int) -> int:
    """Bytes of kernel 5's shared memory (``chain_backward_smem_floats``):
    the generators [team_slots(K)][M][M+1], the Taylor coefficients and a
    step's replayed powers [2^s * order][TEAM_THREADS]."""
    return 4 * _smem_floats(K, M, order, scaling, TEAM_THREADS, False)


def mega_batch_smem(K: int, M: int, V: int, order: int, scaling: int) -> int:
    """Bytes of kernel 6's shared memory (``batch_smem_floats``): as kernel
    5's for its block, plus a float per column for the group sums."""
    threads = batch_geometry(M, V, V).threads
    return 4 * _smem_floats(K, M, order, scaling, threads, True)


def chain_fits(K: int, M: int, order: int = 1, scaling: int = 0,
               V: int = 1) -> bool:
    """The bounds of the chain kernels (state chain and batched optimizer):
    M compiled, at most ``MAX_K`` generators per step, and the shared
    memory of kernels 4, 5 and 6 (generators, coefficients and, for 5 and
    6, a step's replayed powers at V concerned vectors) within
    ``CHAIN_SMEM_MAX``."""
    if M not in SUPPORTED_M or K > MAX_K or not 1 <= V <= MAX_V_BATCH:
        return False
    return (max(state_chain_forward_smem(K, M, order),
                state_chain_backward_smem(K, M, order, scaling),
                mega_batch_smem(K, M, V, order, scaling)) <= CHAIN_SMEM_MAX)


def _check_chain(K: int, M: int, order: int = 1, scaling: int = 0,
                 V: int = 1) -> None:
    if not chain_fits(K, M, order, scaling, V):
        raise ValueError(
            f"{K} generators of {M}x{M} at order {order}, scaling {scaling} "
            f"are outside the chain kernels' bounds (M in {SUPPORTED_M}, at "
            f"most {MAX_K} generators, within {CHAIN_SMEM_MAX} bytes of "
            "shared memory)")


def state_chain_forward(mats, w, psi0, order: int, scaling: int):
    """Kernel 4: mats [K, M, M], w [T, K, C], psi0 [M, C] -> (psi_T [M, C],
    trajectory [T+1, M, C])."""
    dev = _check(mats, w, psi0)
    K, M, _ = mats.shape
    T, Kw, C = w.shape
    _check_chain(K, M, order, scaling)
    if Kw != K or tuple(psi0.shape) != (M, C) or order < 1 or C < 1:
        raise ValueError("state chain operands do not match: mats "
                         f"{tuple(mats.shape)}, w {tuple(w.shape)}, psi0 "
                         f"{tuple(psi0.shape)}, order {order}")
    out = torch.empty((M, C), dtype=torch.float32, device=dev)
    traj = torch.empty((T + 1, M, C), dtype=torch.float32, device=dev)
    code = _library().qoc_state_chain_forward(
        mats.data_ptr(), w.data_ptr(), psi0.data_ptr(), K, M, T, C, order,
        scaling, out.data_ptr(), traj.data_ptr(), _stream(dev))
    _raise_on(code, "state_chain_forward")
    LAUNCHES["state_chain_forward"] += 1
    return out, traj


def state_chain_backward(mats, w, traj, gbar, order: int, scaling: int):
    """Kernel 5: the forward's operands and trajectory, gbar [M, C] (the
    cotangent of psi_T) -> (wbar [T, K, C], psibar [M, C])."""
    dev = _check(mats, w, traj, gbar)
    K, M, _ = mats.shape
    T, Kw, C = w.shape
    _check_chain(K, M, order, scaling)
    if (Kw != K or tuple(traj.shape) != (T + 1, M, C)
            or tuple(gbar.shape) != (M, C) or order < 1):
        raise ValueError("state chain operands do not match the forward's")
    wbar = torch.empty((T, K, C), dtype=torch.float32, device=dev)
    psibar = torch.empty((M, C), dtype=torch.float32, device=dev)
    code = _library().qoc_state_chain_backward(
        mats.data_ptr(), w.data_ptr(), traj.data_ptr(), gbar.data_ptr(), K, M,
        T, C, order, scaling, wbar.data_ptr(),
        psibar.data_ptr(), _stream(dev))
    _raise_on(code, "state_chain_backward")
    LAUNCHES["state_chain_backward"] += 1
    return wbar, psibar


def mega_batch_scratch(M: int, T: int, Kc: int, C: int, V: int,
                       dev: torch.device):
    """(traj [T+1, C, M], sn [S, T, Kc], wbar [C, T, Kc], gs [S, T, Kc])
    scratch of kernel 6 for C columns of V vectors (S = C / V seeds)."""
    S = C // V
    shapes = ((T + 1, C, M), (S, T, Kc), (C, T, Kc), (S, T, Kc))
    return tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in shapes)


def mega_batch_costs_scratch(T: int, Kc: int, C: int, V: int, F: int,
                             dev: torch.device):
    """(spec [S, Kc * F, 2], ov [T+1, 2, C]) scratch of kernel 6's costs
    instance."""
    return (torch.empty((C // V, max(Kc * F, 1), 2), dtype=torch.float32,
                        device=dev),
            torch.empty((T + 1, 2, C), dtype=torch.float32, device=dev))


def clock_split(clocks: torch.Tensor, phases=CLOCK_PHASES) -> dict:
    """Each phase's share of the cycles in a clock buffer ([blocks,
    len(phases)] int64; kernel 6's ``CLOCK_PHASES`` by default, kernel 3's
    ``MEGA_CLOCK_PHASES``), summed over blocks; all zero when the buffer
    is."""
    tot = clocks.to(torch.float64).sum(dim=0).tolist()
    whole = sum(tot)
    return {name: (x / whole if whole else 0.0)
            for name, x in zip(phases, tot)}


def mega_batch_segment(mats, maxamp, psi0, tgt, ew, u, m, v, itc, done, *,
                       order: int, scaling: int, n_iters: int, adam: dict,
                       scratch, costs=None, cost_scratch=None, clocks=None):
    """Kernel 6: ``n_iters`` Adam iterations for every seed in one launch.

    mats [K, M, M] (drift, Kc controls, E extra channels), maxamp [Kc],
    psi0 / tgt [M, V], ew [E, C] (a dummy [1, C] when E = 0); u, m, v
    [T, Kc, C] and itc, done [1, C] are updated IN PLACE.  ``adam`` holds
    the ``BatchAdam`` fields, ``scratch`` comes from ``mega_batch_scratch``.
    With ``costs`` (``parallel.mega_batch.BatchCosts``) the costs instance
    runs, with ``cost_scratch`` from ``mega_batch_costs_scratch``.
    ``clocks`` (int64 [rows >= batch_geometry(M, V, C).blocks,
    len(CLOCK_PHASES)], zeroed by the caller) receives each block's clock64
    cycles per phase, summed over the iterations; ``clock_split`` reads it.
    Returns stats [3, C] = (loss, grad^2, reg_loss) per column."""
    tensors = [mats, maxamp, psi0, tgt, ew, u, m, v, itc, done, *scratch]
    if costs is not None:
        tensors += [costs.env2, costs.forb, costs.dftc, costs.dfts,
                    *cost_scratch]
    dev = _check(*tensors)
    K, M, _ = mats.shape
    T, Kc, C = u.shape
    V = psi0.shape[1]
    if V > MAX_V_BATCH or C % V:
        raise ValueError(f"V={V} concerned vectors (at most {MAX_V_BATCH}, "
                         f"dividing the {C} columns)")
    _check_chain(K, M, order, scaling, V)
    traj, sn, wbar, gs = scratch
    E = K - 1 - Kc
    S = C // V
    if (E < 0 or (E and ew.shape[0] != E) or ew.shape[1] != C
            or tuple(psi0.shape) != (M, V) or tuple(tgt.shape) != (M, V)
            or tuple(traj.shape) != (T + 1, C, M)
            or tuple(sn.shape) != (S, T, Kc) or tuple(gs.shape) != (S, T, Kc)
            or tuple(wbar.shape) != (C, T, Kc)
            or tuple(maxamp.shape) != (Kc,) or n_iters < 1 or order < 1):
        raise ValueError("batched segment operands do not match the problem")
    _check_clocks(clocks, dev, batch_geometry(M, V, C).blocks, CLOCK_PHASES)
    stats = torch.empty((3, C), dtype=torch.float32, device=dev)
    args = [mats.data_ptr(), K, M, Kc, V, T, C, order, scaling, int(n_iters),
            maxamp.data_ptr(), psi0.data_ptr(), tgt.data_ptr(),
            ew.data_ptr(), u.data_ptr(), m.data_ptr(), v.data_ptr(),
            itc.data_ptr(), done.data_ptr(), stats.data_ptr(),
            traj.data_ptr(), sn.data_ptr(), wbar.data_ptr(), gs.data_ptr(),
            None if clocks is None else clocks.data_ptr(),
            ctypes.byref(BatchAdam(**adam))]
    lib = _library()
    if costs is None:
        code = lib.qoc_mega_batch_segment(*args, _stream(dev))
        name = "mega_batch_segment"
    else:
        c = costs
        spec, ov = cost_scratch
        F = c.dftc.shape[1]
        if (tuple(spec.shape) != (S, max(Kc * F, 1), 2)
                or tuple(ov.shape) != (T + 1, 2, C)
                or c.forb.shape[-1] != 1 + 2 * M
                or tuple(c.env2.shape) != (T, Kc)):
            raise ValueError("batched segment cost operands do not match "
                             "the problem")
        ca = BatchCostArgs(
            c.env2.data_ptr(), c.forb.data_ptr(), c.dftc.data_ptr(),
            c.dfts.data_ptr(), spec.data_ptr(), ov.data_ptr(),
            c.forb.shape[0], F, c.a_amp, c.a_env, c.a_dwdt, c.c_dwdt,
            c.a_d2, c.c_d2, c.inv_dt, c.idt2, c.a_bp, c.a_spd, c.spd_c0,
            c.forb_c0)
        code = lib.qoc_mega_batch_segment_costs(*args, ctypes.byref(ca),
                                                _stream(dev))
        name = "mega_batch_segment_costs"
    _raise_on(code, name)
    LAUNCHES[name] += 1
    return stats


def expm_scratch_bytes(T: int, M: int, order: int, scaling: int,
                       kind: str) -> int:
    """Bytes of device scratch kernel 7 (``kind="forward"``) or kernel 8
    (``"backward"``) takes for A [T, M, M] (``expm_scratch_floats`` in
    expm.cuh, which the launch checks it against).  Zero on the shared
    path (kernel 7 at M <= 120; kernel 8 at M <= 120 with s = 0); on the
    staged path a few M x M slots per resident block, at most
    ``EXPM_MAX_GRID`` blocks, so it stops growing with T there.  ``order``
    does not enter: no power of A is stored."""
    if kind not in EXPM_SLOTS:
        raise ValueError(f"kind is 'forward' or 'backward', not {kind!r}")
    backward = kind == "backward"
    if M <= EXPM_SHARED_MAX_M and (not backward or scaling == 0):
        return 0
    slots = EXPM_SLOTS[kind] + (scaling if backward else 0)
    return min(T, EXPM_MAX_GRID) * slots * M * M * 4


def _check_expm(A, order: int, scaling: int):
    T, M, M2 = A.shape
    if (M != M2 or M < 8 or M % 8 or T < 1 or order < 0 or scaling < 0
            or scaling > 30):
        raise ValueError(f"expm kernels take A [T >= 1, M, M] with M a "
                         f"multiple of 8 (got {tuple(A.shape)}, order "
                         f"{order}, scaling {scaling})")
    return T, M


def _expm_scratch(T: int, M: int, order: int, scaling: int, kind: str,
                  dev: torch.device) -> torch.Tensor:
    """The launch's scratch, empty on the shared path (a null pointer);
    the caller keeps it alive across the launch."""
    return torch.empty(expm_scratch_bytes(T, M, order, scaling, kind) // 4,
                       dtype=torch.float32, device=dev)


def expm_forward(A, order: int, scaling: int):
    """Kernel 7: A [T, M, M] -> E [T, M, M] = Taylor_order(A / 2^s)^(2^s)."""
    dev = _check(A)
    T, M = _check_expm(A, order, scaling)
    E = torch.empty_like(A)
    scratch = _expm_scratch(T, M, order, scaling, "forward", dev)
    code = _library().qoc_expm_forward(
        A.data_ptr(), T, M, order, scaling, E.data_ptr(), scratch.data_ptr(),
        4 * scratch.numel(), _stream(dev))
    _raise_on(code, "expm_forward")
    LAUNCHES["expm_forward"] += 1
    return E


def expm_backward(A, Ebar, order: int, scaling: int):
    """Kernel 8: A and Ebar (the cotangent of E) [T, M, M] -> Abar
    [T, M, M], the exact VJP of kernel 7."""
    dev = _check(A, Ebar)
    T, M = _check_expm(A, order, scaling)
    if Ebar.shape != A.shape:
        raise ValueError(f"Ebar {tuple(Ebar.shape)} does not match A "
                         f"{tuple(A.shape)}")
    Abar = torch.empty_like(A)
    scratch = _expm_scratch(T, M, order, scaling, "backward", dev)
    code = _library().qoc_expm_backward(
        A.data_ptr(), Ebar.data_ptr(), T, M, order, scaling, Abar.data_ptr(),
        scratch.data_ptr(), 4 * scratch.numel(), _stream(dev))
    _raise_on(code, "expm_backward")
    LAUNCHES["expm_backward"] += 1
    return Abar


class PscanGeometry(NamedTuple):
    """A sweep's launch (``pscan_geometry`` in pscan_sweep.cuh)."""

    cluster: int    # blocks a tile of a seed (a cluster, or a group in L2)
    rows: int       # rows of Q a block owns (the wide reverse: columns)
    chunk: int      # on chip: rows a ring stage holds
    chunks: int     # on chip: stages a step of a full slab takes
    stages: int     # on chip: ring depth
    groups: int     # the reverse's row groups
    smem: int       # dynamic shared memory of a block, bytes
    wide: int       # 1: the state passes through L2
    vt: int         # columns a tile
    tiles: int      # tiles of the V columns


def pscan_geometry(M: int, V: int, reps: int,
                   reverse: bool) -> Optional[PscanGeometry]:
    """The built library's launch of a sweep on the current card (None
    where it does not take the shape), for tests and measurements: the
    launch itself decides, and raises where it cannot."""
    out = (ctypes.c_int * 10)()
    _library().qoc_pscan_geometry(M, V, reps, int(reverse), out)
    return PscanGeometry(*out) if out[0] else None


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x, or a copy of it where its data does not start on the 16 bytes
    that the sweeps' bulk copies need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pscan_operands(Q, x, reps: int, seeds: int, reverse: bool):
    """(device, T, M, V, seed strides) of a sweep's operands: Q [T, M, M]
    or [seeds, T, M, M]; x [rows, M, V] or [seeds, rows, M, V] (the
    forward's psi0 has no rows dimension); an operand without the seeds
    dimension is every seed's.  The launch decides what shapes it takes."""
    dev = _check(Q, x)
    T, M = Q.shape[-3], Q.shape[-1]
    lead = 3 if reverse else 2
    if (Q.dim() not in (3, 4) or Q.shape[-2] != M
            or x.dim() not in (lead, lead + 1) or x.shape[-2] != M
            or (reverse and x.shape[-3] != T * reps + 1)
            or (Q.dim() == 4 and Q.shape[0] != seeds)
            or (x.dim() == lead + 1 and x.shape[0] != seeds)):
        raise ValueError(
            f"pscan sweep operands Q {tuple(Q.shape)}, "
            f"{'g' if reverse else 'psi0'} {tuple(x.shape)}, reps {reps}, "
            f"{seeds} seeds do not fit together")
    q_seed = T * M * M if Q.dim() == 4 else 0
    x_seed = x[0].numel() if x.dim() == lead + 1 else 0
    return dev, T, M, x.shape[-1], q_seed, x_seed


def pscan_forward(Q, psi0, reps: int, seeds: int = 1):
    """The forward sweep: Q [T, M, M] (or [seeds, T, M, M]), psi0 [M, V]
    (or [seeds, M, V]) -> vecs [seeds, T * reps + 1, M, V], psi_{p+1} =
    Q_t psi_p with t = p // reps."""
    Q, psi0 = _aligned(Q), _aligned(psi0)
    dev, T, M, V, q_seed, x_seed = _pscan_operands(Q, psi0, reps, seeds,
                                                   False)
    vecs = torch.empty((seeds, T * reps + 1, M, V), dtype=torch.float32,
                       device=dev)
    code = _library().qoc_pscan_forward(
        Q.data_ptr(), q_seed, psi0.data_ptr(), x_seed, vecs.data_ptr(),
        seeds, T, M, V, reps, _stream(dev))
    _raise_on(code, "pscan_forward")
    LAUNCHES["pscan_forward"] += 1
    return vecs


def pscan_reverse(Q, g, reps: int, seeds: int = 1):
    """The adjoint sweep: Q as for the forward, g [T * reps + 1, M, V] (or
    [seeds, ...]), the cotangent of the trajectory -> (lams [seeds, T *
    reps, M, V], psi0_bar [seeds, M, V]): lam_i = mu + g_{i+1}, mu <-
    Q_t^T lam_i for i = T reps - 1 .. 0, psi0_bar = mu + g_0."""
    Q, g = _aligned(Q), _aligned(g)
    dev, T, M, V, q_seed, g_seed = _pscan_operands(Q, g, reps, seeds, True)
    lams = torch.empty((seeds, T * reps, M, V), dtype=torch.float32,
                       device=dev)
    psi0_bar = torch.empty((seeds, M, V), dtype=torch.float32, device=dev)
    code = _library().qoc_pscan_reverse(
        Q.data_ptr(), q_seed, g.data_ptr(), g_seed, lams.data_ptr(),
        psi0_bar.data_ptr(), seeds, T, M, V, reps, _stream(dev))
    _raise_on(code, "pscan_reverse")
    LAUNCHES["pscan_reverse"] += 1
    return lams, psi0_bar
