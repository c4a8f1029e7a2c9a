"""Build and bind the port's CUDA kernels (``qoc_tpu_torch/csrc``).

``nvcc`` compiles ``csrc/tree_chain.cu`` and ``csrc/mega.cu`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
ctypes.  The build runs at the first launch, never at import, into
``<repo>/.torch_ext_build/<hash of sources and flags>/``; it takes about a
minute (18 template instances; no PyTorch headers are compiled).  ptxas'
register and spill report is kept beside the library as ``build.log``.

There is no fallback: a missing ``nvcc``, a failed build or a failed
launch raises.  Each launch wrapper checks its tensors, launches on
PyTorch's current stream, raises on a non-zero ``cudaGetLastError`` and
adds one to its entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("tree_chain.cu", "mega.cu")
HEADERS = ("tree_chain.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
SUPPORTED_M = (2, 4, 6, 8, 10, 12)
SMEM_LIMIT = 48 * 1024     # the kernels' dynamic shared memory (mats)
MAX_V = 16                 # kMaxV in mega.cu

# kernel name -> launches since the last reset_launch_counts()
LAUNCHES = {"tree_forward": 0, "tree_backward": 0, "mega_segment": 0}

_lib = None
_lock = threading.Lock()
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


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
    tmp = out_dir / f"build-{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.qoc_tree_forward.argtypes = [_P, _P, _I, _I, _I, _I, _I,
                                             _P, _P, _P, _P, _P]
            lib.qoc_tree_backward.argtypes = [_P, _I, _I, _I, _I, _I, _P, _P,
                                              _P, _P, _P, _P, _P]
            lib.qoc_mega_segment.argtypes = (
                [_P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I]
                + [_P] * 14 + [_F] * 11 + [_P])
            lib.qoc_error_string.argtypes = [_I]
            lib.qoc_error_string.restype = ctypes.c_char_p
            for fn in (lib.qoc_tree_forward, lib.qoc_tree_backward,
                       lib.qoc_mega_segment):
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
    return torch.cuda.current_stream(dev).cuda_stream


def residual_shapes(M: int, Tp: int, order: int, scaling: int):
    """Shapes of the Taylor-power, pre-squaring and tree-level residuals."""
    L = Tp.bit_length() - 1
    return ((max(order - 1, 1), M, M, Tp), (max(scaling, 1), M, M, Tp),
            (L, M, M, Tp))


def tree_forward(mats, w, order: int, scaling: int):
    """Kernel 1: mats [K, M, M], w [K, Tp] (Tp a power of two, padded lanes
    all zero) -> (E [M, M], an, sq, tree residuals)."""
    dev = _check(mats, w)
    K, M, _ = mats.shape
    Tp = w.shape[1]
    _check_shape(K, M, Tp)
    E = torch.empty((M, M), dtype=torch.float32, device=dev)
    an, sq, tree = (torch.empty(s, dtype=torch.float32, device=dev)
                    for s in residual_shapes(M, Tp, order, scaling))
    lib = _library()
    code = lib.qoc_tree_forward(
        mats.data_ptr(), w.data_ptr(), K, M, Tp, order, scaling,
        E.data_ptr(), an.data_ptr(), sq.data_ptr(), tree.data_ptr(),
        _stream(dev))
    _raise_on(code, "tree_forward")
    LAUNCHES["tree_forward"] += 1
    return E, an, sq, tree


def tree_backward(mats, an, sq, tree, gbar, order: int, scaling: int):
    """Kernel 2: residuals of ``tree_forward`` and gbar [M, M] (cotangent
    of E) -> wbar [K, Tp]."""
    dev = _check(mats, an, sq, tree, gbar)
    K, M, _ = mats.shape
    Tp = tree.shape[-1]
    _check_shape(K, M, Tp)
    bar = torch.empty((M, M, Tp), dtype=torch.float32, device=dev)
    wbar = torch.empty((K, Tp), dtype=torch.float32, device=dev)
    code = _library().qoc_tree_backward(
        mats.data_ptr(), K, M, Tp, order, scaling, an.data_ptr(),
        sq.data_ptr(), tree.data_ptr(), gbar.data_ptr(), bar.data_ptr(),
        wbar.data_ptr(), _stream(dev))
    _raise_on(code, "tree_backward")
    LAUNCHES["tree_backward"] += 1
    return wbar


def mega_segment(mats, psi0p, target, maxamp, u0rows, u, m, v, sf, *,
                 N: int, T: int, order: int, scaling: int, n_iters: int,
                 unitary_mode: bool, b1: float, b2: float, eps: float,
                 rate_factor: float, conv_target: float, min_grad: float,
                 max_iterations: float, scratch):
    """Kernel 3: ``n_iters`` Adam iterations in one launch.  u, m, v
    [Kc, Tp] are updated IN PLACE; sf [3] = (lr, iteration, done).
    Returns met [8] = (loss, grad^2, unitary_scale, lr, iteration, done,
    reg_loss, 0).  ``scratch`` comes from ``mega_scratch`` and may be
    reused across launches on one stream."""
    import numpy as np

    dev = _check(mats, psi0p, target, maxamp, u0rows, u, m, v, sf)
    K, M, _ = mats.shape
    Tp = u.shape[1]
    V = psi0p.shape[1]
    _check_shape(K, M, Tp)
    if V > MAX_V:
        raise ValueError(f"V={V} concerned vectors exceed {MAX_V}")
    an, sq, tree, bar, g = scratch
    met = torch.empty(8, dtype=torch.float32, device=dev)
    code = _library().qoc_mega_segment(
        mats.data_ptr(), K, M, N, T, Tp, V, order, scaling, int(n_iters),
        int(bool(unitary_mode)), psi0p.data_ptr(), target.data_ptr(),
        maxamp.data_ptr(), u0rows.data_ptr(), u.data_ptr(), m.data_ptr(),
        v.data_ptr(), sf.data_ptr(), met.data_ptr(), an.data_ptr(),
        sq.data_ptr(), tree.data_ptr(), bar.data_ptr(), g.data_ptr(),
        b1, b2, float(1.0 - b1), float(1.0 - b2), eps,
        float(np.log(b1)), float(np.log(b2)), rate_factor, conv_target,
        min_grad, float(max_iterations), _stream(dev))
    _raise_on(code, "mega_segment")
    LAUNCHES["mega_segment"] += 1
    return met


def mega_scratch(K: int, M: int, Tp: int, order: int, scaling: int,
                 dev: torch.device):
    """(an, sq, tree, bar, g) scratch of the segment kernel."""
    shapes = residual_shapes(M, Tp, order, scaling) + ((M, M, Tp),
                                                       (K - 1, Tp))
    return tuple(torch.empty(s, dtype=torch.float32, device=dev)
                 for s in shapes)
