"""qoc_tpu_torch — qoc_tpu's GRAPE quantum optimal control on PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of ``qoc_tpu`` (JAX/Pallas on TPU), which stays the reference: the
numpy front end is copied from it, and ``tests/test_torch_*.py`` hold every
ported module against its qoc_tpu counterpart.  This package never imports
jax.  Its CUDA kernels (``csrc/``) are built with nvcc at the first launch
on a CUDA tensor, never at import.
"""

from .grape import Grape, GrapeResult
from .models.system import ControlProblem
from .models.gates import (
    qft, hadamard, Hadamard, rz, rx, transmon_gate, concerned, is_binary,
    hamming_distance, base_n, baseN, basis_string, Basis, bin_string, Bin,
)
from .models.operators import (
    kron_all, kron_all_reference, multi_kron, append_separate_krons,
    nn_chain_kron, annihilate, create, number,
    SIGMA_X, SIGMA_Y, SIGMA_Z, SIGMA_P, SIGMA_M,
)
from .models.dressed import (
    get_dressed_info, sort_ev, get_state_index, dressed_unitary,
)
from .ops.isomorphism import c_to_r_mat, c_to_r_vec, r_to_c_mat, r_to_c_vec

__version__ = "0.1.0"
