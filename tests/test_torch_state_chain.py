"""The port's column-batched state chain against qoc_tpu's.

``qoc_tpu_torch.ops.state_chain.fused_state_chain`` takes its plain torch
version for CPU tensors; it is held against qoc_tpu's Pallas chain kernel
(interpreted on the CPU, as qoc_tpu's own tests run it): the forward, and
both cotangents against ``jax.vjp``, at the shapes of
tests/test_pallas_kernels.py:78-150 with and without squarings, Taylor
orders up to 12, and column counts that are not a multiple of anything.
Inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoc_tpu.ops.pallas_chain import fused_state_chain as j_chain
from qoc_tpu.ops.pallas_chain import fused_state_chain_with_traj as j_traj
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.state_chain import (
    fused_state_chain, fused_state_chain_with_traj, state_chain_reference)

torch.set_num_threads(1)

# (K, M, C, T, order, scaling): test_pallas_kernels.py's shapes (C = 4,
# 2, 2), then squarings and odd column counts
CASES = [(3, 6, 4, 12, 5, 0), (2, 4, 2, 8, 4, 0), (2, 4, 2, 6, 12, 0),
         (3, 4, 7, 8, 3, 2), (4, 8, 13, 5, 8, 1), (2, 2, 3, 9, 2, 0)]


def _inputs(K, M, C, T, seed=0):
    rng = np.random.default_rng(seed)
    mats = (0.1 * rng.standard_normal((K, M, M))).astype(np.float32)
    w = rng.standard_normal((T, K, C)).astype(np.float32)
    w[:, 0, :] = 1.0
    psi0 = rng.standard_normal((M, C)).astype(np.float32)
    gbar = rng.standard_normal((M, C)).astype(np.float32)
    return mats, w, psi0, gbar


def _max_rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)


@pytest.mark.parametrize("K,M,C,T,order,scaling", CASES)
def test_forward_and_cotangents_match_qoc_tpu(K, M, C, T, order, scaling):
    """Forward within 2e-5 relative, both cotangents within 1e-4 relative
    (the tree kernels' and test_pallas_kernels.py's tolerances)."""
    mats, w, psi0, gbar = _inputs(K, M, C, T)
    out_j, vjp = jax.vjp(
        lambda w_, p_: j_chain(jnp.asarray(mats), w_, p_, order, scaling),
        jnp.asarray(w), jnp.asarray(psi0))
    wbar_j, psibar_j = vjp(jnp.asarray(gbar))

    wt = torch.tensor(w, requires_grad=True)
    pt = torch.tensor(psi0, requires_grad=True)
    out = fused_state_chain(torch.tensor(mats), wt, pt, order, scaling)
    wbar, psibar = torch.autograd.grad(out, (wt, pt), torch.tensor(gbar))
    assert _max_rel(out.detach().numpy(), np.asarray(out_j)) < 2e-5
    assert _max_rel(wbar.numpy(), np.asarray(wbar_j)) < 1e-4
    assert _max_rel(psibar.numpy(), np.asarray(psibar_j)) < 1e-4


@pytest.mark.parametrize("K,M,C,T,order,scaling", CASES[:2] + CASES[3:4])
def test_trajectory_matches_qoc_tpu(K, M, C, T, order, scaling):
    mats, w, psi0, _ = _inputs(K, M, C, T, seed=1)
    out_j, traj_j = j_traj(jnp.asarray(mats), jnp.asarray(w),
                           jnp.asarray(psi0), order, scaling)
    out, traj = fused_state_chain_with_traj(
        torch.tensor(mats), torch.tensor(w), torch.tensor(psi0), order,
        scaling)
    assert traj.shape == (T + 1, M, C)
    assert _max_rel(traj.numpy(), np.asarray(traj_j)) < 2e-5
    np.testing.assert_array_equal(traj[-1].numpy(), out.numpy())
    np.testing.assert_array_equal(traj[0].numpy(), psi0)


def test_cpu_wrapper_is_the_plain_version():
    mats, w, psi0, _ = _inputs(3, 4, 5, 6)
    args = (torch.tensor(mats), torch.tensor(w), torch.tensor(psi0), 4, 1)
    np.testing.assert_array_equal(fused_state_chain(*args).numpy(),
                                  state_chain_reference(*args).numpy())


@pytest.mark.parametrize("launch", ["forward", "backward", "wrapper"])
def test_off_the_cpu_never_falls_back(launch):
    """Tensors held off the CPU go to the CUDA launchers, which refuse
    anything but CUDA float32 operands instead of running the plain
    version."""
    K, M, C, T = 3, 4, 5, 6
    dev = torch.device("meta")
    mats = torch.empty((K, M, M), device=dev)
    w = torch.empty((T, K, C), device=dev)
    psi0 = torch.empty((M, C), device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "forward":
            _cuda.state_chain_forward(mats, w, psi0, 3, 0)
        elif launch == "backward":
            _cuda.state_chain_backward(mats, w,
                                       torch.empty((T + 1, M, C), device=dev),
                                       psi0, 3, 0)
        else:
            fused_state_chain(mats, w, psi0, 3, 0)
