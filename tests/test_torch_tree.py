"""The port's tree chain and plain propagation ops against qoc_tpu.

``qoc_tpu_torch.ops.tree_chain.fused_tree_chain`` takes its plain torch
version for CPU tensors; it is held against qoc_tpu's Pallas tree kernel
(interpreted on the CPU, as qoc_tpu's own tests run it), forward and
gradient.  Inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoc_tpu.ops import expm as jexpm
from qoc_tpu.ops import propagation as jprop
from qoc_tpu.ops.inner_products import inner_product_2d as j_ip2d
from qoc_tpu.ops.pallas_tree import fused_tree_chain as j_tree
from qoc_tpu.ops.pallas_tree import tree_chain_supported as j_supported
from qoc_tpu_torch.ops import expm as texpm
from qoc_tpu_torch.ops import propagation as tprop
from qoc_tpu_torch.ops.inner_products import inner_product_2d as t_ip2d
from qoc_tpu_torch.ops.tree_chain import (
    fused_tree_chain, tree_chain_reference, tree_chain_supported)

torch.set_num_threads(1)

CASES = [(3, 4, 64, 2, 0), (3, 4, 37, 6, 2), (6, 8, 50, 3, 0),
         (4, 12, 16, 4, 1), (3, 4, 1, 6, 0)]


def _inputs(K, M, T, seed=0):
    rng = np.random.default_rng(seed)
    mats = (0.1 * rng.standard_normal((K, M, M))).astype(np.float32)
    w = rng.standard_normal((K, T)).astype(np.float32)
    w[0] = 1.0
    R = rng.standard_normal((M, M)).astype(np.float32)
    return mats, w, R


def _max_rel(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6)


@pytest.mark.parametrize("K,M,T,order,scaling", CASES)
def test_tree_forward_matches_qoc_tpu(K, M, T, order, scaling):
    mats, w, _ = _inputs(K, M, T)
    want = np.asarray(j_tree(jnp.asarray(mats), jnp.asarray(w), order,
                             scaling))
    got = fused_tree_chain(torch.tensor(mats), torch.tensor(w), order,
                           scaling).numpy()
    assert _max_rel(got, want) < 2e-5


@pytest.mark.parametrize("K,M,T,order,scaling", CASES)
def test_tree_gradient_matches_qoc_tpu(K, M, T, order, scaling):
    mats, w, R = _inputs(K, M, T, seed=1)
    want = np.asarray(jax.grad(lambda w_: jnp.sum(
        j_tree(jnp.asarray(mats), w_, order, scaling) * R))(jnp.asarray(w)))
    wt = torch.tensor(w, requires_grad=True)
    E = fused_tree_chain(torch.tensor(mats), wt, order, scaling)
    (got,) = torch.autograd.grad(torch.sum(E * torch.tensor(R)), wt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    mats, w, _ = _inputs(3, 6, 20)
    a = fused_tree_chain(torch.tensor(mats), torch.tensor(w), 4, 1)
    b = tree_chain_reference(torch.tensor(mats), torch.tensor(w), 4, 1)
    assert torch.equal(a, b)


def test_non_cpu_tensor_never_falls_back():
    """A tensor that is not on the CPU goes to the CUDA wrapper, which
    refuses anything but CUDA float32 operands instead of running the
    plain version."""
    mats = torch.zeros((2, 4, 4), device="meta")
    w = torch.zeros((2, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_tree_chain(mats, w, 2, 0)


def test_supported_bound_matches_qoc_tpu():
    for M in (2, 4, 8, 12, 14, 64):
        for T in (1, 100, 1000, 5000, 8192, 20000):
            assert tree_chain_supported(M, T) == j_supported(M, T), (M, T)


@pytest.mark.parametrize("order,scaling", [(2, 0), (6, 2), (3, 1)])
def test_taylor_expm_matches(order, scaling):
    rng = np.random.default_rng(2)
    A = (0.3 * rng.standard_normal((5, 4, 4))).astype(np.float32)
    want = np.asarray(jexpm.taylor_expm(jnp.asarray(A), order, scaling))
    got = texpm.taylor_expm(torch.tensor(A), order, scaling).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    psi = rng.standard_normal((4, 3)).astype(np.float32)
    want = np.asarray(jexpm.taylor_expm_matvec(jnp.asarray(A[0]),
                                               jnp.asarray(psi), order))
    got = texpm.taylor_expm_matvec(torch.tensor(A[0]), torch.tensor(psi),
                                   order).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_inner_product_2d_matches():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal((6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        float(t_ip2d(torch.tensor(a), torch.tensor(b), 3)),
        float(j_ip2d(jnp.asarray(a), jnp.asarray(b), 3)), rtol=1e-5)


@pytest.mark.parametrize("final_only", [True, False])
def test_state_transfer_scan_matches(final_only):
    mats, w, _ = _inputs(3, 4, 30, seed=5)
    psi0 = np.random.default_rng(6).standard_normal((4, 2)).astype(np.float32)
    want = np.asarray(jprop.state_transfer_chain(
        jnp.asarray(mats), jnp.asarray(w), jnp.asarray(psi0), 4,
        engine="scan", final_only=final_only))
    got = tprop.state_transfer_chain(
        torch.tensor(mats), torch.tensor(w), torch.tensor(psi0), 4,
        engine="scan", final_only=final_only).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine,use_inter_vecs",
                         [("scan", True), ("scan", False), ("tree", False)])
def test_evolve_unitary_matches(engine, use_inter_vecs):
    mats, w, _ = _inputs(3, 4, 21, seed=7)
    rng = np.random.default_rng(8)
    U0 = rng.standard_normal((4, 4)).astype(np.float32)
    psi0 = rng.standard_normal((4, 2)).astype(np.float32)
    j_engine = "associative" if engine == "tree" else engine
    U_want, iv_want = jprop.evolve_unitary(
        jnp.asarray(mats), jnp.asarray(w), jnp.asarray(U0),
        jnp.asarray(psi0), 5, 1, engine=j_engine,
        use_inter_vecs=use_inter_vecs)
    U_got, iv_got = tprop.evolve_unitary(
        torch.tensor(mats), torch.tensor(w), torch.tensor(U0),
        torch.tensor(psi0), 5, 1, engine=engine,
        use_inter_vecs=use_inter_vecs)
    np.testing.assert_allclose(U_got.numpy(), np.asarray(U_want),
                               rtol=1e-5, atol=1e-5)
    if use_inter_vecs:
        np.testing.assert_allclose(iv_got.numpy(), np.asarray(iv_want),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert iv_got is None and iv_want is None
