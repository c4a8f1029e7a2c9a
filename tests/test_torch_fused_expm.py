"""The port's fused batched Taylor exponential against qoc_tpu's.

``qoc_tpu_torch.ops.fused_expm.fused_taylor_expm`` runs its plain versions
for CPU tensors (kernels 7-8 run on the card only); it is held against
qoc_tpu's Pallas kernel, interpreted on the CPU as tests/test_pallas_expm.py
runs it, at that file's cases: the forward, and the VJP against
``jax.grad``.  Inputs are made with numpy from a seed and handed to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qoc_tpu.ops.pallas_expm import fused_expm_supported as j_supported
from qoc_tpu.ops.pallas_expm import fused_taylor_expm as j_expm
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.ops.fused_expm import (
    fused_expm_backward_horner, fused_expm_backward_reference,
    fused_expm_reference, fused_expm_supported, fused_taylor_expm)

torch.set_num_threads(1)


def _A(T=5, M=32, scale=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, M, M)) * scale).astype(np.float32)


@pytest.mark.parametrize("order,scaling", [(1, 0), (3, 0), (2, 1), (12, 3)])
def test_forward_matches_qoc_tpu(order, scaling):
    A = _A()
    want = np.asarray(j_expm(jnp.asarray(A), order, scaling))
    got = fused_taylor_expm(torch.tensor(A), order, scaling).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_forward_matches_qoc_tpu_off_the_time_block():
    """T = 7 is not a multiple of qoc_tpu's time block (it pads with
    zeros); the port has no time blocks."""
    A = _A(T=7, scale=0.1, seed=1)
    want = np.asarray(j_expm(jnp.asarray(A), 5, 1))
    got = fused_taylor_expm(torch.tensor(A), 5, 1)
    assert got.shape == (7, 32, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("order,scaling", [(3, 0), (6, 2)])
def test_vjp_matches_qoc_tpu(order, scaling):
    """d/dA sum(sin(E)) through qoc_tpu's kernel (jax.grad) against the
    port's autograd.Function and its plain backward, 2e-6."""
    A = _A(seed=2)
    want = np.asarray(jax.grad(
        lambda a: jnp.sum(jnp.sin(j_expm(a, order, scaling))))(
            jnp.asarray(A)))
    At = torch.tensor(A, requires_grad=True)
    E = fused_taylor_expm(At, order, scaling)
    (got,) = torch.autograd.grad(torch.sum(torch.sin(E)), At)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    plain = fused_expm_backward_reference(torch.tensor(A), torch.cos(
        E.detach()), order, scaling)
    np.testing.assert_allclose(plain.numpy(), want, atol=2e-6)


@pytest.mark.parametrize("T,M,order,scaling,scale", [
    (5, 32, 1, 0, 0.05), (5, 32, 3, 0, 0.05), (5, 32, 2, 1, 0.05),
    (5, 32, 12, 3, 0.05), (5, 32, 6, 2, 0.05),
    (4, 120, 14, 0, 1.5 / np.sqrt(120))])   # |A| ~ 3, config 4's order
def test_horner_backward_matches_qoc_tpu(T, M, order, scaling, scale):
    """Kernel 8's association order (no stored powers) against jax.vjp
    through qoc_tpu's kernel, within 1e-5 of max|Abar|."""
    A = _A(T=T, M=M, scale=scale, seed=6)
    G = _A(T=T, M=M, scale=1.0, seed=7)
    _, vjp = jax.vjp(lambda a: j_expm(a, order, scaling), jnp.asarray(A))
    want = np.asarray(vjp(jnp.asarray(G))[0])
    got = fused_expm_backward_horner(torch.tensor(A), torch.tensor(G), order,
                                     scaling).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_scratch_bytes_do_not_grow_with_T():
    """No scratch at config 4's shape (kernel 7, and kernel 8 at s = 0);
    for every shape the gate admits, the same bytes at T = 1000 and T =
    16000 (the vmap rule folds 16 seeds into T); below the resident grid,
    fewer."""
    for kind in ("forward", "backward"):
        assert _cuda.expm_scratch_bytes(1000, 120, 14, 0, kind) == 0
        assert _cuda.expm_scratch_bytes(16000, 120, 14, 0, kind) == 0
    assert _cuda.expm_scratch_bytes(1000, 120, 14, 1, "backward") > 0
    for M in range(32, 513, 8):
        for order in (2, 8, 14, 20):
            for scaling in (0, 1, 3):
                if not fused_expm_supported(M, order, scaling):
                    continue
                for kind in ("forward", "backward"):
                    b = _cuda.expm_scratch_bytes(1000, M, order, scaling,
                                                 kind)
                    assert b == _cuda.expm_scratch_bytes(
                        16000, M, order, scaling, kind), (M, order, kind)
                    assert _cuda.expm_scratch_bytes(
                        7, M, order, scaling, kind) <= b
    assert (_cuda.expm_scratch_bytes(1000, 512, 6, 1, "backward")
            == _cuda.EXPM_MAX_GRID * 6 * 512 * 512 * 4)


def test_vmapped_gradient_matches_qoc_tpu():
    """Under ``torch.func.vmap`` of a gradient (the batch layer's vmapped
    backend) the seeds fold into the timesteps of one call; against
    jax.vmap(jax.grad) through qoc_tpu's kernel, with an operand shared
    across the vmapped entries, 2e-6."""
    A = _A(T=3, seed=4).reshape(1, 3, 32, 32) * np.arange(1, 3).reshape(
        2, 1, 1, 1).astype(np.float32)
    R = _A(T=3, scale=1.0, seed=5)

    def j_loss(a):
        return jnp.sum(jnp.sin(j_expm(a, 5, 1)) * R)

    def t_loss(a):
        return torch.sum(torch.sin(fused_taylor_expm(a, 5, 1))
                         * torch.tensor(R))

    want = np.asarray(jax.vmap(jax.grad(j_loss))(jnp.asarray(A)))
    got = torch.func.vmap(torch.func.grad(t_loss))(torch.tensor(A))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_supported_gate_is_qoc_tpu_s():
    for M in (8, 16, 24, 32, 120, 128, 130, 256, 512, 520):
        for order in (0, 1, 2, 8, 14, 20, 40):
            for scaling in (0, 1, 3, 8):
                assert (fused_expm_supported(M, order, scaling)
                        == j_supported(M, order, scaling)), (M, order, scaling)
    assert fused_expm_supported(120, 14, 0)     # config 4's batched step


def test_cpu_wrapper_is_the_plain_version():
    A = torch.tensor(_A(T=3, M=40, seed=3))
    np.testing.assert_array_equal(fused_taylor_expm(A, 6, 1).numpy(),
                                  fused_expm_reference(A, 6, 1).numpy())


@pytest.mark.parametrize("launch", ["forward", "backward", "wrapper"])
def test_off_the_cpu_never_falls_back(launch):
    """Tensors held off the CPU go to the CUDA launchers, which refuse
    anything but CUDA float32 operands instead of running the plain
    version."""
    A = torch.empty((4, 32, 32), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        if launch == "forward":
            _cuda.expm_forward(A, 6, 1)
        elif launch == "backward":
            _cuda.expm_backward(A, A, 6, 1)
        else:
            fused_taylor_expm(A, 6, 1)
