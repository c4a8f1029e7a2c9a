"""On-card test lane of qoc_tpu_torch: the counterpart of tests_tpu/.

The main suite (tests/) runs the port on the CPU through its plain torch
versions; this lane runs the hand-written CUDA kernels on the card and
holds them against float64 host oracles (scipy's Pade expm per step, an
adaptive ODE solver, float64 unitaries) and against the port's own
per-iteration engines run on the same card.  Each test keeps its
tests_tpu tolerance.  Run it on the card:

    python -m pytest tests_gpu -q

The ``device`` fixture yields ``cuda:0``; without a card every test
skips, unless ``QOC_TPU_TORCH_TEST_DEVICE=cpu`` is set: then the lane's
oracle logic runs on the CPU through the plain versions (no kernel
launches, so the routing checks are the card's only).  Every test carries
the ``gpu`` marker and records the gaps it measured against its oracles
(``record_property``: junit XML properties).
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import qoc_tpu_torch as q
from qoc_tpu_torch.models.system import ControlProblem
from qoc_tpu_torch.ops import _cuda

DEVICE_ENV = "QOC_TPU_TORCH_TEST_DEVICE"


@pytest.fixture(scope="session")
def device():
    if os.environ.get(DEVICE_ENV) == "cpu":
        torch.set_num_threads(1)
        return torch.device("cpu")
    if not torch.cuda.is_available():
        pytest.skip(f"needs an NVIDIA card (torch sees none; "
                    f"{DEVICE_ENV}=cpu runs the lane on the CPU)")
    return torch.device("cuda", 0)


@pytest.fixture
def rng():
    return np.random.default_rng(20260819)


@contextlib.contextmanager
def launches(device, *kernels):
    """On the card: each of ``kernels`` (names in ``_cuda.LAUNCHES``)
    must launch at least once inside the block.  Yields the counts."""
    before = dict(_cuda.LAUNCHES)
    got = {}
    yield got
    got.update({k: _cuda.LAUNCHES[k] - before[k] for k in _cuda.LAUNCHES})
    if device.type == "cuda":
        assert all(got[k] >= 1 for k in kernels), (kernels, got)


def gap(a, b) -> float:
    """max |a - b|: the number each test records (``record_property``)
    beside its bar, so that a run's junit XML carries the measured gaps."""
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


def random_hermitian(n: int, rng, scale: float = 1.0) -> np.ndarray:
    a = rng.normal(size=(n, n)) + 1j * rng.normal(size=(n, n))
    return scale * (a + a.conj().T) / 2.0


def state_problem(steps: int = 64, maxA=(0.7, 0.7), seed: int = 0):
    """2-level sigma_x/sigma_y state-transfer problem (the pi-pulse shape)."""
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        [np.array([0, 1], dtype=complex)], 2.0, steps,
        [np.array([1, 0], dtype=complex)],
        state_transfer=True, maxA=list(maxA), seed=seed,
    )


def unitary_problem(steps: int = 24, seed: int = 1):
    """2-level unitary problem with a real squaring branch (scaling=2)."""
    return ControlProblem.build(
        np.zeros((2, 2), dtype=complex), [q.SIGMA_X, q.SIGMA_Y], ["x", "y"],
        q.SIGMA_X, 2.0, steps, [0, 1],
        maxA=[1.0, 1.0], seed=seed, Taylor_terms=[6, 2],
    )


def on(device, x) -> torch.Tensor:
    """A numpy array as a contiguous float32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(
        device)
