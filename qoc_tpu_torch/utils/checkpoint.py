"""True checkpoint and resume of the Adam state (port of
``qoc_tpu.utils.checkpoint``).

The reference's ``tf.train.Saver`` never saved; qoc_tpu keeps the whole
optimizer state (pulse, Adam moments, decayed learning rate, iteration) in
the run file, so a killed run continues where it stopped.  The port
writes the same datasets: ``ckpt_iteration``, ``ckpt_num_leaves`` and
``ckpt_leaf_%d``, the leaves of qoc_tpu's (u_base, opt_state) pytree for
its Adam chain (qoc_tpu/optim/adam.py:66-74) in optax's order: ``u``
[K, T], ``count`` (int32), ``mu``, ``nu`` [K, T] and ``lr`` (float32).  A
run saved by either package resumes in the other.

Two parts: pure functions between a port ``AdamState`` and that list of
numpy leaves (``checkpoint_leaves``, ``state_from_leaves``), and the h5
I/O on top of them.  h5py is imported only by the I/O.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..interop import adam_state_from_numpy, adam_state_to_numpy
from ..optim.adam import AdamState

LEAVES = ("u", "count", "mu", "nu", "lr")


def checkpoint_leaves(state: AdamState, steps: int) -> List[np.ndarray]:
    """The optax leaves of ``state``, trimmed to ``steps`` lanes (the
    segment kernel's state is padded to Tp)."""
    u, mu, nu, count, lr = adam_state_to_numpy(state, steps)
    return [u, np.asarray(count, dtype=np.int32), mu, nu,
            np.asarray(lr, dtype=np.float32)]


def state_from_leaves(leaves, iteration: int, steps: int, Tp: int,
                      device="cpu") -> AdamState:
    """An AdamState on ``device`` from the optax leaves, padded to ``Tp``
    lanes (``steps`` for the per-iteration runner, the segment kernel's
    lane count for it)."""
    if len(leaves) != len(LEAVES):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves but the Adam state has "
            f"{len(LEAVES)} ({', '.join(LEAVES)}): optimizer mismatch")
    u, count, mu, nu, lr = leaves
    for name, x in (("u", u), ("mu", mu), ("nu", nu)):
        if np.shape(x) != np.shape(u) or np.shape(x)[1] != steps:
            raise ValueError(f"checkpoint leaf {name} has shape "
                             f"{np.shape(x)}, expected [K, {steps}]")
    state = adam_state_from_numpy(u, mu, nu, count, lr, steps, Tp, device)
    return state._replace(iteration=int(iteration))


def save_checkpoint(file_path: str, leaves, iteration: int) -> None:
    """Overwrite the checkpoint datasets in a run file."""
    from .h5 import H5File

    with H5File(file_path, "a") as hf:
        hf.add("ckpt_iteration", int(iteration))
        hf.add("ckpt_num_leaves", len(leaves))
        for i, leaf in enumerate(leaves):
            hf.add("ckpt_leaf_%d" % i, np.asarray(leaf))


def load_checkpoint(file_path: str) -> Tuple[List[np.ndarray], int]:
    """(leaves, iteration) of a run file's checkpoint."""
    from .h5 import require_h5py

    require_h5py()
    import h5py

    with h5py.File(file_path, "r") as hf:
        if "ckpt_iteration" not in hf:
            raise ValueError(f"{file_path} contains no checkpoint")
        n = int(np.array(hf["ckpt_num_leaves"]))
        leaves = [np.array(hf["ckpt_leaf_%d" % i]) for i in range(n)]
        iteration = int(np.array(hf["ckpt_iteration"]))
    return leaves, iteration


def has_checkpoint(file_path: str) -> bool:
    from .h5 import require_h5py

    require_h5py()
    import h5py

    try:
        with h5py.File(file_path, "r") as hf:
            return "ckpt_iteration" in hf
    except (OSError, IOError):
        return False
