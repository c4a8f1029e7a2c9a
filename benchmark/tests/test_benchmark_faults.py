"""Whole runs on the CPU with the timed path broken underneath: each fault
a cell can have makes ``correct`` come out false, and the unbroken run
is correct.  The faults: a step that returns its state unchanged; half
of the batch left out (the seeds of a batch, or the concerned vectors of
a gate's fidelity, the mean taken over the rest); an answer altered
where it is produced; and two faults inside a segment, the learning
rate's decay left out and the freezing at the loss target left out.
(The cells take one card: there is no exchange between cards to leave
out.)"""

import pytest

from copies import make_copy, run_copy

STILL_SINGLE = """
import qoc_tpu_torch.optim.adam as A
_step = A._adam_step
def _still(s, g, factor):
    d = _step(s, g, factor)
    d["u_base"] = s.u_base
    return d
A._adam_step = _still
"""
STILL_BATCH = """
import qoc_tpu_torch.parallel.batch as B
_update = B.batched_adam_update
B.batched_adam_update = lambda u, st, g, frozen, f: (
    u, _update(u, st, g, frozen, f)[1])
"""
HALF_SINGLE = """
import qoc_tpu_torch.models.forward as F
_ip = F.inner_product_2d
F.inner_product_2d = lambda a, b, n: _ip(a[:, : a.shape[1] // 2],
                                         b[:, : b.shape[1] // 2], n)
"""
HALF_BATCH = """
import torch
import qoc_tpu_torch.parallel.batch as B
_update = B.batched_adam_update
def _half(u, st, g, frozen, f):
    frozen = frozen.clone()
    frozen[u.shape[0] // 2:] = True
    return _update(u, st, g, frozen, f)
B.batched_adam_update = _half
"""
ALTER_SINGLE = """
import qoc_tpu_torch as q
_grape = q.Grape
def _altered(*a, **k):
    res = _grape(*a, **k)
    if k["convergence"]["max_iterations"] > 3:
        res.u_base = res.u_base.copy()
        res.u_base[0, res.u_base.shape[1] // 2] += 0.05
    return res
q.Grape = _altered
"""
ALTER_BATCH = """
import qoc_tpu_torch.parallel.batch as B
_batched = B.batched_grape_adam
def _altered(*a, **k):
    out = _batched(*a, **k)
    if k["convergence"]["max_iterations"] > 3:
        out["u_base"] = out["u_base"].copy()
        out["u_base"][:, 0, out["u_base"].shape[2] // 2] += 0.05
    return out
B.batched_grape_adam = _altered
"""
NO_DECAY = """
import qoc_tpu_torch.optim.adam as A
import qoc_tpu_torch.parallel.batch as B
A.decay_factor = B.decay_factor = lambda conv: 1.0
"""
NO_FREEZE = """
import qoc_tpu_torch.optim.convergence as C
_from_dict = C.ConvergenceSettings.from_dict
C.ConvergenceSettings.from_dict = staticmethod(
    lambda d: _from_dict(dict(d or {}, conv_target=-1.0)))
"""

FAULTS = {
    ("small.single", "sound"): "",
    ("small.single", "unchanged"): STILL_SINGLE,
    ("small.single", "half"): HALF_SINGLE,
    ("small.single", "answer"): ALTER_SINGLE,
    ("small.single", "no_decay"): NO_DECAY,
    ("small.single", "no_freeze"): NO_FREEZE,
    ("small.restarts", "sound"): "",
    ("small.restarts", "unchanged"): STILL_BATCH,
    ("small.restarts", "half"): HALF_BATCH,
    ("small.restarts", "answer"): ALTER_BATCH,
    ("small.restarts", "no_decay"): NO_DECAY,
    ("small.restarts", "no_freeze"): NO_FREEZE,
}


@pytest.fixture(scope="module")
def copy_root(tmp_path_factory):
    return make_copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell,fault", sorted(FAULTS),
                         ids=[f"{c}-{f}" for c, f in sorted(FAULTS)])
def test_a_broken_timed_path_is_not_correct(copy_root, cell, fault):
    rc, out, err = run_copy(copy_root, cell, seconds=6.0,
                            patch=FAULTS[(cell, fault)])
    assert rc == 0, err[-3000:]
    assert "answer_gap" in out["checks"], err[-3000:]
    assert out["correct"] is (fault == "sound"), out["checks"]
