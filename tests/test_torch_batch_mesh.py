"""``mesh=`` through the port's batch layer on two gloo ranks, on the CPU:
``make_batched_runner(mesh=...)`` on the "xla", "xla-cols", "pallas" and
"mega" backends (their plain versions) against qoc_tpu's
``make_batched_runner(mesh=...)`` on two of the conftest's eight virtual
CPU devices from the same pulses; ``batched_grape_adam(mesh=...)``
against the port's one-process run of the same seed, with one collective
per segment; and ``make_mega_batched_runner(mesh=...)`` against its
unsharded run.

The ranks are worker processes that import only ``qoc_tpu_torch`` (the
``WORKER`` below, with the functions that build the problems shared by
source, started by tests/test_torch_distributed.py's ``run_ranks``);
they run once per module and exchange arrays with this process as
``.npy`` files.  Inputs are made with numpy from a seed."""

import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import qoc_tpu as q
import qoc_tpu.parallel.batch as jbatch
import qoc_tpu_torch as qt
from qoc_tpu.optim.convergence import ConvergenceSettings as JConv
from qoc_tpu.parallel.mesh import batch_sharding
from qoc_tpu_torch.optim.convergence import ConvergenceSettings as TConv
from qoc_tpu_torch.parallel.batch import batched_grape_adam
from qoc_tpu_torch.parallel.mega_batch import make_mega_batched_runner
from test_torch_distributed import RANKS, run_ranks

torch.set_num_threads(1)

# make_batched_runner: tests/test_torch_batch.py's settings, 4 seeds
N_ITERS = 20
CONV = {"rate": 0.05, "update_step": 10, "max_iterations": 100,
        "conv_target": 1e-12}
SEEDS = 4
# batched_grape_adam on the "pi20" problem: seed 3's 8 seeds freeze at
# iterations 50, 48, 59, 60 (rank 0) and 45, 66, 12, 50 (rank 1)
GA_SEEDS = 8
GA_CONV = {"rate": 0.05, "update_step": 25, "max_iterations": 300,
           "conv_target": 1e-4}
GA_BACKENDS = ("xla", "mega")
# make_mega_batched_runner: a detuning sweep
SWEEP_ITERS = 30


def pi_args(m, steps=16):
    """The pi pulse of tests/test_torch_batch.py, in package ``m``."""
    return ((np.zeros((2, 2), dtype=complex), [m.SIGMA_X, m.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 2.0, steps,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.7, 0.7], seed=0))


def leakage_args(m, levels=3, steps=12):
    a = m.annihilate(levels)
    return ((np.diag(np.arange(levels) * 1.0) * 2 * np.pi
             - 2 * np.pi * 0.05 * np.diag(np.arange(levels) ** 2 * 1.0),
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             [np.eye(levels)[1].astype(complex)], 2.0, steps,
             [np.eye(levels)[0].astype(complex)]),
            dict(state_transfer=True, maxA=[0.5, 0.5], seed=0))


def gate_args(m):
    a = m.annihilate(3)
    return ((np.diag([0.0, 1.0, 1.95]) * 2 * np.pi,
             [a + a.conj().T, 1j * (a - a.conj().T)], ["x", "y"],
             m.transmon_gate(m.SIGMA_X, 3), 3.0, 12, [0, 1]),
            dict(maxA=[0.6, 0.6], seed=0, Taylor_terms=[8, 2]))


def pi20_args(m):
    """tests/test_distributed.py's pi pulse (T = 20), whose seeds converge."""
    return ((np.zeros((2, 2), dtype=complex), [m.SIGMA_X, m.SIGMA_Y],
             ["x", "y"], [np.array([0, 1], dtype=complex)], 8.0, 20,
             [np.array([1, 0], dtype=complex)]),
            dict(state_transfer=True, maxA=[0.8, 0.8], seed=0))


def build(m, name):
    args, kw = {"pi": pi_args, "pi20": pi20_args, "leakage": leakage_args,
                "gate": gate_args}[name](m)
    return m.ControlProblem.build(*args, **kw)


# name: (problem, backend, reg_coeffs, mats_b kind) -- tests/test_torch_
# batch.py's RUNS
RUNS = {
    "xla": ("pi", "xla", {"amplitude": 0.1}, None),
    "xla_mats_batch_sweep": ("pi", "xla", None, "sweep"),
    "xla_cols": ("leakage", "xla-cols",
                 {"forbidden_coeff_list": [4.0], "states_forbidden_list": [2],
                  "amplitude": 0.05}, None),
    "xla_cols_unitary_v2": ("gate", "xla-cols", {"speed_up": 0.1}, None),
    "pallas": ("pi", "pallas", {"amplitude": 0.1, "dwdt": 0.01}, "extra"),
    "mega": ("pi", "mega", {"amplitude": 0.1, "dwdt": 0.01}, None),
}
FIELDS = ("u_base", "loss", "reg_loss", "grad_squared", "done")
RESULT_KEYS = ("losses", "reg_losses", "u_base", "uks", "best_uks",
               "converged")


def detuning_sweep(m, p, S):
    """Per-seed generator stacks [S, K+1, M, M]: drift detuned by delta_s."""
    out = []
    for delta in np.linspace(0.0, 0.4, S):
        mats = np.asarray(p.mats, dtype=np.float32).copy()
        mats[0] = m.c_to_r_mat(-1j * p.dt * np.diag([0.0, delta]))
        out.append(mats)
    return np.stack(out).astype(np.float32)


def extra_channel(m, p, S):
    extra = np.stack([m.c_to_r_mat(-1j * p.dt * np.diag([0.0, 1.0]))])
    return (extra.astype(np.float32),
            np.linspace(-0.3, 0.3, S)[:, None].astype(np.float32))


WORKER = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, out = int(sys.argv[1]), sys.argv[2]
    import qoc_tpu_torch as qt
    from qoc_tpu_torch.optim.convergence import ConvergenceSettings
    from qoc_tpu_torch.parallel import mesh as tmesh
    from qoc_tpu_torch.parallel.batch import (
        batched_grape_adam, make_batched_runner)
    from qoc_tpu_torch.parallel.mega_batch import make_mega_batched_runner

    def save(name, x):
        np.save(os.path.join(out, f"{name}.r{rank}.npy"), np.asarray(x))

    def load(name):
        return np.load(os.path.join(out, name + ".npy"))

    tmesh.init_distributed(
        backend="gloo", world_size=RANKS, rank=rank,
        init_method="file://" + os.path.join(out, "rendezvous"))
    mesh = tmesh.make_mesh()

    for name, (prob, backend, rc, kind) in RUNS.items():
        p = build(qt, prob)
        extra = mats_b = None
        if kind == "sweep":
            mats_b = detuning_sweep(qt, p, SEEDS)
        elif kind == "extra":
            extra, mats_b = extra_channel(qt, p, SEEDS)
        init, run = make_batched_runner(
            p, ConvergenceSettings.from_dict(CONV), reg_coeffs=rc,
            sweep_mats=kind == "sweep", backend=backend,
            extra_channel_mats=extra, mesh=mesh, device="cpu")
        s = run(init(load(u0_name(prob))), N_ITERS,
                None if mats_b is None else torch.tensor(mats_b))
        save(name + ".local_seeds", [s.u_base.shape[0]])
        save(name + ".iteration", [s.iteration, s.all_done])
        for f in FIELDS:
            save(name + "." + f, tmesh.gather(getattr(s, f), mesh))

    # one all_reduce per segment: count the collectives of the global loop
    calls = []
    all_reduce = dist.all_reduce

    def counted(*a, **k):
        calls.append(1)
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    for backend in GA_BACKENDS:
        seen = []
        calls.clear()
        res = batched_grape_adam(
            build(qt, "pi20"), GA_SEEDS, convergence=GA_CONV, seed=3,
            mesh=mesh, backend=backend, device="cpu",
            progress=lambda it, losses, done: seen.append(
                [it, losses.shape[0], done.shape[0]]))
        save(f"ga_{backend}.progress", seen)
        save(f"ga_{backend}.all_reduce_calls", [len(calls)])
        save(f"ga_{backend}.iterations", [res["iterations"],
                                          res["best_seed"]])
        for k in RESULT_KEYS:
            save(f"ga_{backend}.{k}", res[k])
    dist.all_reduce = all_reduce

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return ""

    p = build(qt, "pi")
    extra, deltas = extra_channel(qt, p, SEEDS)
    init_m, run_m, read_u = make_mega_batched_runner(
        p, ConvergenceSettings.from_dict(GA_CONV), extra_channel_mats=extra,
        mesh=mesh, device="cpu")
    st = run_m(init_m(load("u0")), SWEEP_ITERS, extra_weights=deltas)
    save("sweep.local_columns", [st.u_cols.shape[2]])
    save("sweep.u", read_u(st))
    save("sweep.losses", tmesh.gather(st.losses, mesh))
    save("errors", [
        error(lambda: init_m(load("u0")[:3])),
        error(lambda: batched_grape_adam(p, 3, mesh=mesh, device="cpu"))])
    save("no_jax", ["jax" not in sys.modules
                    and "qoc_tpu" not in sys.modules])
""")


def u0_name(prob):
    return "u0" if prob == "pi" else "u0_" + prob


def _u0(p, S, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, p.ops_len, p.steps))
            / np.sqrt(p.steps)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' results: ``ranks(name)`` -> [rank 0's, rank 1's]."""
    tmp = tmp_path_factory.mktemp("ranks")
    np.save(tmp / "u0.npy", _u0(build(q, "pi"), SEEDS))
    for prob in ("leakage", "gate"):
        np.save(tmp / f"u0_{prob}.npy", _u0(build(q, prob), SEEDS))
    run_ranks(tmp, WORKER,
              dict(RUNS=RUNS, CONV=CONV, N_ITERS=N_ITERS, SEEDS=SEEDS,
                   FIELDS=FIELDS, GA_SEEDS=GA_SEEDS, GA_CONV=GA_CONV,
                   GA_BACKENDS=GA_BACKENDS, RESULT_KEYS=RESULT_KEYS,
                   SWEEP_ITERS=SWEEP_ITERS),
              (pi_args, pi20_args, leakage_args, gate_args, build,
               detuning_sweep, extra_channel, u0_name))

    def read(name):
        return [np.load(tmp / f"{name}.r{r}.npy", allow_pickle=False)
                for r in range(RANKS)]

    read.dir = tmp
    return read


def test_workers_import_no_jax(ranks):
    assert all(bool(v[0]) for v in ranks("no_jax"))


@pytest.mark.parametrize("name", list(RUNS))
def test_sharded_runner_matches_qoc_tpu(ranks, name):
    """20 iterations from the same pulses on two ranks against qoc_tpu's
    runner with its operands sharded over two devices: u within 5e-5,
    losses and reg_losses within 2e-5, grad^2 within 2e-3 relative, the
    frozen flags equal (tests/test_torch_batch.py's bars for the unsharded
    runners); every rank holds 2 of the 4 seeds and the global iteration."""
    prob, backend, rc, kind = RUNS[name]
    jp = build(q, prob)
    mesh = Mesh(np.asarray(jax.devices()[:RANKS]), ("batch",))
    shard = batch_sharding(mesh)
    extra = mats_b = None
    if kind == "sweep":
        mats_b = detuning_sweep(q, jp, SEEDS)
    elif kind == "extra":
        extra, mats_b = extra_channel(q, jp, SEEDS)
    ji, jr = jbatch.make_batched_runner(
        jp, JConv.from_dict(CONV), reg_coeffs=rc, sweep_mats=kind == "sweep",
        backend=backend, extra_channel_mats=extra, mesh=mesh)
    u0 = np.load(ranks.dir / f"{u0_name(prob)}.npy")
    want = jr(ji(jax.device_put(jnp.asarray(u0), shard)),
              jnp.asarray(N_ITERS, dtype=jnp.int32),
              None if mats_b is None else jax.device_put(
                  jnp.asarray(mats_b), shard))
    assert int(want.iteration) == N_ITERS
    for r in range(RANKS):
        assert ranks(name + ".local_seeds")[r][0] == SEEDS // RANKS
        np.testing.assert_array_equal(ranks(name + ".iteration")[r],
                                      [N_ITERS, 0])
    tols = dict(u_base=dict(atol=5e-5), loss=dict(atol=2e-5),
                reg_loss=dict(atol=2e-5), grad_squared=dict(rtol=2e-3))
    for f in FIELDS:
        for got in ranks(f"{name}.{f}"):
            if f == "done":
                np.testing.assert_array_equal(got, np.asarray(want.done))
            else:
                np.testing.assert_allclose(
                    got, np.asarray(getattr(want, f)), **tols[f])


@pytest.fixture(scope="module")
def one_process():
    """The port's unsharded batched_grape_adam of the same seed, with its
    progress lines, per backend."""
    out = {}
    for backend in GA_BACKENDS:
        seen = []
        res = batched_grape_adam(
            build(qt, "pi20"), GA_SEEDS, convergence=GA_CONV, seed=3,
            backend=backend, device="cpu",
            progress=lambda it, losses, done: seen.append(
                [it, losses.shape[0], done.shape[0]]))
        out[backend] = (res, seen)
    return out


@pytest.mark.parametrize("backend", GA_BACKENDS)
def test_batched_grape_adam_on_two_ranks(ranks, one_process, backend):
    """Both ranks return the same global result dict, equal to one process
    running all 8 seeds: iterations, best seed and converged flags equal,
    losses and reg_losses within 1e-6, pulses within 1e-5.  The seeds
    freeze between iterations 12 and 66, rank 0's last at 60: on the
    "xla" backend that rank stops stepping six iterations before the
    other, and the result is still the one-process run's (66
    iterations)."""
    res, _ = one_process[backend]
    tag = f"ga_{backend}"
    for r in range(RANKS):
        np.testing.assert_array_equal(ranks(tag + ".iterations")[r],
                                      [res["iterations"], res["best_seed"]])
        for k in RESULT_KEYS:
            np.testing.assert_array_equal(ranks(f"{tag}.{k}")[r],
                                          ranks(f"{tag}.{k}")[0])
    np.testing.assert_array_equal(ranks(tag + ".converged")[0],
                                  res["converged"])
    assert res["converged"].all()
    assert res["iterations"] == {"xla": 66, "mega": 75}[backend]
    for k, tol in (("losses", 1e-6), ("reg_losses", 1e-6), ("u_base", 1e-5),
                   ("uks", 1e-5)):
        np.testing.assert_allclose(ranks(f"{tag}.{k}")[0], res[k], rtol=0,
                                   atol=tol)


@pytest.mark.parametrize("backend", GA_BACKENDS)
def test_one_collective_per_segment(ranks, one_process, backend):
    """The global all(done) and iteration cost one all_reduce per
    update_step segment (qoc_tpu's while_loop reduces every iteration);
    progress sees the same global arrays at the same iterations as the
    one-process run."""
    _, seen = one_process[backend]
    tag = f"ga_{backend}"
    for r in range(RANKS):
        np.testing.assert_array_equal(ranks(tag + ".progress")[r], seen)
        assert ranks(tag + ".all_reduce_calls")[r][0] == len(seen)
    assert [s[1] for s in seen] == [GA_SEEDS] * len(seen)
    assert len(seen) < ranks(tag + ".iterations")[0][0] / 10


def test_sharded_mega_runner_matches_one_process(ranks):
    """make_mega_batched_runner(mesh=...) on a detuning sweep: each rank
    runs its 2 seeds' columns; read_u gives the global pulses, equal to
    the unsharded run's within 1e-6, and the gathered losses within
    1e-6."""
    p = build(qt, "pi")
    extra, deltas = extra_channel(qt, p, SEEDS)
    init, run, read_u = make_mega_batched_runner(
        p, TConv.from_dict(GA_CONV), extra_channel_mats=extra, device="cpu")
    st = run(init(np.load(ranks.dir / "u0.npy")), SWEEP_ITERS,
             extra_weights=deltas)
    for r in range(RANKS):
        assert ranks("sweep.local_columns")[r][0] == SEEDS // RANKS
        np.testing.assert_allclose(ranks("sweep.u")[r], read_u(st), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(ranks("sweep.losses")[r],
                                   st.losses.numpy(), rtol=0, atol=1e-6)


def test_indivisible_seed_axis_raises(ranks):
    """qoc_tpu's check on the mega runner (the column count divides by the
    mesh size x V) and the mesh's on batched_grape_adam."""
    for mega_err, ga_err in ranks("errors"):
        assert mega_err == "column count 3 not divisible by mesh size 2 x V=1"
        assert "does not divide by the mesh size (2)" in ga_err
