"""The port's example scripts (examples/torch_0[1-4]_*.py) and its config-4
job generator (examples/jobs/torch_make_transmon_cavity.py) against
qoc_tpu's on the CPU: each example hands ``qoc_tpu_torch.Grape`` exactly
the arguments its original hands ``qoc_tpu.Grape`` (both recorded with
``Grape`` patched, not run); the generator writes the committed npz and
json byte for byte; example 01 at 100 iterations on ``--device cpu``
agrees with ``qoc_tpu.Grape`` on the same arguments at
tests/test_torch_grape.py's tolerances; without a card and without
``--device`` every example exits 2; and none of the new programs imports
jax or qoc_tpu."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import qoc_tpu
import qoc_tpu_torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
NAMES = ["01_qubit_pi_pulse", "02_cnot_gate", "03_transmon_leakage",
         "04_transmon_cavity"]


def _load(name, *path):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recorded:
    """What a patched ``Grape`` returns: unpacks as (uks, Uf) and carries
    the fields the example scripts read."""

    def __init__(self, args, kwargs):
        H0, Hops, steps = args[0], args[1], args[5]
        self.uks = np.zeros((len(Hops), steps))
        self.Uf = np.eye(len(H0), dtype=complex)
        self.iterations, self.loss, self.fidelity_f64 = 0, 1.0, 0.0
        self.engine = "recorded"

    def __iter__(self):
        return iter((self.uks, self.Uf))


def _record(monkeypatch, module):
    calls = []

    def grape(*args, **kwargs):
        calls.append((args, kwargs))
        return _Recorded(args, kwargs)

    monkeypatch.setattr(module, "Grape", grape)
    return calls


def _assert_same(a, b, where):
    """Equal bit for bit: arrays (dtype and values), dicts, sequences and
    scalars (type and value)."""
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        assert a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for k in b:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


@pytest.mark.parametrize("name", NAMES)
def test_example_passes_the_originals_arguments(name, monkeypatch, capsys):
    """The port's example hands ``qoc_tpu_torch.Grape`` the problem,
    reg_coeffs, convergence, maxA and seed (every argument) that the
    original hands ``qoc_tpu.Grape``, plus ``device``."""
    want = _record(monkeypatch, qoc_tpu)
    _load(f"ex_{name}", "examples", f"{name}.py").main()
    got = _record(monkeypatch, qoc_tpu_torch)
    summary = _load(f"torch_ex_{name}", "examples",
                    f"torch_{name}.py").main(device="cpu")
    assert len(want) == len(got) == 1
    (w_args, w_kw), (g_args, g_kw) = want[0], got[0]
    assert g_kw.pop("device") == torch.device("cpu")
    _assert_same(g_args, w_args, "args")
    _assert_same(g_kw, w_kw, "kwargs")
    # the original's lines, then the JSON line
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == summary
    assert summary["example"] == name and summary["card"] == "cpu"


def test_max_iterations_cuts_only_the_budget(monkeypatch):
    calls = _record(monkeypatch, qoc_tpu_torch)
    mod = _load("torch_ex_04", "examples", "torch_04_transmon_cavity.py")
    mod.main(device="cpu")
    mod.main(device="cpu", max_iterations=300)
    (_, full), (_, cut) = calls
    assert cut.pop("convergence") == dict(full.pop("convergence"),
                                          max_iterations=300)
    _assert_same(cut, full, "kwargs")


def test_generator_writes_the_committed_files(tmp_path):
    """examples/jobs/torch_make_transmon_cavity.py writes
    transmon_cavity.npz and .json equal byte for byte to the committed
    ones (the output of qoc_tpu's make_transmon_cavity.py), and its system
    is the original's."""
    gen = _load("torch_make_transmon_cavity", "examples", "jobs",
                "torch_make_transmon_cavity.py")
    orig = _load("make_transmon_cavity", "examples", "jobs",
                 "make_transmon_cavity.py")
    assert gen.main(["--out-dir", str(tmp_path)]) == 0
    for ext in ("npz", "json"):
        with open(tmp_path / f"transmon_cavity.{ext}", "rb") as f:
            got = f.read()
        with open(os.path.join(EXAMPLES, "jobs",
                               f"transmon_cavity.{ext}"), "rb") as f:
            assert got == f.read(), ext
    for k in ("QLEV", "CLEV", "DELTA_C", "ALPHA", "G", "MAXA", "TOTAL_TIME",
              "STEPS"):
        assert getattr(gen, k) == getattr(orig, k), k
    _assert_same(gen.build_system(), orig.build_system(), "system")


def test_generator_defaults_to_a_temporary_directory(capsys):
    gen = _load("torch_make_transmon_cavity", "examples", "jobs",
                "torch_make_transmon_cavity.py")
    assert gen.main([]) == 0
    written = [line.split()[1] for line in
               capsys.readouterr().out.splitlines()]
    assert len(written) == 2
    for path in written:
        assert os.path.dirname(path) != os.path.join(EXAMPLES, "jobs")
        os.remove(path)
    os.rmdir(os.path.dirname(written[0]))


def test_example_01_matches_qoc_tpu_on_the_cpu(monkeypatch, capsys):
    """Example 01 on ``--device cpu`` for 100 iterations against
    ``qoc_tpu.Grape`` on the same arguments (test_torch_grape.py's
    tolerances)."""
    mod = _load("torch_ex_01", "examples", "torch_01_qubit_pi_pulse.py")
    calls = []
    real = qoc_tpu_torch.Grape

    def spy(*args, **kwargs):
        calls.append((args, dict(kwargs)))
        out = real(*args, **kwargs)
        calls[-1] += (out,)
        return out

    monkeypatch.setattr(qoc_tpu_torch, "Grape", spy)
    assert mod.run.cli(mod.main, mod.__doc__,
                       ["--device", "cpu", "--max-iterations", "100"]) == 0
    (args, kwargs, got), = calls
    assert kwargs.pop("device") == torch.device("cpu")
    assert kwargs["convergence"]["max_iterations"] == 100
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = qoc_tpu.Grape(*args, **kwargs)
    assert summary["iterations"] == got.iterations == want.iterations
    np.testing.assert_allclose(got.loss, want.loss, atol=2e-5)
    np.testing.assert_allclose(got.uks, np.asarray(want.uks), atol=1e-4)
    np.testing.assert_allclose(got.fidelity_f64, want.fidelity_f64,
                               atol=2e-5)
    np.testing.assert_allclose(got.inter_vecs, np.asarray(want.inter_vecs),
                               atol=1e-4)


def test_examples_need_the_card():
    """Without a card (CUDA_VISIBLE_DEVICES empty) and without ``--device``
    each example exits 2 and prints no JSON line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, f"torch_{name}.py")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in NAMES]
    for name, p in zip(NAMES, procs):
        out, err = p.communicate(timeout=120)
        assert p.returncode == 2, (name, out, err)
        assert "{" not in out and "CUDA" in err, (name, out, err)


def test_new_programs_import_no_jax():
    """The examples, their helper, the generator, tests_gpu/ and
    tools/torch_scaling_evidence.py import with jax and qoc_tpu blocked
    (an import of either raises), and leave neither, nor optax or h5py,
    in sys.modules."""
    code = (
        "import importlib.abc, importlib.util, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'qoc_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "sys.path[:0] = ['examples', 'examples/jobs', 'tests_gpu']\n"
        "paths = sys.argv[1:]\n"
        "for i, path in enumerate(paths):\n"
        "    spec = importlib.util.spec_from_file_location(f'm{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in ('jax', 'optax', 'h5py', 'qoc_tpu')\n"
        "       if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    paths = ([f"examples/torch_{n}.py" for n in NAMES]
             + ["examples/torch_example_run.py",
                "examples/jobs/torch_make_transmon_cavity.py",
                "tools/torch_scaling_evidence.py"]
             + sorted(f"tests_gpu/{f}" for f in
                      os.listdir(os.path.join(REPO, "tests_gpu"))
                      if f.endswith(".py")))
    out = subprocess.run([sys.executable, "-c", code, *paths], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
