"""The port's on-card lane (tests_gpu/) against qoc_tpu's (tests_tpu/):
every test of tests_tpu has its counterpart, named alike (``_on_tpu`` /
``_on_mxu`` become ``_on_gpu``) and holding the same tolerances; the lane
passes on the CPU through the plain versions under
``QOC_TPU_TORCH_TEST_DEVICE=cpu``, and without that switch and without a
card every test skips.  The files are read with ``ast``: tests_tpu
imports jax and is never imported here."""

import ast
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU, GPU = os.path.join(REPO, "tests_tpu"), os.path.join(REPO, "tests_gpu")
TPU_FILES = ("test_kernels_on_tpu.py", "test_mega_on_tpu.py",
             "test_grape_on_tpu.py")
N_TESTS = 16
# lane tests with no tests_tpu counterpart (qoc_tpu records no spans and
# reads its float64 fidelity on the host only); each skips off the card,
# the CPU switch included
CARD_ONLY = {("test_spans_on_gpu.py",
              "test_launch_spans_share_the_card_clock_on_gpu"),
             ("test_fidelity_f64_on_gpu.py",
              "test_fidelity_readout_matches_the_host_loop_on_gpu"),
             ("test_fidelity_f64_on_gpu.py",
              "test_grape_reads_its_fidelity_on_the_card_on_gpu"),
             ("test_pscan_on_gpu.py",
              "test_grape_config4_routes_every_sweep_to_the_kernels"),
             ("test_pscan_on_gpu.py",
              "test_the_launch_takes_every_shape_the_ladder_sends")}
# the cases pytest counts for them (the readout's test has two)
CARD_ONLY_CASES = 6
# lane tests with no tests_tpu counterpart that the CPU switch runs too:
# the pscan sweep kernels against float64 loops (qoc_tpu runs those sweeps
# as lax.scan, with no kernel of its own)
LANE_ONLY = {("test_pscan_on_gpu.py", name) for name in (
    "test_sweeps_hold_the_float32_floor", "test_a_vmapped_batch_is_one_launch",
    "test_vmapped_gradient_through_pscan_chain")}
# the cases pytest counts for them (the first has ten shapes)
LANE_ONLY_CASES = 12
# seconds for the lane on the CPU; a run that takes longer fails
LANE_TIMEOUT = 90


def _gpu_name(name: str) -> str:
    return re.sub(r"_on_(tpu|mxu)$", "_on_gpu", name)


def _tests(path: str) -> dict:
    """test name -> its function's AST, for each top-level test."""
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")}


def _tolerances(fn) -> list:
    """The numbers a test compares against: every atol=/rtol= constant and
    every constant on the right of a ``<``, sorted."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.keyword) and node.arg in ("atol", "rtol"):
            out.append(ast.literal_eval(node.value))
        elif isinstance(node, ast.Compare):
            for op, right in zip(node.ops, node.comparators):
                if isinstance(op, ast.Lt) and isinstance(right, ast.Constant):
                    out.append(right.value)
    return sorted(out)


PAIRS = [(tpu_file, name)
         for tpu_file in TPU_FILES
         for name in _tests(os.path.join(TPU, tpu_file))]


def test_every_tpu_test_has_a_gpu_counterpart():
    assert len(PAIRS) == N_TESTS
    want = {(f.replace("_on_tpu", "_on_gpu"), _gpu_name(n))
            for f, n in PAIRS}
    got = {(f, n) for f in os.listdir(GPU) if f.startswith("test_")
           for n in _tests(os.path.join(GPU, f))}
    assert got == want | CARD_ONLY | LANE_ONLY


def test_chip_smoke_counts_every_lane_test():
    """chip_smoke.py's group 13b runs the lane on the card and wants
    exactly LANE_TESTS cases: the counterparts, the card-only tests and
    the other lane-only tests."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    lane_tests, = [ast.literal_eval(n.value) for n in tree.body
                   if isinstance(n, ast.Assign)
                   and [t.id for t in n.targets] == ["LANE_TESTS"]]
    assert lane_tests == N_TESTS + CARD_ONLY_CASES + LANE_ONLY_CASES


@pytest.mark.parametrize("tpu_file,name", PAIRS,
                         ids=[n for _, n in PAIRS])
def test_counterpart_keeps_the_tolerances(tpu_file, name):
    tpu = _tests(os.path.join(TPU, tpu_file))[name]
    gpu = _tests(os.path.join(GPU, tpu_file.replace("_on_tpu", "_on_gpu"))
                 )[_gpu_name(name)]
    assert _tolerances(gpu) == _tolerances(tpu)


def _lane(**env):
    """``pytest tests_gpu`` in a process of its own, with ``env`` over
    this one's environment (the lane's CPU switch only where given)."""
    base = {k: v for k, v in os.environ.items()
            if k != "QOC_TPU_TORCH_TEST_DEVICE"}
    return subprocess.run(
        [sys.executable, "-m", "pytest", "tests_gpu", "-q",
         "-p", "no:cacheprovider", "-p", "no:randomly", "-rs"],
        cwd=REPO, capture_output=True, text=True, timeout=LANE_TIMEOUT,
        env=dict(base, OMP_NUM_THREADS="1", **env))


def test_lane_passes_on_the_cpu():
    out = _lane(QOC_TPU_TORCH_TEST_DEVICE="cpu")
    assert out.returncode == 0, out.stdout + out.stderr
    assert f"{N_TESTS + LANE_ONLY_CASES} passed" in out.stdout, out.stdout
    assert f"{CARD_ONLY_CASES} skipped" in out.stdout, out.stdout


def test_lane_skips_without_a_card():
    out = _lane(CUDA_VISIBLE_DEVICES="")
    assert out.returncode == 0, out.stdout + out.stderr
    assert (f"{N_TESTS + CARD_ONLY_CASES + LANE_ONLY_CASES} skipped"
            in out.stdout), out.stdout
    assert "needs an NVIDIA card" in out.stdout, out.stdout
