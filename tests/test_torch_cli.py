"""The port's command line (``python -m qoc_tpu_torch run | verify |
plot``) on the CPU: run -> verify -> plot on a file the port wrote, which
both packages' verifiers accept; the same run as qoc_tpu's CLI; the job
decoder under qoc_tpu's name; no jax on import; no run without a card
unless ``--device`` names one."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from qoc_tpu import cli as qoc_cli
from qoc_tpu_torch import cli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_pi_pulse_config(tmp_path, name="job.json"):
    """tests/test_cli.py's job: the pi pulse, T = 60, saving."""
    cfg = {
        "H0": [[0.0, 0.0], [0.0, 0.0]],
        "Hops": [
            {"real": [[0, 1], [1, 0]]},
            {"real": [[0, 0], [0, 0]], "imag": [[0, -1], [1, 0]]},
        ],
        "Hnames": ["x", "y"],
        "U": [{"real": [0, 1]}],
        "total_time": 10.0,
        "steps": 60,
        "states_concerned_list": [{"real": [1, 0]}],
        "state_transfer": True,
        "maxA": [0.7, 0.7],
        "method": "Adam",
        "convergence": {"rate": 0.02, "update_step": 50,
                        "max_iterations": 300, "conv_target": 1e-4},
        "file_name": "cli_run",
        "save": True,
    }
    p = tmp_path / name
    p.write_text(json.dumps(cfg))
    return str(p)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_run_verify_plot(tmp_path, capsys):
    """run -> verify -> plot through the port (loss < 1e-3, both packages'
    verify_run at atol 1e-3 accept the port's file, a png > 5000 bytes)."""
    from qoc_tpu.utils.verification import verify_run as qoc_verify
    from qoc_tpu_torch.utils.verification import verify_run

    cfg_path = write_pi_pulse_config(tmp_path)
    rc = cli.main(["run", cfg_path, "--data-path", str(tmp_path), "--seed",
                   "0", "--device", "cpu"])
    assert rc == 0
    result = _last_json(capsys)
    assert result["loss"] < 1e-3
    run_file = result["file_path"]
    assert os.path.exists(run_file)

    assert cli.main(["verify", run_file, "--atol", "1e-3"]) == 0
    assert all(_last_json(capsys)["all_close"])
    assert all(verify_run(run_file, atol=1e-3)["all_close"])
    assert all(qoc_verify(run_file, atol=1e-3)["all_close"])

    png = str(tmp_path / "dash.png")
    assert cli.main(["plot", run_file, "--out", png]) == 0
    assert os.path.getsize(png) > 5000


def test_run_file_name_defaults_to_the_job_stem(tmp_path, capsys,
                                                 monkeypatch):
    """Without a file_name the run is named after the job file, and without
    --data-path it lands in the working directory (qoc_tpu/cli.py:94-100);
    a job with "save": false writes nothing."""
    cfg = json.loads(open(write_pi_pulse_config(tmp_path)).read())
    del cfg["file_name"]
    cfg["convergence"]["max_iterations"] = 5
    job = tmp_path / "spec_stem.json"
    job.write_text(json.dumps(cfg))
    monkeypatch.chdir(tmp_path)
    assert cli.main(["run", str(job), "--device", "cpu"]) == 0
    assert _last_json(capsys)["file_path"] == os.path.join(
        ".", "00000_spec_stem.h5")
    assert os.path.exists(tmp_path / "00000_spec_stem.h5")

    cfg["save"] = False
    job.write_text(json.dumps(cfg))
    assert cli.main(["run", str(job), "--device", "cpu"]) == 0
    assert _last_json(capsys)["file_path"] is None
    assert not os.path.exists(tmp_path / "00001_spec_stem.h5")


def test_run_matches_qoc_tpu_cli(tmp_path, capsys):
    """The same job through both CLIs on the segment engine ("engine":
    "mega": qoc_tpu's interpreted Pallas kernel, the port's plain segment
    on the CPU, kernel 3 on the card): the same iteration count, the loss
    within 1e-5.  On the scan engine the two cross conv_target one
    iteration apart: at iteration 62 the float32 loss is 1.0014e-4 in
    qoc_tpu and 9.984e-5 in the port."""
    cfg_path = write_pi_pulse_config(tmp_path)
    cfg = json.loads(open(cfg_path).read())
    cfg["engine"] = "mega"
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    assert qoc_cli.main(["run", cfg_path, "--data-path",
                         str(tmp_path / "qoc"), "--seed", "0"]) == 0
    want = _last_json(capsys)
    assert cli.main(["run", cfg_path, "--data-path", str(tmp_path / "port"),
                     "--seed", "0", "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got["iterations"] == want["iterations"]
    assert abs(got["loss"] - want["loss"]) <= 1e-5
    assert abs(got["reg_loss"] - want["reg_loss"]) <= 1e-5


def test_load_config_npz(tmp_path):
    """tests/test_cli.py::test_load_config_npz on the port's load_config,
    which is utils.jobs.load_job."""
    from qoc_tpu_torch.utils.jobs import load_job

    assert cli.load_config is load_job
    np.savez(tmp_path / "mats.npz", H0=np.diag([0.0, 1.0]).astype(complex))
    cfg = {"H0": {"npz": "mats.npz", "key": "H0"}, "Hops": [],
           "state_transfer": False}
    p = tmp_path / "c.json"
    p.write_text(json.dumps(cfg))
    loaded = cli.load_config(str(p))
    assert np.allclose(loaded["H0"], np.diag([0.0, 1.0]))
    np.testing.assert_array_equal(loaded["H0"],
                                  qoc_cli.load_config(str(p))["H0"])


def test_entry_points_import_no_jax():
    """``python -m qoc_tpu_torch --help``, the CLI, the new utilities and
    examples/torch_05_pod_scale_sweep.py import neither jax nor qoc_tpu
    (nor h5py or matplotlib, which only a saving run, verify and plot
    need)."""
    code = (
        "import importlib.util, runpy, sys\n"
        "import qoc_tpu_torch.cli, qoc_tpu_torch.utils.verification\n"
        "import qoc_tpu_torch.utils.plotting, qoc_tpu_torch.utils.profiling\n"
        "import qoc_tpu_torch.utils.qutip_shim\n"
        "spec = importlib.util.spec_from_file_location('ex05', "
        "'examples/torch_05_pod_scale_sweep.py')\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "sys.argv = ['qoc_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('qoc_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in ('jax', 'optax', 'qoc_tpu', 'h5py', 'matplotlib')"
        " if m in sys.modules]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "{run,verify,plot}" in out.stdout


def test_run_needs_the_card_without_device(tmp_path, capsys, monkeypatch):
    """No --device and no CUDA: run exits non-zero with entry_device's
    message, prints no result and writes no file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = write_pi_pulse_config(tmp_path)
    rc = cli.main(["run", cfg_path, "--data-path", str(tmp_path)])
    out = capsys.readouterr()
    assert rc != 0
    assert "torch sees no CUDA device" in out.err
    assert out.out == ""
    assert not any(f.suffix == ".h5" for f in tmp_path.iterdir())
