"""The readings that set a cell's limits (``limits/<cell>.json``): for
each seed, the program's numbers (the lower readings) and the control's
(the upper ones), read in one process.

    python benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

For each seed the cell's traffic generator runs the set-up's check call
and a window of ``--seconds`` (none with 0), as a run does.  Then the
comparison is made with the program's readings, also at their widest
(every seed and every pulse entry counted), and with readings that stand
in for the program's:

* ``control``: the reference computed in TF32, the nearest precision
  below the float32 with TF32 off that the port computes in (the check's
  readings, and the loss of the window's answers);
* ``unchanged``: a state that never moves (the check's pulses left at
  their start, the loss at the start);
* ``no_decay`` and ``no_freeze``: the reference in float64 with the
  learning rate's decay or the freezing at the loss target left out,
  faults inside a segment that the check has to catch.

One JSON line a seed.  The benchmark's own runs do not run this.  A cell
on more than one card runs one rank a card, as ``run.py`` does
(``benchmark/ranks.py``): every rank makes the program's calls, rank 0
alone the reference's and the lines.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check as chk  # noqa: E402
from benchmark import harness, ranks  # noqa: E402
from benchmark.reference import grape as ref  # noqa: E402


def readings(cell, seed: int, seconds: float, device, rk=None) -> dict:
    gen = cell.generator(device, seed, rk)
    swept = getattr(gen, "extra", None) is not None
    gen.prepare()
    answers = None
    if seconds > 0:
        gen.window(seconds)
        answers = gen.sampled_answers()
    prog = gen.check
    del gen
    if rk is not None and not rk.lead:
        return None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    prob = ref.problem_from_system(cell.system, swept)
    r = chk.follow(prob, prog, device=device)

    def numbers(readings, **kw):
        return chk.check_numbers(prob, readings, device=device, r=r, **kw)

    out = {"seed": seed, "program": numbers(prog),
           "program_widest": numbers(prog, loss_quantile=1.0, roundoff=0.0),
           "program_all_seeds": numbers(prog, loss_quantile=1.0)}
    out["control"] = numbers(chk.reference_readings(prob, prog, ref.TF32,
                                                    device=device))
    out["no_decay"] = numbers(chk.reference_readings(
        prob, prog, device=device, learning_rate_decay=1e300))
    out["no_freeze"] = numbers(chk.reference_readings(
        prob, prog, device=device, conv_target=-1.0))
    out["unchanged"] = numbers(dict(
        prog, u=prog["u0"], loss=r["losses"][:, 0].double().cpu().numpy(),
        reg_loss=r["reg_losses"][:, 0].double().cpu().numpy()))
    losses = r["losses"].double().cpu().numpy()
    out["reference_losses"] = {
        f"j{j}": np.quantile(losses[:, j], [0, 0.25, 0.5, 0.75, 1]).tolist()
        for j in range(losses.shape[1])}
    if answers is not None:
        out["program"]["answer_gap"] = chk.answer_gap(prob, answers,
                                                      device=device)
        a32 = dict(answers)
        u = torch.as_tensor(np.asarray(answers["u"], np.float64),
                            device=device)
        w = answers.get("extra_w")
        w = None if w is None else torch.as_tensor(
            np.asarray(w, np.float64), device=device)
        loss, reg, _ = ref.loss_and_grad_blocked(prob, u, w, ref.TF32,
                                                 want_grad=False)
        a32["losses"] = loss.double().cpu().numpy()
        a32["reg_losses"] = reg.double().cpu().numpy()
        out["control"]["answer_gap"] = chk.answer_gap(prob, a32,
                                                      device=device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    got = ranks.launch(args.workload, str(Path(__file__).resolve()), argv,
                       device.type, time.perf_counter())
    cell = harness.load_cell(args.workload)
    if got is not None:
        device = ranks.device_of(got)
    rk = ranks.start(device)
    for s in args.seeds.split(","):
        out = readings(cell, int(s), args.seconds, device, rk)
        if rk.lead:
            print(json.dumps(out), flush=True)
    rk.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
