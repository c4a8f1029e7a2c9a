"""What the port's example scripts (examples/torch_0[1-4]_*.py) share:
one ``qoc_tpu_torch.Grape`` run, timed, with the kernels it launched, the
JSON line each script prints last, and the command line
(``--device``, ``--max-iterations``).

The JSON line: the example's name, iterations, 1 - loss and the float64
readout of the fidelity (``GrapeResult.fidelity_f64``), the run's wall
seconds, its route (the engine ``Grape`` announced, and the launches of
each kernel during the run, ``ops._cuda.LAUNCHES``) and the card's name
and power limit as nvidia-smi gives them ("cpu" off the card).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import qoc_tpu_torch as q
from qoc_tpu_torch.interop import entry_device
from qoc_tpu_torch.ops import _cuda
from qoc_tpu_torch.utils.profiling import card


def grape(name: str, device, max_iterations, *args, **kwargs):
    """``qoc_tpu_torch.Grape(*args, **kwargs)`` on ``device`` (None: the
    card, and a RuntimeError without one), its budget cut to
    ``max_iterations`` when given.  Returns (result, the JSON line's
    dict)."""
    device = entry_device(device)
    if max_iterations is not None:
        kwargs["convergence"] = dict(kwargs["convergence"],
                                     max_iterations=int(max_iterations))
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    res = q.Grape(*args, device=device, **kwargs)
    wall = time.perf_counter() - t0
    launches = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                if v != before[k]}
    return res, {"example": name, "iterations": int(res.iterations),
                 "one_minus_loss": 1.0 - float(res.loss),
                 "fidelity_f64": res.fidelity_f64, "wall_s": wall,
                 "engine": res.engine, "launches": launches,
                 "card": card(device)}


def report(summary: dict) -> None:
    print(json.dumps(summary), flush=True)


def cli(main, doc: str, argv=None) -> int:
    """Parse ``--device`` and ``--max-iterations`` and run ``main``; exit
    2, having run nothing, when no device is given and torch sees no
    card."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the plain torch versions)")
    ap.add_argument("--max-iterations", type=int, default=None,
                    help="cut the iteration budget (default: the one of "
                         "the qoc_tpu example)")
    args = ap.parse_args(argv)
    try:
        device = entry_device(args.device)
    except RuntimeError as e:
        print(f"{ap.prog}: {e}", file=sys.stderr)
        return 2
    main(device=device, max_iterations=args.max_iterations)
    return 0
