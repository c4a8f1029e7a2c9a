"""One rank a card for a cell whose ``chips`` is above 1.

The process the command starts is the launcher.  Before its own imports
(``launch``, the standard library only) it replaces itself with
PyTorch's launcher, ``python -m torch.distributed.run --standalone
--nproc-per-node <chips>``, which runs the same script with the same
arguments once a card, tells each rank its rank and the rendezvous in
the environment (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``), and, as soon as one rank exits with
another code than 0, ends the others and exits with another code than 0
itself.  Each rank learns from ``RANKS_ENV`` the launcher's start and
the kind of device (``told``), joins the process group through the
port's ``parallel/mesh.py`` (``init_distributed``: NCCL on the cards,
gloo on the CPU, with a timeout of ``TIMEOUT_S``, so that no collective
waits for ever) and builds the seed axis' mesh (``make_mesh``).  Ranks
other than 0 write their standard output to standard error, so that
rank 0's result stays the last line of the standard output.

A cell on one card makes a ``Ranks`` of one, whose collectives return
their input: its run is the same as before ranks existed.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
from pathlib import Path

RANKS_ENV = "QOC_BENCH_RANKS"
TIMEOUT_S = 180          # the longest a rank waits for the others
BENCH = Path(__file__).resolve().parent.parent / "BENCHMARK.json"


def chips_of(workload: str) -> int:
    """The cards the cell ``workload`` asks for (1 for an unknown cell,
    which the harness refuses later)."""
    for w in json.loads(BENCH.read_text())["workloads"]:
        if w["name"] == workload:
            return int(w["chips"])
    return 1


def launch(workload: str, script: str, argv: list, device: str,
           t_start: float):
    """What the launcher told this rank, or None outside a launch.  A
    process outside a launch, of a cell on more than one card, replaces
    itself with the launcher of one rank a card of ``python <script>
    <argv>`` on ``device`` ("cuda": rank k takes card k; "cpu") and does
    not return.  ``t_start`` is its start on ``time.perf_counter``'s
    clock, which every process of the host shares (``CLOCK_MONOTONIC``),
    so that ``setup_s`` counts the launcher."""
    got = told()
    world = chips_of(workload)
    if got is not None or world == 1:
        return got
    env = dict(os.environ, **{RANKS_ENV: json.dumps(
        {"device": device, "t_start": t_start})})
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(sys.executable,
              [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nnodes", "1", "--nproc-per-node", str(world),
               "--max-restarts", "0", "--monitor-interval", "0.2",
               script, *argv], env)


def told():
    """What the launcher told this rank, or None outside a launch."""
    got = os.environ.get(RANKS_ENV)
    return None if not got else json.loads(got)


def device_of(got):
    """This rank's device: card ``LOCAL_RANK``, or the CPU."""
    import torch

    if got["device"] == "cuda":
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device(got["device"])


class Ranks:
    """This process's rank, the mesh of the seed axis (None on one card)
    and the collectives the harness itself makes."""

    def __init__(self, rank: int = 0, world: int = 1, mesh=None):
        self.rank, self.world, self.mesh = rank, world, mesh

    @property
    def lead(self) -> bool:
        return self.rank == 0

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank (a broadcast, so that every
        rank takes the same branch at the same collective)."""
        if self.world == 1:
            return bool(flag)
        import torch

        t = torch.tensor([int(bool(flag))], dtype=torch.uint8,
                         device=self.mesh.device_type)
        torch.distributed.broadcast(t, src=0, group=self.mesh.get_group())
        return bool(t.item())

    def barrier(self) -> None:
        if self.world > 1:
            import torch

            torch.distributed.barrier(group=self.mesh.get_group())

    def exchange(self, obj) -> list:
        """Every rank's ``obj`` (small, picklable), in rank order."""
        if self.world == 1:
            return [obj]
        import torch

        out = [None] * self.world
        torch.distributed.all_gather_object(out, obj,
                                            group=self.mesh.get_group())
        return out

    def finish(self) -> None:
        """Leave the process group."""
        if self.world > 1:
            import torch

            torch.distributed.destroy_process_group()


def start(device) -> Ranks:
    """Join the process group of the launch on ``device`` (this rank's
    card, or the CPU) and build the mesh; outside a launch, a ``Ranks``
    of one."""
    if told() is None:
        return Ranks()
    from qoc_tpu_torch.parallel.mesh import init_distributed, make_mesh

    rank = int(os.environ["RANK"])
    if rank > 0:
        # the result is rank 0's last line of standard output
        sys.stdout.flush()
        os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    init_distributed(backend="nccl" if device.type == "cuda" else "gloo",
                     timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return Ranks(rank, int(os.environ["WORLD_SIZE"]), make_mesh())
