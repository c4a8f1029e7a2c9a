"""One iteration of a batch of S seeds of one problem kind: S times each
seed's operations and bytes, with the generators, which every seed
shares, read once."""

import importlib


def per_iteration(kind, sizes, seeds):
    one = importlib.import_module(f"benchmark.work.{kind}").per_seed(sizes)
    return {"flops": seeds * one["flops"],
            "bytes": one["shared_bytes"] + seeds * one["seed_bytes"]}
