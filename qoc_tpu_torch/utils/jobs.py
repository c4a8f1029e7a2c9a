"""Job files: a JSON object of ``Grape`` keyword arguments (the format of
qoc_tpu's ``cli.load_config`` and ``examples/jobs/*.json``).

Matrices and vectors are nested lists (real), ``{"real": [...], "imag":
[...]}`` (complex) or ``{"npz": "file.npz", "key": "H0"}`` (an entry of an
.npz archive beside the job file).  Keys that start with ``_`` are
comments.  The CLI around it is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import json
import os

import numpy as np

ARRAY_KEYS = ("H0", "U", "U0", "initial_guess")
ARRAY_LIST_KEYS = ("Hops",)
VECTOR_LIST_KEYS = ("states_concerned_list",)


def decode_array(obj, base_dir: str = "."):
    """A JSON value as a numpy array (real list, {real, imag}, npz entry)."""
    if isinstance(obj, dict):
        if "npz" in obj:
            path = obj["npz"]
            if not os.path.isabs(path):
                path = os.path.join(base_dir, path)
            with np.load(path) as data:
                return np.asarray(data[obj["key"]])
        if "real" in obj:
            real = np.asarray(obj["real"], dtype=float)
            imag = np.asarray(obj.get("imag", np.zeros_like(real)),
                              dtype=float)
            return real + 1j * imag
        raise ValueError(f"unrecognized array spec: {list(obj)}")
    return np.asarray(obj)


def load_job(path: str) -> dict:
    """The ``Grape`` keyword arguments of a job file, arrays decoded."""
    with open(path) as f:
        cfg = json.load(f)
    cfg = {k: v for k, v in cfg.items() if not k.startswith("_")}
    base = os.path.dirname(os.path.abspath(path))
    # state-transfer targets and initial states are lists of vectors
    if cfg.get("state_transfer"):
        for k in ("U",) + VECTOR_LIST_KEYS:
            if k in cfg and isinstance(cfg[k], list):
                cfg[k] = [decode_array(v, base) for v in cfg[k]]
    for k in ARRAY_KEYS:
        if cfg.get(k) is not None and not (cfg.get("state_transfer")
                                           and k == "U"):
            cfg[k] = decode_array(cfg[k], base)
    for k in ARRAY_LIST_KEYS:
        if k in cfg:
            cfg[k] = [decode_array(h, base) for h in cfg[k]]
    di = cfg.get("dressed_info")
    if di is not None:
        for k in ("eigenvectors", "eigenvalues"):
            if k in di:
                di[k] = decode_array(di[k], base)
    return cfg
