"""Run-file persistence: h5 schema compatible with the reference.

A copy of ``qoc_tpu.utils.h5``.  The port imports this module only on the
save path, so a run with ``save=False`` needs no h5py.

Reimplements the subset of the Schuster-lab H5File wrapper the GRAPE
pipeline uses (helper_functions/data_management.py:10,138-187: ``add`` =
create-or-replace resizable dataset, ``append`` = grow along a new leading
axis), plus the auto-incrementing ``NNNNN_<name>.h5`` run-file naming
(main_grape/grape.py:45-51).  Output files are readable by the reference's
own tooling and by ``qoc_tpu.utils.verification``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import h5py

    HAVE_H5PY = True
except ImportError:  # the port runs without h5py until a run saves
    HAVE_H5PY = False


def require_h5py():
    """Raise a clear ImportError when a run asks to save without h5py."""
    if not HAVE_H5PY:
        raise ImportError(
            "save=True writes an h5 run file and needs the h5py package, "
            "which is not installed; pass save=False or install h5py")


class H5File(h5py.File if HAVE_H5PY else object):
    """h5py.File with Schuster-lab add/append semantics."""

    def __init__(self, *args, **kwargs):
        require_h5py()
        h5py.File.__init__(self, *args, **kwargs)
        self.flush()

    # -- create-or-replace (data_management.py:138-149, :181) --------------
    def add(self, key: str, data):
        data = np.array(data)
        if data.dtype.kind in ("U", "O"):
            data = np.array(
                data, dtype=h5py.string_dtype() if HAVE_H5PY else object
            )
        if key in self:
            del self[key]
        maxshape = tuple([None] * data.ndim) if data.ndim else None
        self.create_dataset(key, data=data, maxshape=maxshape)
        self.flush()

    # -- append along a new leading axis (data_management.py:151-184) ------
    def append(self, key: str, data):
        data = np.array(data)
        if key not in self:
            self.create_dataset(
                key,
                shape=tuple([1] + list(data.shape)),
                maxshape=tuple([None] * (data.ndim + 1)),
                dtype=str(data.dtype),
            )
        else:
            ds = self[key]
            shape = list(ds.shape)
            shape[0] += 1
            ds.resize(shape)
        ds = self[key]
        if data.ndim:
            ds[-1, :] = data
        else:
            ds[-1] = data
        self.flush()

    # -- row/point appends (data_management.py:75-107) ---------------------
    def append_line(self, dataset, line, axis: int = 0):
        line = np.asarray(line)
        if isinstance(dataset, str):
            if dataset not in self:
                shape, maxshape = (0, len(line)), (None, len(line))
                if axis == 1:
                    shape, maxshape = shape[::-1], maxshape[::-1]
                self.create_dataset(dataset, shape=shape, maxshape=maxshape,
                                    dtype="float64")
            dataset = self[dataset]
        shape = list(dataset.shape)
        shape[axis] += 1
        dataset.resize(shape)
        if axis == 0:
            dataset[-1, :] = line
        else:
            dataset[:, -1] = line
        self.flush()

    def append_pt(self, dataset, pt):
        if isinstance(dataset, str):
            if dataset not in self:
                self.create_dataset(dataset, shape=(0,), maxshape=(None,),
                                    dtype="float64")
            dataset = self[dataset]
        shape = list(dataset.shape)
        shape[0] += 1
        dataset.resize(shape)
        dataset[-1] = pt
        self.flush()

    # -- timestamped notes (data_management.py:109-136) --------------------
    def note(self, note: str):
        import datetime

        ts = datetime.datetime.now()
        if "notes" not in self:
            self.create_dataset("notes", (0,), maxshape=(None,),
                                dtype=h5py.string_dtype())
        ds = self["notes"]
        shape = list(ds.shape)
        shape[0] += 1
        ds.resize(shape)
        ds[-1] = str(ts) + " -- " + note
        self.flush()

    def get_notes(self, one_string: bool = False, print_notes: bool = False):
        notes = (
            [n.decode() if isinstance(n, bytes) else str(n)
             for n in self["notes"]]
            if "notes" in self else []
        )
        if print_notes:
            print("\n".join(notes))
        if one_string:
            return "\n".join(notes)
        return notes

    # -- plot-axis metadata (data_management.py:63-73) ---------------------
    def set_range(self, dataset, xmin, xmax, ymin=None, ymax=None):
        if ymin is not None and ymax is not None:
            dataset.attrs["_axes"] = ((xmin, xmax), (ymin, ymax))
        else:
            dataset.attrs["_axes"] = (xmin, xmax)

    def set_labels(self, dataset, x_lab, y_lab, z_lab=None):
        labels = (x_lab, y_lab) if z_lab is None else (x_lab, y_lab, z_lab)
        dataset.attrs["_axes_labels"] = labels

    def save_dict(self, d: dict, group: str = "/"):
        if group not in self:
            self.create_group(group)
        for k, v in d.items():
            self[group].attrs[k] = v

    def get_dict(self, group: str = "/") -> dict:
        return {k: self[group].attrs[k] for k in self[group].attrs.keys()}

    get_attrs = get_dict
    save_attrs = save_dict

    def save_settings(self, dic: dict, group: str = "settings"):
        self.save_dict(dic, group)

    def load_settings(self, group: str = "settings") -> dict:
        return self.get_dict(group)


def next_run_path(data_path: str, file_name: str) -> str:
    """Auto-incrementing 5-digit-prefixed run file path (grape.py:45-51).
    Creates ``data_path`` if absent (the reference crashes in h5py
    instead)."""
    os.makedirs(data_path, exist_ok=True)
    file_num = 0
    while os.path.exists(
        os.path.join(data_path, str(file_num).zfill(5) + "_" + file_name + ".h5")
    ):
        file_num += 1
    return os.path.join(
        data_path, str(file_num).zfill(5) + "_" + file_name + ".h5"
    )


def save_run_inputs(
    file_path: str,
    *,
    H0,
    Hops,
    Hnames,
    U,
    total_time,
    steps,
    states_concerned_list,
    maxA=None,
    initial_guess=None,
    method: str = "Adam",
    convergence: Optional[dict] = None,
    reg_coeffs: Optional[dict] = None,
    dressed_info: Optional[dict] = None,
    use_gpu: bool = True,
    sparse_H: bool = True,
    sparse_U: bool = False,
    sparse_K: bool = False,
):
    """Dump all run inputs up-front (grape.py:55-87 schema).

    ``use_gpu``/``sparse_H/U/K`` have no effect here but are part of the
    reference's input-dump field list (grape.py:63-66) — schema-complete
    readers expect them.
    """
    with H5File(file_path, "a") as hf:
        hf.add("H0", H0)
        hf.add("Hops", Hops)
        hf.add("Hnames", [str(h) for h in Hnames])
        hf.add("U", U)
        hf.add("total_time", total_time)
        hf.add("steps", steps)
        hf.add("states_concerned_list", states_concerned_list)
        hf.add("use_gpu", use_gpu)
        hf.add("sparse_H", sparse_H)
        hf.add("sparse_U", sparse_U)
        hf.add("sparse_K", sparse_K)
        if maxA is not None:
            hf.add("maxA", maxA)
        if initial_guess is not None:
            hf.add("initial_guess", initial_guess)
        hf.add("method", method)
        for group_name, d in (
            ("convergence", convergence),
            ("reg_coeffs", reg_coeffs),
            ("dressed_info", dressed_info),
        ):
            if d is not None:
                g = hf.create_group(group_name)
                for k, v in d.items():
                    g.create_dataset(k, data=np.asarray(v))
