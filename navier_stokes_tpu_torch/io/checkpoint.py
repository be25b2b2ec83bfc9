"""Checkpoint / resume: solution + time + step state to HDF5.

Port of ``navier_stokes_tpu/io/checkpoint.py`` (the same datasets and
attributes, so either package reads the other's files).  The checkpoint
stores the full Taylor-Hood coefficient vector, the previous-step solution
(needed by the implicit-Euler time term, cpp:666), BDF2's second history
level when there is one, scalar time state, and the config dict for
validation.  Arrays are numpy; the solver hands over host float64 copies.
"""

from __future__ import annotations

import json

import numpy as np

from . import h5py as _h5py

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(
    path, *, solution, solution_old, time, step, config=None, solution_old2=None
):
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        f.create_dataset("solution", data=np.asarray(solution, dtype=np.float64))
        f.create_dataset("solution_old", data=np.asarray(solution_old, dtype=np.float64))
        if solution_old2 is not None:  # BDF2 second history level
            f.create_dataset(
                "solution_old2", data=np.asarray(solution_old2, dtype=np.float64)
            )
        f.attrs["time"] = float(time)
        f.attrs["step"] = int(step)
        if config is not None:
            f.attrs["config"] = json.dumps(config)
    return path


def load_checkpoint(path):
    h5py = _h5py()
    with h5py.File(path, "r") as f:
        out = {
            "solution": f["solution"][:],
            "solution_old": f["solution_old"][:],
            "time": float(f.attrs["time"]),
            "step": int(f.attrs["step"]),
        }
        if "solution_old2" in f:
            out["solution_old2"] = f["solution_old2"][:]
        if "config" in f.attrs:
            out["config"] = json.loads(f.attrs["config"])
    return out
