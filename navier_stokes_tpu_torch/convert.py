"""Carry state between the JAX package and this port.

The JAX package's ``WindowedLayout``, ``WindowedAssembly`` and ``FEMContext``
are dataclasses whose array fields share their names with this port's.  A
caller flattens one to a dict of numpy arrays and static values
(``arrays_of``, which reads any dataclass through ``np.asarray`` and so needs
no JAX import here), and ``*_from_arrays`` rebuilds the port's object on a
torch device (the deflation rows ``kp_modes`` included).  Fields the port
does not have (SPMD metadata) are dropped.  Solution vectors are plain
arrays: ``torch.as_tensor(np.asarray(x))``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fem.assembly import FEMContext
from .fem.windowed_assembly import WindowedAssembly
from .ops.windowed import WindowedLayout

__all__ = [
    "arrays_of",
    "to_tensor",
    "layout_from_arrays",
    "assembly_from_arrays",
    "context_from_arrays",
]


def arrays_of(obj) -> dict:
    """{field: numpy array or static value} of a dataclass from either
    package (array fields are anything with ``shape`` and ``dtype``)."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            v = np.asarray(v)
        out[f.name] = v
    return out


def to_tensor(a, device="cpu") -> torch.Tensor:
    """numpy array -> tensor of the same type (bfloat16 arrays included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)  # a copy: JAX arrays are read-only


def _from_arrays(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue  # optional field with a default
        v = d[f.name]
        kw[f.name] = to_tensor(v, device) if isinstance(v, np.ndarray) else v
    return cls(**kw)


def layout_from_arrays(d: dict, device="cpu") -> WindowedLayout:
    return _from_arrays(WindowedLayout, d, device)


def assembly_from_arrays(d: dict, device="cpu") -> WindowedAssembly:
    return _from_arrays(WindowedAssembly, d, device)


def context_from_arrays(d: dict, device="cpu") -> FEMContext:
    return _from_arrays(FEMContext, d, device)
