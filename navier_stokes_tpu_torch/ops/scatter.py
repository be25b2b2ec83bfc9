"""Scatter-free global assembly: transpose gather maps.

Port of ``navier_stokes_tpu/ops/scatter.py``.  ``build_gather_map`` is the
original's numpy code, copied (``tests/test_torch_flat.py`` holds its maps
equal).  Per global dof it lists the flat positions of that dof's per-cell
contributions, so the reduction

    y = segment_sum(yl.ravel(), cell_dofs.ravel(), n)

becomes a gather and a dense row sum, ``y = yl_ext[gather_idx].sum(1)``.
On the card this is also the deterministic route: each dof sums its K
contributions in the map's order, where ``index_add_`` uses atomics whose
float32 order changes from run to run.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["build_gather_map", "gather_scatter"]


def build_gather_map(cell_dofs: np.ndarray, n: int) -> np.ndarray:
    """Transpose map: [n, K] flat positions into cell_dofs-shaped values.

    Position ``cell_dofs.size`` (one past the end) is the zero sentinel —
    callers append a single 0 to the flattened source before gathering.
    """
    flat = np.asarray(cell_dofs, dtype=np.int64).ravel()
    order = np.argsort(flat, kind="stable")
    sorted_dofs = flat[order]
    counts = np.bincount(sorted_dofs, minlength=n)
    K = int(counts.max()) if len(flat) else 1
    sentinel = flat.size
    idx = np.full((n, K), sentinel, dtype=np.int64)
    # row-major fill: position j within each dof's run
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    within = np.arange(len(flat)) - starts[sorted_dofs]
    idx[sorted_dofs, within] = order
    return idx.astype(np.int32)


def gather_scatter(values_flat: torch.Tensor, gather_idx: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k values_ext[gather_idx[i, k]] with a zero sentinel row.

    values_flat: flattened per-cell values [nc * nl]; gather_idx: [n, K]."""
    ext = torch.cat([values_flat, values_flat.new_zeros(1)])
    return ext[gather_idx].sum(dim=1)
