"""Structured run logging reproducing the reference's rank-0 pcout output.

Copy of ``navier_stokes_tpu/utils/logging.py``: numpy only, so the port runs
without JAX.  ``coordinator_log`` is the reference's rank-0 condition on
``pcout`` (``hpp:648``) for multi-rank runs.

The reference's only observability is ``ConditionalOStream pcout`` printing
mesh stats, DoF counts, Newton residuals, and GMRES iteration counts
(``src/NavierStokesSolver.cpp:23-24,93-96,553,584,604-606``).
Those lines ARE the parity signals (SURVEY §5), so the logger reproduces their
exact format AND records everything as structured records for CSV/JSON dumps.
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field

__all__ = ["RunLog", "coordinator_log"]

RULE = "-----------------------------------------------"
BANNER = "==============================================="


@dataclass
class RunLog:
    verbose: bool = True
    records: list = field(default_factory=list)

    def print(self, msg: str = "", end="\n"):
        if self.verbose:
            print(msg, end=end, file=sys.stdout, flush=True)

    def rule(self):
        self.print(RULE)

    def banner(self):
        self.print(BANNER)

    # --- parity-format events ---

    def newton_residual(self, n_iter: int, n_max: int, norm: float):
        """cpp:604-606 format: '  Newton iteration k/N - ||r|| = x.xxxxxxe-yy'"""
        self.records.append({"event": "newton", "iter": n_iter, "residual": float(norm)})
        self.print(f"  Newton iteration {n_iter}/{n_max} - ||r|| = {norm:.6e}", end="")

    def newton_converged(self):
        self.print(" < tolerance")

    def gmres_iters(self, n: int, system: str = "tangent"):
        """cpp:553,584 format."""
        self.records.append({"event": "gmres", "system": system, "iters": int(n)})
        if system == "stokes":
            self.print(f"  {n} GMRES iterations")
        else:
            self.print(f"   {n} GMRES iterations")

    def krylov_failure(self, iters: int, residual: float, system: str = "tangent"):
        """Tangent-solve non-convergence (deal.II throws NoConvergence,
        cpp:566-585; we surface it as a structured record + visible line)."""
        self.records.append(
            {
                "event": "krylov_failure",
                "system": system,
                "iters": int(iters),
                "residual": float(residual),
            }
        )
        self.print(
            f"  WARNING: {system} GMRES did NOT converge "
            f"({iters} iterations, residual {residual:.6e})"
        )

    def time_step(self, step: int, t: float):
        """cpp:668-669 format."""
        self.records.append({"event": "time_step", "step": step, "t": float(t)})
        self.print(f"n = {step:3d}, t = {t:5.2f}")

    def event(self, **kw):
        self.records.append(kw)

    # --- structured dumps ---

    def residual_trajectory(self) -> list:
        return [r for r in self.records if r.get("event") == "newton"]

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.records, f, indent=1)


def coordinator_log(**kw) -> RunLog:
    """A RunLog that prints on rank 0 only and records on every rank (the
    reference's ``ConditionalOStream pcout``, hpp:648,698)."""
    from ..parallel.bootstrap import is_coordinator

    return RunLog(verbose=is_coordinator(), **kw)
