"""Tiny versions of the cells for CPU runs of the harness: the cell's own
configuration and traffic with a mesh of a few hundred cells and 2-step
segments."""

import copy

SIZES = {2: dict(n_side=4, n_radial=3, n_down=8),
         3: dict(n_side=4, n_radial=2, n_up=2, n_down=6, n_z=2)}


def tiny(cfg: dict, traffic: dict):
    cfg = copy.deepcopy(cfg)
    cfg["mesh"].update(SIZES[3 if cfg["mesh"].get("n_z") else 2])
    cfg["solver"]["krylov"]["cells_per_block"] = 32
    return cfg, dict(traffic, steps=2, checked_steps=2)
