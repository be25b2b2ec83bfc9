"""The fluid at rest: every velocity and pressure 0 (the Dirichlet rows
take their values in the first step)."""

import torch


def make(solver, traffic: dict):
    return torch.zeros_like(solver.solution)
