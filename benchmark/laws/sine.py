"""The inflow's amplitude sin(pi t / period), period 8 in DFG 2D-3 and
3D-3Z."""

import math


def amplitude(t: float, traffic: dict) -> float:
    return math.sin(math.pi * t / traffic["period"])
