"""The inflow held at its full amplitude (DFG 2D-2, 3D-2Z)."""


def amplitude(t: float, traffic: dict) -> float:
    return 1.0
