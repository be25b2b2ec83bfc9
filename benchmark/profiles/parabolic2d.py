"""DFG 2D inflow shape (Schafer & Turek 1996): 4 y (H - y) / H^2 along x,
1 at the channel's middle."""

import numpy as np


def shape(x, geometry: dict):
    H, y = geometry["H"], x[:, 1]
    v = np.zeros_like(x)
    v[:, 0] = 4 * y * (H - y) / H**2
    return v
