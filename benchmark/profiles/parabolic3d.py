"""DFG 3D inflow shape (Schafer & Turek 1996): 16 y z (H - y)(H - z) / H^4
along x, 1 at the channel's axis."""

import numpy as np


def shape(x, geometry: dict):
    H, y, z = geometry["H"], x[:, 1], x[:, 2]
    v = np.zeros_like(x)
    v[:, 0] = 16 * y * z * (H - y) * (H - z) / H**4
    return v
