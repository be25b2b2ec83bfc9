"""DFG cylinder channel meshes from the published geometry (numpy only).

Schäfer & Turek, "Benchmark computations of laminar flow around a cylinder"
(1996): a channel [0, L] x [0, H] (x [0, H] in 3D) with a cylinder of radius
r whose axis passes through (cx, cy) (along z in 3D).

The cross-section is an O-grid: a square of side H spanning the channel's
height, [x0, x0 + H] with x0 = max(0, cx - H/2), around the cylinder, cut
into quadrilaterals along rays from the axis to 4 * n_side points spaced
evenly on the square's boundary; along a ray the n_radial layers grow
geometrically from the circle (every circle node lies on it) to the square.
Structured blocks of n_side rows fill the channel before the square (n_up
columns, none where x0 = 0) and after it (n_down columns).  Each
quadrilateral is cut into two triangles.

In 3D the cross-section is extruded over n_z layers in z and every prism is
cut into 3 tetrahedra by the global vertex order: on each of its side faces
the diagonal runs from the lower-numbered bottom vertex to the top vertex
above the higher-numbered one, so two prisms that share a face cut it alike.

``build(recipe)`` returns the mesh as arrays: coords [n, dim], cells
[nc, dim + 1] (positively oriented), facets [nf, dim] and their tags [nf]
from ``recipe["tags"]`` (inlet x = 0, outlet x = L, walls, cylinder).
"""

from __future__ import annotations

import numpy as np


def _cross_section(L, H, cx, cy, r, n_side, n_radial, n_up, n_down):
    """2D nodes, quadrilaterals [nq, 4] (counter-clockwise) and boundary
    edges by kind: {"inlet", "outlet", "walls", "cylinder"} -> [m, 2]."""
    x0 = max(0.0, cx - H / 2)
    n, nr = n_side, n_radial
    if n_up and x0 == 0.0:
        raise ValueError("no room for an upstream block: the square touches the inlet")
    if not n_up and x0 > 0.0:
        raise ValueError("the square leaves a gap at the inlet: give n_up")
    t = np.arange(n) / n
    corners = np.array([[x0, 0.0], [x0 + H, 0.0], [x0 + H, H], [x0, H]])
    # the square's boundary counter-clockwise from (x0, 0): bottom, right,
    # top, left; side s holds ring points s*n .. s*n + n - 1
    ring = np.concatenate(
        [corners[s] + t[:, None] * (corners[(s + 1) % 4] - corners[s]) for s in range(4)])
    C = np.array([cx, cy])
    d = ring - C
    R = np.linalg.norm(d, axis=1)
    e = d / R[:, None]
    s = np.arange(nr + 1) / nr
    rad = r * (R[:, None] / r) ** s[None, :]  # [4n, nr + 1]
    og = C + rad[:, :, None] * e[:, None, :]  # [4n, nr + 1, 2]
    og[:, 0] = C + r * e  # on the circle to the last bit
    og[:, nr] = ring
    coords = [og.reshape(-1, 2)]

    def oid(k, j):
        return (k % (4 * n)) * (nr + 1) + j

    k, j = np.meshgrid(np.arange(4 * n), np.arange(nr), indexing="ij")
    k, j = k.ravel(), j.ravel()
    # (k, j) -> (k + 1, j) turns counter-clockwise about the axis and j grows
    # outwards, so this order is clockwise: reversed
    quads = [np.stack([oid(k, j), oid(k, j + 1), oid(k + 1, j + 1), oid(k + 1, j)], 1)]
    kk = np.arange(4 * n)
    edges = {
        "cylinder": np.stack([oid(kk, 0), oid(kk + 1, 0)], 1),
        "walls": [np.stack([oid(kk[:n], nr), oid(kk[:n] + 1, nr)], 1),
                  np.stack([oid(kk[2 * n:3 * n], nr), oid(kk[2 * n:3 * n] + 1, nr)], 1)],
        "inlet": [], "outlet": [],
    }
    base = og.shape[0] * og.shape[1]
    ys = H * np.arange(n + 1) / n

    def block(xa, xb, ncol, left_ids, right_ids):
        """A structured block of ncol columns over [xa, xb]: returns the ids
        of its node columns (those given on the left / right are shared)."""
        nonlocal base
        cols = []
        xs = xa + (xb - xa) * np.arange(ncol + 1) / ncol
        for c in range(ncol + 1):
            if c == 0 and left_ids is not None:
                cols.append(left_ids)
            elif c == ncol and right_ids is not None:
                cols.append(right_ids)
            else:
                coords.append(np.stack([np.full(n + 1, xs[c]), ys], 1))
                cols.append(base + np.arange(n + 1))
                base += n + 1
        cols = np.stack(cols)  # [ncol + 1, n + 1]
        a, b = np.meshgrid(np.arange(ncol), np.arange(n), indexing="ij")
        a, b = a.ravel(), b.ravel()
        quads.append(np.stack([cols[a, b], cols[a + 1, b], cols[a + 1, b + 1], cols[a, b + 1]], 1))
        edges["walls"].append(np.stack([cols[:-1, 0], cols[1:, 0]], 1))
        edges["walls"].append(np.stack([cols[:-1, n], cols[1:, n]], 1))
        return cols

    # the square's right side bottom-up: ring points n .. 2n
    right = oid(np.arange(n, 2 * n + 1), nr)
    # its left side bottom-up: ring points 4n (= 0), 4n - 1, .., 3n
    left = oid(np.arange(4 * n, 3 * n - 1, -1), nr)
    down = block(x0 + H, L, n_down, right, None)
    edges["outlet"].append(np.stack([down[-1, :-1], down[-1, 1:]], 1))
    if n_up:
        up = block(0.0, x0, n_up, None, left)
        edges["inlet"].append(np.stack([up[0, :-1], up[0, 1:]], 1))
    else:
        edges["inlet"].append(np.stack([left[:-1], left[1:]], 1))
    coords = np.concatenate(coords)
    edges = {key: (np.concatenate(v) if isinstance(v, list) else v) for key, v in edges.items()}
    return coords, np.concatenate(quads), edges


def _split_quads(quads):
    """Each counter-clockwise quadrilateral (a, b, c, d) -> (a, b, c), (a, c, d)."""
    return np.concatenate([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]])


def _extrude(coords2, tris, edges, H, n_z):
    """Prisms over the triangles in n_z layers of z in [0, H], each cut into
    3 tetrahedra by the global vertex order; boundary triangles by kind."""
    m = len(coords2)
    z = H * np.arange(n_z + 1) / n_z
    coords = np.concatenate([np.column_stack([coords2, np.full(m, zl)]) for zl in z])
    p, q, rr = np.sort(tris, axis=1).T  # p < q < r by 2D id, alike on every layer
    cells = []
    for l in range(n_z):
        b, t = l * m, (l + 1) * m
        cells += [np.stack([p + b, q + b, rr + b, rr + t], 1),
                  np.stack([p + b, q + b, q + t, rr + t], 1),
                  np.stack([p + b, p + t, q + t, rr + t], 1)]
    faces = {"walls": [tris, tris + n_z * m], "inlet": [], "outlet": [], "cylinder": []}
    for kind, e in edges.items():
        lo, hi = np.sort(e, axis=1).T
        for l in range(n_z):
            b, t = l * m, (l + 1) * m
            # the side quad (lo, hi, hi', lo') cut along lo -> hi'
            faces[kind] += [np.stack([lo + b, hi + b, hi + t], 1),
                            np.stack([lo + b, lo + t, hi + t], 1)]
    return coords, np.concatenate(cells), {k: np.concatenate(v) for k, v in faces.items()}


def _orient(coords, cells):
    """Swap the last two vertices of every cell with a negative volume."""
    v = coords[cells]
    J = v[:, 1:, :] - v[:, :1, :]
    neg = np.linalg.det(J) < 0
    cells = cells.copy()
    cells[neg, -2], cells[neg, -1] = cells[neg, -1], cells[neg, -2].copy()
    return cells


def build(recipe: dict) -> dict:
    """The mesh of ``recipe`` (the configuration's "mesh" entry, with the
    geometry's L, H, cx, cy, r merged in): {"coords", "cells", "facets",
    "tags"}."""
    coords, quads, edges = _cross_section(
        recipe["L"], recipe["H"], recipe["cx"], recipe["cy"], recipe["r"],
        recipe["n_side"], recipe["n_radial"], recipe.get("n_up", 0), recipe["n_down"])
    cells = _split_quads(quads)
    facets = edges
    if recipe.get("n_z"):
        coords, cells, facets = _extrude(coords, cells, edges, recipe["H"], recipe["n_z"])
    tags = recipe["tags"]
    kinds = [k for k in ("inlet", "outlet", "walls", "cylinder") if len(facets[k])]
    return {
        "coords": coords,
        "cells": _orient(coords, cells).astype(np.int32),
        "facets": np.concatenate([facets[k] for k in kinds]).astype(np.int32),
        "tags": np.concatenate(
            [np.full(len(facets[k]), tags[k], np.int32) for k in kinds]),
    }
