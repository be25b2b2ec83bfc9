"""DoF management for Taylor-Hood spaces on simplex meshes.

Copy of ``navier_stokes_tpu/fem/dofs.py``: numpy only, so the port runs without JAX;
``tests/test_torch_host.py`` holds it equal to the original.

TPU-native replacement for deal.II ``DoFHandler`` + ``DoFRenumbering::
component_wise`` + block IndexSets (``src/
NavierStokesSolver.cpp:60-97``).  deal.II's dynamic DoF distribution becomes a
one-shot host computation producing int32 index arrays; the global layout is
planar component blocks

    [ u_x (n_vs) | u_y (n_vs) | (u_z) | p (n_ps) ]

which makes the velocity/pressure blocks of the saddle-point system plain
slices (the role of the reference's ``block_owned_dofs`` views, cpp:86-91).
Scalar velocity DoFs are mesh vertices followed by mesh edges (P2); pressure
DoFs are mesh vertices (P1).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ..mesh.mesh import Mesh
from .reference_element import EDGES, TaylorHood, taylor_hood

__all__ = ["scalar_dof_map", "TaylorHoodDofs", "make_dofs", "renumber_sfc", "renumber_bandwidth",
           "renumber_blocked"]


def scalar_dof_map(mesh: Mesh, degree: int) -> tuple[int, np.ndarray, np.ndarray]:
    """(n_dofs, cell_dofs [nc, n_basis], support coords [n_dofs, dim]).

    Local order matches reference_element support points: vertices, then edges.
    """
    if degree == 1:
        return mesh.n_nodes, mesh.cells.copy(), mesh.coords.copy()
    if degree == 2:
        cell_dofs = np.concatenate(
            [mesh.cells, mesh.n_nodes + mesh.cell_edges], axis=1
        ).astype(np.int32)
        mid = 0.5 * (mesh.coords[mesh.edges[:, 0]] + mesh.coords[mesh.edges[:, 1]])
        coords = np.vstack([mesh.coords, mid])
        return mesh.n_nodes + mesh.n_edges, cell_dofs, coords
    if degree == 3:
        # 2 dofs per edge ordered along the CANONICAL (lo->hi) edge direction
        # + bubble dofs.  Local order must match reference_element's P3
        # basis: vertices, then per EDGES[dim] entry (a, b) the node at
        # (2a+b)/3 followed by (a+2b)/3, then one bubble per FACES entry
        # (2D: the single cell-interior bubble; 3D tets: 4 face bubbles and
        # NO interior dof — 27 λa λb λc is vertex-permutation symmetric, so
        # a global face id needs no orientation data).
        nn, ne = mesh.n_nodes, mesh.n_edges
        cells = mesh.cells.astype(np.int64)
        edge_base = nn + 2 * mesh.cell_edges.astype(np.int64)  # [nc, n_ce]
        cols = []
        for k_e, (a, b) in enumerate(EDGES[mesh.dim]):
            # global edge stores (lo, hi); dof 2e sits nearer lo, 2e+1 nearer
            # hi.  The local first basis node sits nearer local vertex a.
            fwd = cells[:, a] < cells[:, b]
            e0 = np.where(fwd, edge_base[:, k_e], edge_base[:, k_e] + 1)
            e1 = np.where(fwd, edge_base[:, k_e] + 1, edge_base[:, k_e])
            cols.extend([e0, e1])
        c0 = mesh.coords[mesh.edges[:, 0]]
        c1 = mesh.coords[mesh.edges[:, 1]]
        edge_pts = np.empty((2 * ne, mesh.dim))
        edge_pts[0::2] = (2 * c0 + c1) / 3.0
        edge_pts[1::2] = (c0 + 2 * c1) / 3.0
        if mesh.dim == 2:
            bubbles = [nn + 2 * ne + np.arange(mesh.n_cells, dtype=np.int64)]
            bubble_pts = mesh.coords[mesh.cells].mean(axis=1)
            n_dofs = nn + 2 * ne + mesh.n_cells
        else:
            face_base = nn + 2 * ne + mesh.cell_faces.astype(np.int64)  # [nc, 4]
            bubbles = [face_base[:, k_f] for k_f in range(4)]
            bubble_pts = mesh.coords[mesh.faces].mean(axis=1)
            n_dofs = nn + 2 * ne + mesh.n_faces
        cell_dofs = np.column_stack(
            [cells[:, i] for i in range(cells.shape[1])] + cols + bubbles
        ).astype(np.int32)
        coords = np.vstack([mesh.coords, edge_pts, bubble_pts])
        return n_dofs, cell_dofs, coords
    raise NotImplementedError(f"P{degree} scalar dof map")


@dataclass
class TaylorHoodDofs:
    mesh: Mesh
    element: TaylorHood
    n_vs: int  # scalar velocity dofs
    n_ps: int  # scalar pressure dofs
    cell_vdofs: np.ndarray  # [nc, n_vb] scalar velocity dof per cell
    cell_pdofs: np.ndarray  # [nc, n_pb]
    v_coords: np.ndarray  # [n_vs, dim]
    p_coords: np.ndarray  # [n_ps, dim]
    # optional renumbering (old "vertices then edges" id -> actual id), used
    # by the space-filling-curve layout for the windowed TPU kernels.  None
    # means identity (the natural [vertices | edges] order).
    v_perm: np.ndarray | None = None
    p_perm: np.ndarray | None = None
    # real-dof masks: renumber_blocked pads n_vs/n_ps with HOLE dofs no cell
    # references (their v_coords are (0, 0)); None means every dof is real
    v_mask: np.ndarray | None = None
    p_mask: np.ndarray | None = None

    @property
    def dim(self) -> int:
        return self.element.dim

    @property
    def n_u(self) -> int:
        return self.dim * self.n_vs

    @property
    def n_p(self) -> int:
        return self.n_ps

    @property
    def n_total(self) -> int:
        return self.n_u + self.n_p

    @cached_property
    def cell_dofs(self) -> np.ndarray:
        """Full mixed-system map [nc, dofs_per_cell], local order
        [u_x | u_y | (u_z) | p] matching TaylorHood's local layout."""
        blocks = [self.cell_vdofs + c * self.n_vs for c in range(self.dim)]
        blocks.append(self.n_u + self.cell_pdofs)
        return np.concatenate(blocks, axis=1).astype(np.int32)

    # -- boundary queries ---------------------------------------------------

    def boundary_scalar_vdofs(self, tags) -> np.ndarray:
        """Sorted unique scalar-velocity DoFs lying on facets with these tags.

        Equivalent of deal.II interpolate_boundary_values' DoF collection
        (cpp:349-373): facet vertices plus (P2) facet edge midpoints.
        """
        tags = np.atleast_1d(np.asarray(tags))
        sel = np.isin(self.mesh.boundary_tags, tags)
        facets = self.mesh.boundary_facets[sel]
        ids = [facets.ravel()]
        deg = self.element.velocity.degree
        if deg == 2:
            ids.append(self.mesh.n_nodes + self._facet_edge_ids(facets))
        elif deg == 3:
            eids = self.mesh.n_nodes + 2 * self._facet_edge_ids(facets)
            ids.extend([eids, eids + 1])
            if self.dim == 3:
                # the facet IS a mesh face: its P3 bubble dof lies on it
                fids = self._facet_face_ids(facets)
                ids.append(self.mesh.n_nodes + 2 * self.mesh.n_edges + fids)
        out = np.unique(np.concatenate(ids)).astype(np.int64)
        if self.v_perm is not None:
            out = np.sort(self.v_perm[out])
        return out.astype(np.int32)

    def boundary_scalar_pdofs(self, tags) -> np.ndarray:
        """Sorted unique scalar-pressure DoFs on facets with these tags
        (P1 pressure: facet vertices).  Used to pin the Cahouet-Chabard
        pressure Laplacian at the outflow (where the velocity Neumann
        condition fixes the pressure level)."""
        tags = np.atleast_1d(np.asarray(tags))
        sel = np.isin(self.mesh.boundary_tags, tags)
        out = np.unique(self.mesh.boundary_facets[sel].ravel()).astype(np.int64)
        if self.p_perm is not None:
            out = np.sort(self.p_perm[out])
        return out.astype(np.int32)

    @property
    def vertex_vdofs(self) -> np.ndarray:
        """Scalar velocity dof id of each mesh vertex (for vertex output)."""
        base = np.arange(self.mesh.n_nodes, dtype=np.int64)
        return (self.v_perm[base] if self.v_perm is not None else base).astype(np.int32)

    @property
    def vertex_pdofs(self) -> np.ndarray:
        base = np.arange(self.mesh.n_nodes, dtype=np.int64)
        return (self.p_perm[base] if self.p_perm is not None else base).astype(np.int32)

    def _facet_edge_ids(self, facets: np.ndarray) -> np.ndarray:
        """Global edge indices of all edges of the given facets."""
        dim = self.dim
        if dim == 2:
            pairs = facets[:, [0, 1]].reshape(-1, 2)
        else:
            pairs = facets[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)
        key = np.sort(pairs.astype(np.int64), axis=1)
        edges = self.mesh.edges.astype(np.int64)
        mult = self.mesh.n_nodes + 1
        ekey = edges[:, 0] * mult + edges[:, 1]
        fkey = key[:, 0] * mult + key[:, 1]
        order = np.argsort(ekey)
        pos = np.searchsorted(ekey[order], fkey)
        eid = order[np.clip(pos, 0, len(order) - 1)]
        if not np.array_equal(ekey[eid], fkey):
            raise ValueError("facet edge not found in mesh edges")
        return eid

    def _facet_face_ids(self, facets: np.ndarray) -> np.ndarray:
        """Global face indices of the given (3D) boundary facets."""
        key = np.sort(facets.astype(np.int64), axis=1)
        faces = self.mesh.faces.astype(np.int64)
        mult = self.mesh.n_nodes + 1
        gkey = (faces[:, 0] * mult + faces[:, 1]) * mult + faces[:, 2]
        fkey = (key[:, 0] * mult + key[:, 1]) * mult + key[:, 2]
        order = np.argsort(gkey)
        pos = np.searchsorted(gkey[order], fkey)
        fid = order[np.clip(pos, 0, len(order) - 1)]
        if not np.array_equal(gkey[fid], fkey):
            raise ValueError("boundary facet not found in mesh faces")
        return fid

    def summary(self) -> str:
        return (
            f"  Number of DoFs:\n    velocity = {self.n_u}\n"
            f"    pressure = {self.n_p}\n    total    = {self.n_total}"
        )


def _first_positions(cell_map: np.ndarray, cell_order: np.ndarray, n: int) -> np.ndarray:
    """Each DoF's first position in the cells' DoF lists read along
    ``cell_order``."""
    seq = cell_map[cell_order].ravel().astype(np.int64)
    first_pos = np.full(n, -1, dtype=np.int64)
    # reversed fill so FIRST occurrence wins
    first_pos[seq[::-1]] = np.arange(len(seq))[::-1]
    assert np.all(first_pos >= 0), "dof never touched by any cell"
    return first_pos


def _first_touch(cell_map: np.ndarray, cell_order: np.ndarray, n: int) -> np.ndarray:
    """old -> new: the DoFs in the order the cells along ``cell_order``
    first touch them."""
    perm = np.empty(n, dtype=np.int64)
    perm[np.argsort(_first_positions(cell_map, cell_order, n), kind="stable")] = np.arange(n)
    return perm


def _rcm_cell_order(dofs: TaylorHoodDofs) -> np.ndarray:
    """Cells sorted by their least scalar velocity DoF in the
    Reverse-Cuthill-McKee numbering of the velocity DoF graph (DoFs sharing
    a cell are adjacent)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    cv = dofs.cell_vdofs.astype(np.int64)
    nb_v = cv.shape[1]
    i = np.repeat(cv, nb_v, axis=1).ravel()
    j = np.tile(cv, (1, nb_v)).ravel()
    adj = sp.coo_matrix((np.ones(len(i), np.int8), (i, j)), shape=(dofs.n_vs, dofs.n_vs)).tocsr()
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True), dtype=np.int64)
    rcm_perm = np.empty(dofs.n_vs, dtype=np.int64)  # old -> new
    rcm_perm[order] = np.arange(dofs.n_vs)
    return np.argsort(rcm_perm[cv].min(axis=1), kind="stable")


def _renumbered(dofs: TaylorHoodDofs, v_perm: np.ndarray, p_perm: np.ndarray) -> TaylorHoodDofs:
    """``dofs`` with its velocity and pressure DoFs moved old -> new by
    ``v_perm`` / ``p_perm`` (no padding)."""
    base_v = dofs.v_perm if dofs.v_perm is not None else np.arange(dofs.n_vs)
    base_p = dofs.p_perm if dofs.p_perm is not None else np.arange(dofs.n_ps)
    return TaylorHoodDofs(
        mesh=dofs.mesh,
        element=dofs.element,
        n_vs=dofs.n_vs,
        n_ps=dofs.n_ps,
        cell_vdofs=v_perm[dofs.cell_vdofs].astype(np.int32),
        cell_pdofs=p_perm[dofs.cell_pdofs].astype(np.int32),
        v_coords=dofs.v_coords[np.argsort(v_perm)],
        p_coords=dofs.p_coords[np.argsort(p_perm)],
        v_perm=v_perm[base_v],
        p_perm=p_perm[base_p],
    )


def renumber_sfc(dofs: TaylorHoodDofs, cell_order: np.ndarray) -> TaylorHoodDofs:
    """First-touch renumbering along a cell ordering (space-filling curve).

    Makes each contiguous run of cells touch a (nearly) contiguous DoF range,
    the locality the windowed kernels (ops/windowed.py) rely on.  The
    numbering plays the role of deal.II's ``DoFRenumbering`` (the reference
    only renumbers component-wise, cpp:73; locality renumbering is our
    addition).
    """
    return _renumbered(dofs, _first_touch(dofs.cell_vdofs, cell_order, dofs.n_vs),
                       _first_touch(dofs.cell_pdofs, cell_order, dofs.n_ps))


def renumber_bandwidth(dofs: TaylorHoodDofs) -> tuple[TaylorHoodDofs, np.ndarray]:
    """Reverse-Cuthill-McKee renumbering: minimizes the DoF bandwidth so that
    every cell's scalar DoFs lie within an O(sqrt(n))-wide contiguous span —
    the feasibility condition for the windowed kernels (ops/windowed.py).

    Returns (renumbered dofs, cell order sorted by first owned dof).
    """
    cell_order = _rcm_cell_order(dofs)
    # BOTH spaces numbered by first touch along the SAME cell order, so the
    # velocity and pressure positions of any mesh region stay proportional
    # (the windowed layout assigns one block index across both spaces)
    return renumber_sfc(dofs, cell_order), cell_order


def _morton_cell_order(mesh) -> np.ndarray:
    """Cell ordering along a Morton (Z-order) space-filling curve of cell
    centroids: consecutive cells are spatially adjacent, so contiguous cell
    blocks get compact dof footprints.  Unlike RCM — whose level sets on
    refined 3D meshes can sweep entire cross-sections and blow the windowed
    halo to 5 blocks with 360-row subwindows — the curve's locality is
    dimension-robust."""
    cent = mesh.coords[mesh.cells[:, : mesh.dim + 1]].mean(axis=1)
    lo, hi = cent.min(axis=0), cent.max(axis=0)
    bits = 63 // cent.shape[1]
    q = ((cent - lo) / np.where(hi > lo, hi - lo, 1.0) * ((1 << bits) - 1)).astype(
        np.uint64
    )

    def spread(x, d):
        # interleave: insert (d-1) zero bits between the bits of x
        out = np.zeros_like(x)
        for b in range(bits):
            out |= ((x >> np.uint64(b)) & np.uint64(1)) << np.uint64(b * d)
        return out

    d = cent.shape[1]
    key = np.zeros(len(cent), dtype=np.uint64)
    for a in range(d):
        key |= spread(q[:, a], d) << np.uint64(a)
    return np.argsort(key, kind="stable")


def renumber_blocked(
    dofs: TaylorHoodDofs, cells_per_block: int = 512, nb_multiple: int = 1,
    order: str = "rcm",
) -> tuple[TaylorHoodDofs, dict]:
    """Block-padded locality renumbering for the windowed TPU kernels.

    One shared block structure drives BOTH spaces: cells are ordered for
    locality (``order``: "rcm" = bandwidth-minimizing Reverse-Cuthill-McKee
    on the vertex-dof graph; "sfc" = Morton curve on cell centroids, the
    dimension-robust choice for refined 3D meshes, see ``_morton_cell_order``)
    and cut into nb contiguous blocks, nb rounded up to a multiple of
    ``nb_multiple`` (the rank count of a sharded run: each rank owns a
    contiguous run of whole blocks); each scalar DoF is OWNED by the block
    of its first-touch cell and numbered ``block * OW + rank`` where OW is
    the 128-rounded max per-block count.  The global vector therefore
    contains padding HOLES (dofs that no cell references); they are benign —
    assembly never writes them, so they stay identically zero through every
    solver operation.  Velocity and pressure block indices are aligned by
    construction (same cell blocks), which keeps windowed halos at h ~ 1.

    Returns (renumbered dofs with padded n_vs/n_ps, {"nb", "OWv", "OWp"}).
    """
    nc = dofs.cell_vdofs.shape[0]
    cell_order = _morton_cell_order(dofs.mesh) if order == "sfc" else _rcm_cell_order(dofs)

    nb = max(1, -(-nc // cells_per_block))
    nb = -(-nb // nb_multiple) * nb_multiple
    cell_block = np.empty(nc, dtype=np.int64)
    cell_block[cell_order] = np.arange(nc) // (-(-nc // nb))

    def blocked_perm(cell_map, n):
        k = cell_map.shape[1]
        first_pos = _first_positions(cell_map, cell_order, n)
        ft_cell = cell_order[first_pos // k]
        block = cell_block[ft_cell]
        # rank within block by first-touch order
        sort_idx = np.lexsort((first_pos, block))
        counts = np.bincount(block, minlength=nb)
        OW = _round_up_128(int(counts.max()))
        rank = np.arange(n) - np.concatenate([[0], np.cumsum(counts[:-1])])[block[sort_idx]]
        perm = np.empty(n, dtype=np.int64)
        perm[sort_idx] = block[sort_idx] * OW + rank
        return perm, OW

    v_perm, OWv = blocked_perm(dofs.cell_vdofs, dofs.n_vs)
    p_perm, OWp = blocked_perm(dofs.cell_pdofs, dofs.n_ps)
    n_vs_pad, n_ps_pad = nb * OWv, nb * OWp

    def padded_coords(coords, perm, n_pad):
        out = np.zeros((n_pad, coords.shape[1]))
        out[perm] = coords
        return out

    base_v = dofs.v_perm if dofs.v_perm is not None else np.arange(dofs.n_vs)
    base_p = dofs.p_perm if dofs.p_perm is not None else np.arange(dofs.n_ps)

    def real_mask(perm, n_pad):
        m = np.zeros(n_pad, dtype=bool)
        m[perm] = True
        return m

    new = TaylorHoodDofs(
        mesh=dofs.mesh,
        element=dofs.element,
        n_vs=n_vs_pad,
        n_ps=n_ps_pad,
        cell_vdofs=v_perm[dofs.cell_vdofs].astype(np.int32),
        cell_pdofs=p_perm[dofs.cell_pdofs].astype(np.int32),
        v_coords=padded_coords(dofs.v_coords, v_perm, n_vs_pad),
        p_coords=padded_coords(dofs.p_coords, p_perm, n_ps_pad),
        v_perm=v_perm[base_v],
        p_perm=p_perm[base_p],
        v_mask=real_mask(v_perm, n_vs_pad),
        p_mask=real_mask(p_perm, n_ps_pad),
    )
    return new, {"nb": nb, "OWv": OWv, "OWp": OWp}


def _round_up_128(x: int) -> int:
    return -(-x // 128) * 128


def make_dofs(mesh: Mesh, degree_velocity: int = 2, degree_pressure: int = 1) -> TaylorHoodDofs:
    elem = taylor_hood(mesh.dim, degree_velocity, degree_pressure)
    n_vs, cell_vdofs, v_coords = scalar_dof_map(mesh, degree_velocity)
    n_ps, cell_pdofs, p_coords = scalar_dof_map(mesh, degree_pressure)
    return TaylorHoodDofs(
        mesh=mesh,
        element=elem,
        n_vs=n_vs,
        n_ps=n_ps,
        cell_vdofs=cell_vdofs,
        cell_pdofs=cell_pdofs,
        v_coords=v_coords,
        p_coords=p_coords,
    )
