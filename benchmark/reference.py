"""Plain Taylor-Hood P2/P1 Navier-Stokes residual on triangles and tetrahedra.

The yardstick that judges the port's time steps.  It imports nothing of the
port: its own P2 nodes (vertices, then edge midpoints), its own basis in
barycentric coordinates, and its own quadrature (a collapsed Gauss-Legendre
product rule of 4 points a direction, exact to degree 5 on the tetrahedron
and 6 on the triangle, so every term of the P2/P1 residual, of degree 5 at
most, is integrated exactly).  It is evaluated in
blocks of cells, in float64 by default.

The residual is the incompressible Navier-Stokes system in the port's sign
convention, with the convection (u . grad) u and the continuity row, a
do-nothing outlet at p_out = 0 and no body force:

    r_u = - rho (a0 u + a1 u_old + a2 u_old2) / dt . phi
          - nu rho grad u : grad phi - rho ((u . grad) u) . phi + p div phi
    r_p = (div u) psi

with (a0, a1, a2) = (1, -1, 0) for BDF1 and (3/2, -2, 1/2) for BDF2; the
steady Stokes residual drops the time and convection terms.  A Dirichlet
row holds d (g - u), where d is the row's mass-over-dt plus viscous
diagonal, so its size is that of a momentum row.
"""

from __future__ import annotations

import numpy as np
import torch

EDGES = {2: ((0, 1), (1, 2), (0, 2)), 3: ((0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3))}
BDF = {1: (1.0, -1.0, 0.0), 2: (1.5, -2.0, 0.5)}


def simplex_rule(dim: int, n: int = 4):
    """Points [nq, dim] and weights [nq] on the unit simplex: Gauss-Legendre
    on [0, 1]^dim collapsed onto it (x = a, y = b (1 - a), z = c (1 - a)
    (1 - b)), weights summing to 1 / dim!."""
    g, w = np.polynomial.legendre.leggauss(n)
    g, w = (g + 1) / 2, w / 2
    if dim == 2:
        a, b = np.meshgrid(g, g, indexing="ij")
        wa, wb = np.meshgrid(w, w, indexing="ij")
        pts = np.stack([a, b * (1 - a)], -1).reshape(-1, 2)
        return pts, (wa * wb * (1 - a)).ravel()
    a, b, c = np.meshgrid(g, g, g, indexing="ij")
    wa, wb, wc = np.meshgrid(w, w, w, indexing="ij")
    pts = np.stack([a, b * (1 - a), c * (1 - a) * (1 - b)], -1).reshape(-1, 3)
    return pts, (wa * wb * wc * (1 - a) ** 2 * (1 - b)).ravel()


def p2_basis(dim: int, pts: np.ndarray):
    """P2 values [dim + 1 + n_edges, nq] and reference gradients [.., nq,
    dim] (vertex functions L(2L - 1), then edge functions 4 La Lb), and the
    P1 values [dim + 1, nq] (the barycentric coordinates)."""
    L = np.concatenate([1 - pts.sum(1, keepdims=True), pts], 1).T  # [dim + 1, nq]
    dL = np.concatenate([-np.ones((1, dim)), np.eye(dim)])  # [dim + 1, dim]
    N = [L[i] * (2 * L[i] - 1) for i in range(dim + 1)]
    G = [(4 * L[i] - 1)[:, None] * dL[i] for i in range(dim + 1)]
    for a, b in EDGES[dim]:
        N.append(4 * L[a] * L[b])
        G.append(4 * (L[a][:, None] * dL[b] + L[b][:, None] * dL[a]))
    return np.array(N), np.array(G), L


class Reference:
    """The residual of one mesh: ``coords`` [nv, dim], ``cells`` [nc, dim +
    1], boundary ``facets`` [nf, dim] with ``tags``; ``dirichlet`` maps a
    tag to the velocity it prescribes (a function of the points [m, dim]
    and the time), later tags overriding earlier ones on shared nodes."""

    def __init__(self, coords, cells, facets, tags, dirichlet, device="cpu",
                 dtype=torch.float64, block=32768):
        self.dim = dim = coords.shape[1]
        self.device, self.dtype, self.block = device, dtype, block
        cells = np.asarray(cells, np.int64)
        self.nv = nv = coords.shape[0]
        pairs = np.sort(cells[:, np.array(EDGES[dim])], axis=2).reshape(-1, 2)
        edges, inv = np.unique(pairs, axis=0, return_inverse=True)
        self.cell_nodes = np.concatenate([cells, nv + inv.reshape(len(cells), -1)], 1)
        self.cells = cells
        self.nodes = np.concatenate([coords, coords[edges].mean(1)])  # P2 support points
        # Dirichlet nodes: each tagged facet's vertices and edge midpoints;
        # a later tag takes a node from an earlier one
        codes = edges[:, 0] * nv + edges[:, 1]  # sorted: np.unique's order
        fedges = np.array(EDGES[dim - 1] if dim == 3 else ((0, 1),))
        owner = np.full(self.nodes.shape[0], -1)
        for i, tag in enumerate(dirichlet):
            sel = np.asarray(facets, np.int64)[np.asarray(tags) == tag]
            fe = np.sort(sel[:, fedges], axis=2).reshape(-1, 2)
            mid = nv + np.searchsorted(codes, fe[:, 0] * nv + fe[:, 1])
            owner[np.concatenate([sel.ravel(), mid])] = i
        self.bc_nodes = np.nonzero(owner >= 0)[0]
        self.bc_tag = np.array(list(dirichlet))[owner[self.bc_nodes]]
        self.dirichlet = dirichlet
        pts, w = simplex_rule(dim)
        N, G, Np = p2_basis(dim, pts)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device, dtype=dtype)
        self.w, self.N, self.G, self.Np = t(w), t(N), t(G), t(Np)
        self._coords = t(coords)
        self._cell_nodes = torch.as_tensor(self.cell_nodes, device=device)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    def bc_values(self, t: float) -> np.ndarray:
        """[n_bc, dim] prescribed velocity at the Dirichlet nodes."""
        out = np.zeros((len(self.bc_nodes), self.dim))
        for tag, fn in self.dirichlet.items():
            m = self.bc_tag == tag
            if m.any():
                out[m] = fn(self.nodes[self.bc_nodes[m]], t)
        return out

    def _blocks(self):
        for lo in range(0, len(self.cells), self.block):
            cn = self._cell_nodes[lo : lo + self.block]
            X = self._coords[cn[:, : self.dim + 1]]  # [b, dim + 1, dim]
            J = (X[:, 1:] - X[:, :1]).transpose(1, 2)  # J[c, a, k] = d x_a / d xi_k
            iJ = torch.linalg.inv(J)  # d xi_k / d x_a
            W = torch.linalg.det(J).abs()[:, None] * self.w  # [b, nq]
            Gx = torch.einsum("nqk,cka->cnqa", self.G, iJ)  # physical P2 gradients
            yield cn, W, Gx

    def residual(self, u, p, u_old=None, u_old2=None, *, dt=1.0, nu, rho=1.0, order=1,
                 stokes=False):
        """(r_u [n_nodes, dim], r_p [nv]) at u [n_nodes, dim], p [nv]; BDF
        ``order`` 1 or 2 (u_old2 for 2), or the steady Stokes residual."""
        a0, a1, a2 = BDF[order]
        r_u = u.new_zeros(u.shape)
        r_p = p.new_zeros(p.shape)
        for cn, W, Gx in self._blocks():
            uc = u[cn]  # [b, nb, dim]
            pc = p[cn[:, : self.dim + 1]]
            u_q = torch.einsum("nq,cna->cqa", self.N, uc)
            gu = torch.einsum("cna,cnqb->cqab", uc, Gx)  # d u_a / d x_b
            p_q = torch.einsum("mq,cm->cq", self.Np, pc)
            src = torch.zeros_like(u_q)
            if not stokes:
                s = a0 * uc + a1 * u_old[cn] + (a2 * u_old2[cn] if a2 else 0.0)
                src = src - rho / dt * torch.einsum("nq,cna->cqa", self.N, s)
                src = src - rho * torch.einsum("cqb,cqab->cqa", u_q, gu)
            rc = (torch.einsum("cqa,nq,cq->cna", src, self.N, W)
                  - nu * rho * torch.einsum("cqab,cnqb,cq->cna", gu, Gx, W)
                  + torch.einsum("cq,cnqa,cq->cna", p_q, Gx, W))
            div = torch.einsum("cqaa->cq", gu)
            rpc = torch.einsum("cq,mq,cq->cm", div, self.Np, W)
            r_u.index_add_(0, cn.reshape(-1), rc.reshape(-1, self.dim))
            r_p.index_add_(0, cn[:, : self.dim + 1].reshape(-1), rpc.reshape(-1))
        return r_u, r_p

    def diagonal(self, *, dt, nu, rho=1.0, order=1, stokes=False):
        """[n_nodes] mass-over-dt (a0 rho / dt) plus viscous diagonal."""
        a0 = 0.0 if stokes else BDF[order][0]
        d = torch.zeros(self.n_nodes, device=self.device, dtype=self.dtype)
        for cn, W, Gx in self._blocks():
            m = torch.einsum("nq,cq->cn", self.N**2, W)
            k = torch.einsum("cnqa,cq->cn", Gx**2, W)
            d.index_add_(0, cn.reshape(-1), (a0 * rho / dt * m + nu * rho * k).reshape(-1))
        return d

    def norm(self, r_u, r_p, u, t, d) -> float:
        """2-norm of the residual with the Dirichlet rows d (g - u)."""
        g = torch.as_tensor(self.bc_values(t), device=self.device, dtype=self.dtype)
        bc = torch.as_tensor(self.bc_nodes, device=self.device)
        r_u = r_u.clone()
        r_u[bc] = d[bc, None] * (g - u[bc])
        return float(torch.sqrt((r_u**2).sum() + (r_p**2).sum()))


def match(ref_points: np.ndarray, points: np.ndarray, scale: float) -> np.ndarray:
    """perm with points[perm[i]] == ref_points[i] (to 1e-9 of ``scale``);
    raises ValueError where a point has no partner."""
    if len(ref_points) != len(points):
        raise ValueError(f"{len(points)} points against the reference's {len(ref_points)}")
    key = lambda x: np.round(np.asarray(x) / (1e-9 * scale)).astype(np.int64)
    a, b = key(ref_points), key(points)
    ia, ib = np.lexsort(a.T[::-1]), np.lexsort(b.T[::-1])
    if not np.array_equal(a[ia], b[ib]):
        raise ValueError("the program's support points differ from the reference's")
    perm = np.empty(len(a), np.int64)
    perm[ia] = ib
    return perm
