"""HDF5 + XDMF visualization output (ParaView-compatible).

Port of ``navier_stokes_tpu/io/xdmf.py``, the same files dataset by
dataset: the replacement for the reference's ``output()``
(``src/NavierStokesSolver.cpp:681-728``): per-step files ``output-NNNN.h5``
+ ``output-NNNN.xdmf`` carrying the velocity vector field, scalar pressure,
and the per-cell ``partitioning`` id (cpp:702-705), with the simulation
time stamped into the XDMF entry (cpp:723-724).

deal.II's ``build_patches()`` at default subdivision writes vertex data only;
equivalently the writer down-samples Taylor-Hood to mesh vertices (the
first n_nodes scalar velocity DoFs / all P1 pressure DoFs).  The solution
may be a numpy array or a torch tensor on any device: it is copied to the
host and written with h5py.  The writer asks for h5py when it is made, so
a run that cannot write fails before it solves anything.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import h5py as _h5py

__all__ = ["XdmfWriter"]

_TOPOLOGY = {2: "Triangle", 3: "Tetrahedron"}


class XdmfWriter:
    def __init__(self, dofs, output_dir: str = ".", prefix: str = "output", partitioning=None):
        self.dofs = dofs
        self.dir = output_dir
        self.prefix = prefix
        self.entries = []  # (step, time, h5name)
        mesh = dofs.mesh
        self._nodes = np.ascontiguousarray(mesh.coords)
        self._cells = np.ascontiguousarray(mesh.cells)
        if partitioning is None:
            partitioning = np.zeros(mesh.n_cells, dtype=np.float64)
        self._partitioning = np.asarray(partitioning, dtype=np.float64)
        _h5py()  # fail here, before a solve, where h5py is missing
        os.makedirs(output_dir, exist_ok=True)

    # -- reference-compatible per-step write (cpp:709-727) -------------------

    def write(self, step: int, t: float, solution):
        h5py = _h5py()
        dofs = self.dofs
        mesh = dofs.mesh
        dim = mesh.dim
        if isinstance(solution, torch.Tensor):
            solution = solution.detach().cpu().numpy()
        sol = np.asarray(solution, dtype=np.float64)
        # vertex velocity/pressure via the dof maps (renumbering-safe)
        vv = dofs.vertex_vdofs
        vp = dofs.vertex_pdofs
        vel = np.zeros((mesh.n_nodes, 3))
        for c in range(dim):
            vel[:, c] = sol[c * dofs.n_vs + vv]
        pres = sol[dofs.n_u + vp]

        name = f"{self.prefix}-{step:04d}"
        h5name = name + ".h5"
        with h5py.File(os.path.join(self.dir, h5name), "w") as f:
            f.create_dataset("nodes", data=self._nodes)
            f.create_dataset("cells", data=self._cells.astype(np.uint32))
            f.create_dataset("velocity", data=vel)
            f.create_dataset("pressure", data=pres.reshape(-1, 1))
            f.create_dataset("partitioning", data=self._partitioning.reshape(-1, 1))

        self.entries.append((step, float(t), h5name))
        with open(os.path.join(self.dir, name + ".xdmf"), "w") as f:
            f.write(self._xdmf_document([self.entries[-1]]))
        return h5name

    def write_series(self, filename: str | None = None):
        """One XDMF indexing the whole time series (ParaView time animation)."""
        filename = filename or f"{self.prefix}-series.xdmf"
        with open(os.path.join(self.dir, filename), "w") as f:
            f.write(self._xdmf_document(self.entries))
        return filename

    # -- XDMF text ----------------------------------------------------------

    def _xdmf_document(self, entries) -> str:
        mesh = self.dofs.mesh
        dim = mesh.dim
        nn, nc = mesh.n_nodes, mesh.n_cells
        topo = _TOPOLOGY[dim]
        grids = []
        for _, t, h5 in entries:
            grids.append(
                f"""    <Grid Name=\"mesh\" GridType=\"Uniform\">
      <Time Value=\"{t}\"/>
      <Geometry GeometryType=\"{'XY' if dim == 2 else 'XYZ'}\">
        <DataItem Dimensions=\"{nn} {dim}\" NumberType=\"Float\" Precision=\"8\" Format=\"HDF\">{h5}:/nodes</DataItem>
      </Geometry>
      <Topology TopologyType=\"{topo}\" NumberOfElements=\"{nc}\">
        <DataItem Dimensions=\"{nc} {dim + 1}\" NumberType=\"UInt\" Format=\"HDF\">{h5}:/cells</DataItem>
      </Topology>
      <Attribute Name=\"velocity\" AttributeType=\"Vector\" Center=\"Node\">
        <DataItem Dimensions=\"{nn} 3\" NumberType=\"Float\" Precision=\"8\" Format=\"HDF\">{h5}:/velocity</DataItem>
      </Attribute>
      <Attribute Name=\"pressure\" AttributeType=\"Scalar\" Center=\"Node\">
        <DataItem Dimensions=\"{nn} 1\" NumberType=\"Float\" Precision=\"8\" Format=\"HDF\">{h5}:/pressure</DataItem>
      </Attribute>
      <Attribute Name=\"partitioning\" AttributeType=\"Scalar\" Center=\"Cell\">
        <DataItem Dimensions=\"{nc} 1\" NumberType=\"Float\" Precision=\"8\" Format=\"HDF\">{h5}:/partitioning</DataItem>
      </Attribute>
    </Grid>"""
            )
        body = "\n".join(grids)
        return f"""<?xml version=\"1.0\" ?>
<!DOCTYPE Xdmf SYSTEM \"Xdmf.dtd\" []>
<Xdmf Version=\"2.0\">
  <Domain>
   <Grid Name=\"TimeSeries\" GridType=\"Collection\" CollectionType=\"Temporal\">
{body}
   </Grid>
  </Domain>
</Xdmf>
"""
