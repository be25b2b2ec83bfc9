"""navier_stokes_tpu_torch — the Navier-Stokes FEM framework on PyTorch + CUDA.

A port of ``navier_stokes_tpu`` (JAX on a TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper.  The JAX package stays the reference; each
module here sits at the same relative path as its counterpart there:

  mesh/      gmsh .msh reader, generators, uniform refinement (numpy,
             copied; the native meshkit parser built with g++ at first use)
  fem/       quadrature, P1/P2 elements, DoFs, BCs (numpy, copied); the
             flat and the windowed assembly (torch)
  ops/       transpose gather maps; the windowed operator: layout, plain
             torch versions, and the CUDA kernels of csrc/windowed.cu
  la/        element operators, FGMRES, CG, block preconditioners (torch)
  models/    NavierStokesSolver (flat and windowed, BDF1/BDF2, identity /
             block / Cahouet-Chabard preconditioners, Stokes initial
             guess), StokesSolver, flow functionals
  scripts/   the tensor-core probe (csrc/mxu_probe.cu)
  utils/     run logging, phase timers
  convert    state carried over from the JAX package's objects
  __main__   the command line: python -m navier_stokes_tpu_torch run|stokes|info

Importing the package pins float32 products to full precision, process-wide
(``allow_tf32`` off for matmuls and cuDNN, matmul precision "highest"), the
counterpart of the reference's ``Precision.HIGHEST``.
"""

import torch

from .config import SolverConfig
from .fem.assembly import FEMContext, assemble_navier_stokes, assemble_stokes, build_context
from .fem.dofs import make_dofs
from .mesh.generate import box, rectangle, unit_square
from .mesh.mesh import Mesh, refine_uniform
from .mesh.msh_io import read_msh
from .models.navier_stokes import NavierStokesSolver
from .models.stokes import StokesSolver
from .utils.logging import RunLog

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

__all__ = [
    "SolverConfig",
    "FEMContext",
    "assemble_navier_stokes",
    "assemble_stokes",
    "build_context",
    "make_dofs",
    "box",
    "rectangle",
    "unit_square",
    "Mesh",
    "refine_uniform",
    "read_msh",
    "NavierStokesSolver",
    "StokesSolver",
    "RunLog",
    "__version__",
]
