"""The frozen byte count against kernel_bench.bound_bytes_of less the 2D
slot-colour table, for K1, the three K2 products, the K3 pair and K4, on
small 2D and 3D layouts."""

import pytest
import torch

from benchmark import bytes as B
from benchmark.meshes import dfg_ogrid
from navier_stokes_tpu_torch import Mesh, NavierStokesSolver, RunLog, SolverConfig
from navier_stokes_tpu_torch.ops import windowed as W
from navier_stokes_tpu_torch.scripts.kernel_bench import bound_bytes_of

TAGS = {"inlet": 1, "outlet": 2, "walls": 3, "cylinder": 4}
RECIPES = {
    2: dict(L=2.2, H=0.41, cx=0.2, cy=0.2, r=0.05, n_side=8, n_radial=6, n_down=30),
    3: dict(L=2.5, H=0.41, cx=0.5, cy=0.2, r=0.05, n_side=4, n_radial=3, n_up=3, n_down=12,
            n_z=3),
}


@pytest.fixture(params=[2, 3], scope="module")
def lay(request):
    m = dfg_ogrid.build(dict(RECIPES[request.param], tags=TAGS))
    cfg = SolverConfig(inlet_tags=(1,), wall_tags=(3, 4), neumann_tags=(2,), dtype="float32")
    cfg.krylov.matvec = "windowed"
    cfg.krylov.cells_per_block = 64
    s = NavierStokesSolver(Mesh(m["coords"], m["cells"], m["facets"], m["tags"]), cfg,
                           log=RunLog(verbose=False), device="cpu")
    s.setup()
    assert s._win_layout is not None
    return s._win_layout


@pytest.mark.parametrize("bf16", [False, True])
def test_counts_match_bound_bytes(lay, bf16):
    elt = torch.bfloat16 if bf16 else torch.float32
    blocks = {k: (torch.empty(1, dtype=elt), None) for k in ("v->v", "v->p", "p->p")}
    bound = bound_bytes_of(lay, {"blocks": blocks})
    c = B.layout_counts(lay)
    compact = W.compact_layout(lay) if lay.dim == 2 else True
    colours = 0 if compact else c["n_occ"]
    size = 2 if bf16 else 4
    mine = {"K1 f32": B.matvec_bytes(c, "vp", "vp", 4), "K1": B.matvec_bytes(c, "vp", "vp", 2),
            "K3 pair": B.gather_pair_bytes(c), "K4": B.scatter_bytes(c)}
    for key in blocks:
        i, o = key.split("->")
        mine[f"K2 {key}"] = B.matvec_bytes(c, i, o, size)
    for key, value in mine.items():
        less = 0 if key == "K3 pair" else colours
        assert value == bound[key] - less, key
