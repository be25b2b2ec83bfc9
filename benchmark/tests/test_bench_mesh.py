"""The DFG mesh generator: measure, circle, orientation, conformity, tags."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.meshes import dfg_ogrid

HERE = Path(__file__).resolve().parent.parent
TAGS = {"inlet": 1, "outlet": 2, "walls": 3, "cylinder": 4}
RECIPES = {
    "2d": dict(L=2.2, H=0.41, cx=0.2, cy=0.2, r=0.05, n_side=6, n_radial=5, n_down=20),
    "3d": dict(L=2.5, H=0.41, cx=0.5, cy=0.2, r=0.05, n_side=4, n_radial=3, n_up=3, n_down=12,
               n_z=3),
    "2d-cell": None,  # the 2D configuration's own recipe
}


def recipe(name):
    if RECIPES[name] is None:
        cfg = json.loads((HERE / "configs" / "dfg2d-p2p1.json").read_text())
        return dict(cfg["geometry"], **cfg["mesh"])
    return dict(RECIPES[name], tags=TAGS)


def facets_of(cells, dim):
    """Every cell facet as a sorted vertex tuple array [nc * (dim + 1), dim]."""
    k = dim + 1
    drop = [[j for j in range(k) if j != i] for i in range(k)]
    return np.sort(cells[:, drop].reshape(-1, dim), axis=1)


@pytest.fixture(params=list(RECIPES), scope="module")
def mesh(request):
    rec = recipe(request.param)
    return rec, dfg_ogrid.build(rec)


def test_measure_is_channel_less_polygon(mesh):
    rec, m = mesh
    x, c = m["coords"], m["cells"]
    dim = x.shape[1]
    J = x[c[:, 1:]] - x[c[:, :1]]
    det = np.linalg.det(J)
    assert det.min() > 0  # positively oriented, none degenerate
    measure = det.sum() / (2 if dim == 2 else 6)
    # the cylinder's section is the polygon of its circle nodes
    circ = x[np.unique(m["facets"][m["tags"] == TAGS["cylinder"]])]
    circ = circ[circ[:, 2] == 0.0][:, :2] if dim == 3 else circ
    ang = np.sort(np.arctan2(circ[:, 1] - rec["cy"], circ[:, 0] - rec["cx"]))
    dth = np.diff(np.concatenate([ang, ang[:1] + 2 * np.pi]))
    polygon = 0.5 * rec["r"] ** 2 * np.sin(dth).sum()
    area = rec["L"] * rec["H"] - polygon
    expect = area * (rec["H"] if dim == 3 else 1.0)
    assert measure == pytest.approx(expect, rel=1e-12)
    # and the polygon is within its own error of the disc
    assert 0 < np.pi * rec["r"] ** 2 - polygon < rec["r"] ** 2 * np.sum(dth**3) / 12 + 1e-15


def test_cylinder_nodes_on_circle(mesh):
    rec, m = mesh
    x = m["coords"][np.unique(m["facets"][m["tags"] == TAGS["cylinder"]])]
    d = np.hypot(x[:, 0] - rec["cx"], x[:, 1] - rec["cy"])
    assert np.abs(d - rec["r"]).max() < 1e-15


def test_conforming_and_tagged(mesh):
    rec, m = mesh
    dim = m["coords"].shape[1]
    f = facets_of(m["cells"], dim)
    uniq, count = np.unique(f, axis=0, return_counts=True)
    assert count.max() == 2  # no facet in three cells
    boundary = uniq[count == 1]
    tagged = np.sort(m["facets"], axis=1)
    # every boundary facet is tagged, once, and no tagged facet is interior
    assert len(np.unique(tagged, axis=0)) == len(tagged)
    assert np.array_equal(np.unique(tagged, axis=0), boundary)
    assert set(np.unique(m["tags"])) == set(TAGS.values())


def test_tags_lie_where_they_say(mesh):
    rec, m = mesh
    x = m["coords"]
    for kind, tag in TAGS.items():
        p = x[m["facets"][m["tags"] == tag]].reshape(-1, x.shape[1])
        if kind == "inlet":
            assert np.all(p[:, 0] == 0.0)
        elif kind == "outlet":
            assert np.allclose(p[:, 0], rec["L"], rtol=0, atol=1e-14)
        elif kind == "walls":
            on = (p[:, 1] == 0) | np.isclose(p[:, 1], rec["H"], rtol=0, atol=1e-14)
            if x.shape[1] == 3:
                on |= (p[:, 2] == 0) | np.isclose(p[:, 2], rec["H"], rtol=0, atol=1e-14)
            assert on.all()
        else:
            d = np.hypot(p[:, 0] - rec["cx"], p[:, 1] - rec["cy"])
            assert np.abs(d - rec["r"]).max() < 1e-15
