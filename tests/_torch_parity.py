"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

Each test builds its inputs from a seed with numpy, runs them through the
JAX package (on the CPU, float64 unless stated) and through its
counterpart in parelagmc_tpu_torch, and compares with a stated tolerance.
Tests that need a CUDA card take the `cuda_device` fixture, which skips
when there is none; the decision is made inside the fixture, never at
collection, so every pytest-xdist worker collects the same tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

# Several pytest-xdist workers share the host: keep each one's intra-op pool small.
torch.set_num_threads(2)

# The port's entry points run on cuda:0 unless asked otherwise; the CPU
# parity tests ask for the CPU through this constant.
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel against its plain version)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def to_np(x) -> np.ndarray:
    """numpy copy of a torch tensor or a jax array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rel_err(a, b) -> float:
    """max |a - b| / max |b| over all entries."""
    a, b = to_np(a).astype(np.float64), to_np(b).astype(np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def port_config(cfg):
    """The port's own config (parelagmc_tpu_torch.config) with the field
    values of a JAX-package config, nested configs recursed into: the tests
    build one config and hand each package its own class."""
    from parelagmc_tpu_torch import config as tconfig

    cls = getattr(tconfig, type(cfg).__name__)
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = port_config(v) if dataclasses.is_dataclass(v) else v
    return cls(**kw)


# -- unstructured meshes, generated (no mesh file needed) ------------------------

# Six tets around the main diagonal of a hex (corners numbered x fastest,
# then y, then z): the split conforms across neighbouring hexes.
TET_SPLIT = ((0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6), (0, 5, 1, 6))


def simplex_box_arrays(ncells, lengths=None):
    """(vertices, elements, boundary faces) of a box of `ncells` quads or
    hexes (the vertex grid of make_box_mesh), each quad cut in two
    triangles or each hex in six tets (TET_SPLIT); the boundary faces are
    the faces of one cell only."""
    from parelagmc_tpu_torch.mesh.factories import make_box_mesh

    d = len(ncells)
    axes = make_box_mesh(tuple(ncells), lengths=lengths).axes
    grids = np.meshgrid(*axes, indexing="ij")
    verts = np.stack([g.ravel(order="F") for g in grids], axis=1)
    n = [len(a) for a in axes]
    vid = lambda *ijk: int(np.ravel_multi_index(ijk, n, order="F"))
    elements = []
    if d == 2:
        for j in range(ncells[1]):
            for i in range(ncells[0]):
                elements.append([vid(i, j), vid(i + 1, j), vid(i + 1, j + 1)])
                elements.append([vid(i, j), vid(i + 1, j + 1), vid(i, j + 1)])
    else:
        for k in range(ncells[2]):
            for j in range(ncells[1]):
                for i in range(ncells[0]):
                    c = [vid(i, j, k), vid(i + 1, j, k), vid(i + 1, j + 1, k),
                         vid(i, j + 1, k), vid(i, j, k + 1), vid(i + 1, j, k + 1),
                         vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)]
                    elements.extend([[c[v] for v in t] for t in TET_SPLIT])
    elements = np.asarray(elements, dtype=np.int64)
    faces = np.concatenate([np.delete(elements, i, axis=1) for i in range(d + 1)])
    uniq, counts = np.unique(np.sort(faces, axis=1), axis=0, return_counts=True)
    return verts, elements, uniq[counts == 1]


def general_mesh(module, ncells, lengths=None, label=True, origin=None, material_box=None):
    """The GeneralMesh of `module` (the mfem_io module of either package)
    for simplex_box_arrays, moved to `origin`, boundary attributes set by
    that package's label_box_boundaries_gm (MFEM box sides) or all 1.
    With `material_box` (lo, hi) the cells whose centroid lies inside it
    get attribute 1 and the others 2 (an embedding mesh); else all are 1."""
    verts, elements, boundary = simplex_box_arrays(ncells, lengths)
    d = len(ncells)
    if origin is not None:
        verts = verts + np.asarray(origin, dtype=np.float64)
    attributes = np.ones(len(elements), dtype=np.int32)
    if material_box is not None:
        c = verts[elements].mean(axis=1)
        inside = np.all((c > material_box[0]) & (c < material_box[1]), axis=1)
        attributes = np.where(inside, 1, 2).astype(np.int32)
    gm = module.GeneralMesh(
        dim=d, vertices=verts, elements=list(elements),
        attributes=attributes,
        geom_types=np.full(len(elements), 2 if d == 2 else 4, dtype=np.int32),
        boundary=list(boundary), boundary_attributes=np.ones(len(boundary), dtype=np.int32))
    if label:
        if module.__name__.startswith("parelagmc_tpu_torch"):
            from parelagmc_tpu_torch.unstructured import label_box_boundaries_gm
        else:
            from parelagmc_tpu.unstructured import label_box_boundaries_gm
        assert label_box_boundaries_gm(gm)
    return gm


def write_mfem_v10(path, dim, vertices, elements, geom, boundary=(), bgeom=None,
                   attributes=None, battributes=None):
    """A small writer of MFEM mesh v1.0 text (for the reader's tests)."""
    lines = ["MFEM mesh v1.0", "", "# generated", "dimension", str(dim), "",
             "elements", str(len(elements))]
    attributes = np.ones(len(elements), int) if attributes is None else attributes
    lines += [f"{a} {geom} " + " ".join(map(str, e)) for a, e in zip(attributes, elements)]
    lines += ["", "boundary", str(len(boundary))]
    battributes = np.ones(len(boundary), int) if battributes is None else battributes
    lines += [f"{a} {bgeom} " + " ".join(map(str, b)) for a, b in zip(battributes, boundary)]
    lines += ["", "vertices", str(len(vertices)), str(vertices.shape[1])]
    lines += [" ".join(repr(float(x)) for x in v) for v in vertices]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_general_mesh(path, gm):
    """A simplicial GeneralMesh as an MFEM v1.0 file at `path`."""
    d = gm.dim
    return write_mfem_v10(path, d, gm.vertices, np.stack(gm.elements), 2 if d == 2 else 4,
                          np.stack(gm.boundary), 1 if d == 2 else 2,
                          attributes=gm.attributes, battributes=gm.boundary_attributes)


# -- spatial sharding cases, run stacked here and by gloo processes ----------------


def spatial_one_level(ncells, name="cg-schur", kinv_sigma=None, rtol=1e-9, seed=0,
                      **solver_kw):
    """(hierarchy, port DarcySolver) of one level on the unit box with the
    y boundaries essential, on the CPU in float64."""
    from parelagmc_tpu_torch.config import ProblemConfig
    from parelagmc_tpu_torch.fem.hierarchy import build_geometric_hierarchy_from_fine
    from parelagmc_tpu_torch.mesh.factories import make_box_mesh
    from parelagmc_tpu_torch.physics import DarcySolver

    cfg = ProblemConfig(mesh="box", ncells=ncells, lengths=(1.0, 1.0, 1.0), refinements=0,
                        dtype="float64", ess_attr=(0, 1, 1, 1, 1, 0))
    cfg.darcy_solver.name = name
    cfg.darcy_solver.relative_tolerance = rtol
    cfg.darcy_solver.max_iterations = 4000
    cfg.darcy_solver.local_schur_scaling = True
    for k, v in solver_kw.items():
        setattr(cfg.darcy_solver, k, v)
    kinv = None
    if kinv_sigma:
        kinv = np.exp(np.random.default_rng(seed).normal(size=(int(np.prod(ncells)), 3))
                      * kinv_sigma)
    hier = build_geometric_hierarchy_from_fine(
        make_box_mesh(ncells, spacings=[1.0 / n for n in ncells]), 1)
    return hier, DarcySolver(hier, cfg, torch.float64, device=CPU, kinv_ref=kinv)


def _spatial_fields(n_s, batch, seed, sigma=0.5):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.exp(rng.normal(size=(batch, n_s)) * sigma))


def darcy_sp2(rank):
    """n_sp = 2, in one process (rank None) or as `rank` of two
    torch.distributed processes: SpatialDarcy's Jacobi solve with the
    pressure and its adjoint-corrected solve, DarcySolver's routing through
    an MLMC round of the golden box refined once, and SpatialSolver on a
    tridiagonal CSR. Returns numpy arrays."""
    import scipy.sparse as sp

    from parelagmc_tpu_torch.config import ProblemConfig
    from parelagmc_tpu_torch.fem import build_geometric_hierarchy
    from parelagmc_tpu_torch.mesh import make_box_mesh
    from parelagmc_tpu_torch.parallel.spatial import SpatialSolver
    from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy
    from parelagmc_tpu_torch.physics import DarcySolver
    from parelagmc_tpu_torch.samplers.pde import SPDESampler
    from parelagmc_tpu_torch.uq import MLMCManager

    out = {}
    hier, solver = spatial_one_level((6, 14, 5), kinv_sigma=1.0)
    sd = SpatialDarcy.from_darcy(solver, 0, n_sp=2)
    assert sd.comm.distributed == (rank is not None)
    w = _spatial_fields(hier.levels[0].n_s, 4, 1)
    q, it, rel, conv, p = sd.solve_fwd(w, return_pressure=True)
    out.update(q=q, it=it, rel=rel, conv=conv, p=p)
    qa, ita, _, conva, pa, lam = sd.solve_fwd(w, adjoint=True, return_pressure=True)
    out.update(q_adj=qa, it_adj=ita, conv_adj=conva, p_adj=pa, lam=lam)

    cfg = ProblemConfig(refinements=1, mse=1e10, batch_size=8, initial_samples=8, seed=0,
                        output_filename="", cost_model="dofs")
    cfg.darcy_solver.relative_tolerance = 1e-9
    cfg.darcy_solver.max_iterations = 2000
    cfg.darcy_solver.spatial_shards = 2
    mh = build_geometric_hierarchy(make_box_mesh((4, 4, 4), lengths=(2.0, 2.0, 2.0)), 2)
    ds = DarcySolver(mh, cfg, torch.float64, device=CPU)
    mgr = MLMCManager(ds, SPDESampler(mh, cfg, torch.float64, device=CPU), cfg)
    mgr.init_run([8, 8])
    assert ds._spatial(0).comm.distributed == (rank is not None)
    out.update(mlmc_sums=mgr.sums, mlmc_estimate=np.asarray(mgr.estimate))

    n = 30
    A = sp.diags([np.full(n - 1, -0.5), 2.0 + np.arange(n) * 0.01, np.full(n - 1, -0.5)],
                 [-1, 0, 1]).tocsr()
    b = np.random.default_rng(2).normal(size=(3, n))
    x, its = SpatialSolver(A, np.arange(n, dtype=np.float64)[:, None], n_sp=2,
                           dtype=torch.float64, device=CPU).solve(b, rtol=1e-12)
    out.update(csr_x=x, csr_it=np.asarray(its))
    return {k: to_np(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


def darcy_dp2_sp2(rank):
    """(dp, sp) = (2, 2), in one process or as `rank` of four processes:
    the two-level slab coefMG (its global coarse level engaged: coarse
    cutoff 600), with the pressure."""
    from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy

    hier, solver = spatial_one_level((8, 16, 6), name="cg-schur-coefmg", kinv_sigma=1.0,
                                     coarse_dense_cutoff=600)
    sd = SpatialDarcy.from_darcy(solver, 0, n_sp=2, n_dp=2)
    assert sd.global_mg is not None and sd.comm.distributed == (rank is not None)
    w = _spatial_fields(hier.levels[0].n_s, 4, 3)
    q, it, rel, conv, p = sd.solve_fwd(w, return_pressure=True)
    return {k: to_np(v) for k, v in dict(q=q, it=it, rel=rel, conv=conv, p=p).items()}


# -- the example drivers against their twins ----------------------------------


class StepClock:
    """Stands in for a driver module's `time`: each perf_counter() call is
    one second later than the one before."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t


def drivers(monkeypatch, name):
    """(JAX driver module examples.<name>, its twin in
    parelagmc_tpu_torch.examples), each with a StepClock."""
    import importlib

    jmod = importlib.import_module(f"examples.{name}")
    tmod = importlib.import_module(f"parelagmc_tpu_torch.examples.{name}")
    for mod in (jmod, tmod):
        if hasattr(mod, "time"):
            monkeypatch.setattr(mod, "time", StepClock())
    return jmod, tmod


def close_iterations(a, b):
    """Iteration counts (or means of them) within 2 or 2 %."""
    return abs(a - b) <= max(2.0, 0.02 * max(abs(a), abs(b)))
