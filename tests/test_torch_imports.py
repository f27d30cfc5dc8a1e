"""The port stands without jax and without the JAX package: it imports
neither, keeps its own copy of the host code it needs (held here to the
originals), builds nothing at import, runs on the card unless asked for the
CPU, and refuses what it has not ported instead of running something else."""

import ast
import dataclasses
import inspect
import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (thread count)
import parelagmc_tpu_torch
from _torch_parity import CPU, port_config
from parelagmc_tpu import config as jconfig
from parelagmc_tpu.fem import assembly as jassembly
from parelagmc_tpu.fem import galerkin_mass as jgalerkin
from parelagmc_tpu.fem import hierarchy as jhierarchy
from parelagmc_tpu.mesh import factories as jfactories
from parelagmc_tpu.mesh import structured as jstructured
from parelagmc_tpu.utils import regression as jregression
from parelagmc_tpu.utils import special as jspecial
from parelagmc_tpu_torch import config as tconfig
from parelagmc_tpu_torch import device as tdevice
from parelagmc_tpu_torch.device import resolve_device, torch_dtype
from parelagmc_tpu_torch.fem import assembly as tassembly
from parelagmc_tpu_torch.fem import galerkin_mass as tgalerkin
from parelagmc_tpu_torch.fem import hierarchy as thierarchy
from parelagmc_tpu_torch.mesh import factories as tfactories
from parelagmc_tpu_torch.mesh import structured as tstructured
from parelagmc_tpu_torch.problems import build_problem
from parelagmc_tpu_torch.utils import regression as tregression
from parelagmc_tpu_torch.utils import special as tspecial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "parelagmc_tpu_torch")
MODULES = ["parelagmc_tpu_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(parelagmc_tpu_torch.__path__, "parelagmc_tpu_torch."))
# The command-line drivers of the port (parelagmc_tpu_torch/examples/).
EXAMPLES = ("mlmc", "slmc", "mlmc_manual", "ratio_estimator_mc", "ratio_estimator_mlmc",
            "likelihood_example", "compute_reference_obs_data", "spe10_mlmc", "spe10_ratio_mlmc",
            "darcy_test", "darcy_random_input", "sampler_test", "realization_test",
            "sampler_performance", "spatial_scaling", *(
                "spe10_level0_breakdown", "spe10_struct_profile", "spe10_vcycle_profile",
                "spe10_iter_cost", "spe10_level1_cost", "spe10_layout_probe"), *(
                "spe10_performance", "spe10_adjoint_check", "spe10_beta_noise",
                "spe10_mg_tuning", "spe10_rate_diagnostics", "spe10_sampler_performance",
                "unstructured_performance"))
# The evidence and tuning drivers among them (twins of examples/*.py whose
# JSON files the JAX package's evidence rests on), and the SPE10 layer probes.
EVIDENCE = EXAMPLES[-7:]
PROBES = EXAMPLES[-13:-7]
# Program files of the port outside the package.
SCRIPTS = ("chip_smoke.py", "profile_pair_step.py")


def test_port_imports_leave_jax_out():
    """Every module of the port, imported in a fresh interpreter, loads
    neither jax nor any module of the JAX package parelagmc_tpu."""
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(any(k == 'jax' or k.startswith('jax.') for k in sys.modules),\n"
        "      any(k == 'parelagmc_tpu' or k.startswith('parelagmc_tpu.') for k in sys.modules),\n"
        "      sys.modules['parelagmc_tpu_torch.native']._LIB is None,\n"
        "      sys.modules['parelagmc_tpu_torch.kernels']._LIB is None)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    # Neither jax nor the JAX package; no library (CUDA or g++) loaded at import.
    assert out.stdout.split() == ["False", "False", "True", "True"]
    assert len(MODULES) > 25 and "parelagmc_tpu_torch.fem.galerkin_mass" in MODULES
    for name in ("ops.ell", "samplers.covariance", "samplers.kl", "uq.bayes", "uq.ratio_managers",
                 "ops.multigrid", "ops.coef_multigrid", "fem.agglomeration", "parallel.sharding",
                 "mesh.mfem_io", "fem.simplicial", "fem.simplicial_hierarchy", "unstructured",
                 "physics.hybrid", "native", "transfer_integrators", "utils.io_vtk",
                 "utils.reporting", "examples.common", "parallel.slabs", "parallel.spatial",
                 "parallel.spatial_darcy", "bench", "graft_entry",
                 *(f"examples.{d}" for d in EXAMPLES)):
        assert f"parelagmc_tpu_torch.{name}" in MODULES


def _program_sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    for f in SCRIPTS:
        yield os.path.join(REPO, f)


def test_spatial_modules_import_without_jax():
    """The spatial-sharding modules and their driver twin, imported alone in
    a fresh interpreter, load neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import parelagmc_tpu_torch.parallel.spatial_darcy, parelagmc_tpu_torch.parallel.spatial\n"
        "import parelagmc_tpu_torch.examples.spatial_scaling\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'parelagmc_tpu')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_bench_and_graft_entry_import_without_jax():
    """The twins of bench.py and __graft_entry__.py, imported alone in a
    fresh interpreter, load neither jax, nor the JAX package, nor the root
    modules whose twins they are."""
    code = (
        "import sys\n"
        "import parelagmc_tpu_torch.bench, parelagmc_tpu_torch.graft_entry\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'parelagmc_tpu', 'bench', '__graft_entry__')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_evidence_drivers_import_without_jax():
    """The seven evidence and tuning drivers and the six probes, imported
    alone in a fresh interpreter, load neither jax, nor the JAX package,
    nor the root examples package whose twins they are."""
    code = (
        "import importlib, sys\n"
        f"for d in {EVIDENCE + PROBES!r}:\n"
        "    importlib.import_module('parelagmc_tpu_torch.examples.' + d)\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'parelagmc_tpu', 'examples')))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    assert EVIDENCE[0] == "spe10_performance" and len(set(EVIDENCE)) == 7
    assert PROBES[0] == "spe10_level0_breakdown" and len(set(PROBES)) == 6


def test_no_root_examples_import_in_port_sources():
    """No `import examples` / `from examples...` (the JAX package's drivers)
    in the package, chip_smoke.py or profile_pair_step.py."""
    pat = re.compile(r"^\s*(import\s+examples\b|from\s+examples\b)", re.M)
    scanned = {os.path.relpath(p, REPO) for p in _program_sources()}
    assert {f"parelagmc_tpu_torch/examples/{d}.py" for d in EVIDENCE + PROBES} <= scanned
    for path in _program_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path
    assert pat.search("from examples import spe10_mlmc") and pat.search("import examples.x")
    assert not pat.search("from parelagmc_tpu_torch.examples import spe10_mlmc")


def test_no_jax_import_in_package_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    scanned = {os.path.relpath(p, REPO) for p in _program_sources()}
    assert {"parelagmc_tpu_torch/parallel/spatial.py", "parelagmc_tpu_torch/parallel/slabs.py",
            "parelagmc_tpu_torch/parallel/spatial_darcy.py",
            "parelagmc_tpu_torch/examples/spatial_scaling.py"} <= scanned
    for path in _program_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path


def test_no_jax_package_import_in_port_sources():
    """No `import parelagmc_tpu` / `from parelagmc_tpu...` in the package,
    chip_smoke.py or profile_pair_step.py (word-bounded, so the port's own
    name passes)."""
    pat = re.compile(r"^\s*(import\s+parelagmc_tpu\b(?!_torch)|from\s+parelagmc_tpu\b(?!_torch))",
                     re.M)
    for path in _program_sources():
        with open(path) as fh:
            assert not pat.search(fh.read()), path
    assert pat.search("from parelagmc_tpu.fem import x") and pat.search("import parelagmc_tpu")
    assert not pat.search("from parelagmc_tpu_torch.fem import x")


def test_kernel_sources_ship_with_the_package():
    from parelagmc_tpu_torch import kernels

    for name in kernels.SOURCES:
        assert os.path.isfile(os.path.join(kernels.CSRC_DIR, name))
        assert os.path.dirname(kernels.library_path(name)) == kernels.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS


def test_profile_split_names_every_kernel():
    """profile_pair_step.py's device split attributes every device function
    of the port's CUDA sources to its kernel: K1's Thomas and segment paths
    sum under one key."""
    import importlib.util
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    spec = importlib.util.spec_from_file_location("profile_pair_step",
                                                  os.path.join(REPO, "profile_pair_step.py"))
    prof = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(prof)
    csrc = os.path.join(PKG, "csrc")
    names = []
    for f in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, f)) as fh:
            names += re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)",
                                fh.read())
    assert {"line_solve_kernel", "segment_solve_kernel", "threefry_kernel"} <= set(names)
    for name in names:
        assert sum(tag in name for tag, _ in prof.KERNEL_TAGS) == 1, name

    def kernel(key, us):
        return SimpleNamespace(device_type=DeviceType.CUDA, key=key, is_user_annotation=False,
                               self_device_time_total=us)

    ka = [kernel("void (anonymous namespace)::line_solve_kernel<float>(...)", 300.0),
          kernel("void (anonymous namespace)::segment_solve_kernel<float>(...)", 100.0),
          kernel("void threefry_kernel<float>(...)", 50.0),
          SimpleNamespace(device_type=DeviceType.CPU, key="aten::mul", is_user_annotation=False,
                          self_device_time_total=200.0)]
    assert prof.device_split(ka, 2) == {"K1 thomas": 0.2, "aten::mul": 0.1,
                                        "K2/K3 threefry": 0.025}


def test_device_and_dtype_helpers():
    assert torch_dtype("float32") is torch.float32
    assert torch_dtype(torch.float64) is torch.float64
    with pytest.raises(NotImplementedError):
        torch_dtype("bfloat16")
    assert resolve_device("cpu") == CPU
    if torch.cuda.is_available():
        assert resolve_device(None) == torch.device("cuda", 0)
    else:
        # The card is the default; without one nothing falls back to the CPU.
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                resolve_device(dev)



def test_device_report_helpers(monkeypatch):
    """device_info names a card by nvidia-smi's "name, power limit" line for
    that card's index (and the CPU as "cpu"); synchronize waits only on a
    card."""
    from types import SimpleNamespace

    assert tdevice.device_info(CPU) == "cpu"
    assert tdevice.synchronize(CPU) is None
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        rc = 0 if len(seen) == 1 else 6
        return SimpleNamespace(returncode=rc, stdout="NVIDIA H100 80GB HBM3, 700.00 W\n",
                               stderr="no card")

    monkeypatch.setattr(tdevice.subprocess, "run", run)
    card = torch.device("cuda", 3)
    assert tdevice.device_info(card) == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert seen[0][:3] == ["nvidia-smi", "--id=3", "--query-gpu=name,power.limit"]
    with pytest.raises(RuntimeError, match="nvidia-smi failed: no card"):
        tdevice.device_info(card)

def read_mfem_mesh_inline_tri(read_mfem_mesh):
    """A 2 x 2 triangulated square through the port's MFEM reader."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tri.mesh")
        with open(path, "w") as fh:
            fh.write("MFEM INLINE mesh v1.0\ntype = tri\nnx = 2\nny = 2\n")
        return read_mfem_mesh(path)


def test_entry_points_default_to_the_card():
    """Without a card every entry point with a `device` argument raises when
    it is not given one, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default runs there")
    from types import SimpleNamespace

    import scipy.sparse as sp

    from parelagmc_tpu_torch.convert import (
        coef_ell_from_jax,
        diag_coef_from_jax,
        ell_from_jax,
        tensor_eig_from_jax,
    )
    from parelagmc_tpu_torch.ops import prng
    from parelagmc_tpu_torch.ops.coef_multigrid import build_coef_mg, build_coef_mg_graph
    from parelagmc_tpu_torch.ops.ell import coef_diag_structure, pack_coef_ell, pack_csr_to_ell
    from parelagmc_tpu_torch.ops.multigrid import build_mg_hierarchy
    from parelagmc_tpu_torch.physics.darcy import _build_schur_mg
    from parelagmc_tpu_torch.ops.mass_solve import build_mass_tridiag_solver
    from parelagmc_tpu_torch.ops.tensorsolve import build_tensor_solver
    from parelagmc_tpu_torch.physics import DarcySolver
    from parelagmc_tpu_torch.samplers import (
        EmbeddedSPDESampler,
        L2ProjectionSPDESampler,
        SPDESampler,
    )
    from parelagmc_tpu_torch.samplers.covariance import MaternCovariance
    from parelagmc_tpu_torch.samplers.kl import KLSampler
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu_torch.mesh.mfem_io import read_mfem_mesh
    from parelagmc_tpu_torch.physics.hybrid import build_hybrid_level
    from parelagmc_tpu_torch.unstructured import (
        UnstructuredDarcySolver,
        UnstructuredEmbeddedSPDESampler,
        UnstructuredProjectionSPDESampler,
        UnstructuredSPDESampler,
    )
    from parelagmc_tpu_torch import bench, graft_entry
    from parelagmc_tpu_torch.examples.common import parse_args

    mesh = tfactories.make_box_mesh((2, 2, 2))
    lvl = tassembly.build_mixed_level(mesh)
    hier = thierarchy.build_geometric_hierarchy(mesh, 1)
    cfg = tconfig.ProblemConfig(refinements=0)
    eig = SimpleNamespace(V=[np.eye(2)], lam=np.ones(2), w_sqrt=np.ones(2), shape=(2,))
    tri = read_mfem_mesh_inline_tri(read_mfem_mesh)
    shier = build_simplicial_hierarchy(tri, 2)
    calls = [
        lambda: build_problem(cfg),
        lambda: parse_args([]),
        lambda: bench.main([]),
        lambda: bench.build(),
        lambda: graft_entry.build(),
        lambda: graft_entry.entry(),
        lambda: graft_entry.dryrun_multichip(2),
        lambda: graft_entry.spatial_problem(2),
        lambda: UnstructuredSPDESampler(shier, cfg),
        lambda: UnstructuredDarcySolver(shier, cfg),
        lambda: UnstructuredEmbeddedSPDESampler(
            shier, shier, [np.arange(l.n_s) for l in shier.levels], cfg),
        lambda: UnstructuredProjectionSPDESampler(shier, shier, cfg),
        lambda: build_hybrid_level(shier.levels[0], np.zeros(shier.levels[0].n_u, bool),
                                   np.zeros(shier.levels[0].n_u + shier.levels[0].n_s),
                                   np.zeros(shier.levels[0].n_u + shier.levels[0].n_s)),
        lambda: DarcySolver(hier, cfg),
        lambda: SPDESampler(hier, cfg),
        lambda: EmbeddedSPDESampler(hier, hier, cfg),
        lambda: L2ProjectionSPDESampler(hier, hier, cfg),
        lambda: KLSampler(hier, MaternCovariance(mesh, 0.3, 2), cfg),
        lambda: pack_csr_to_ell(sp.identity(2, format="csr")),
        lambda: ell_from_jax(SimpleNamespace(cols=np.zeros((2, 1), int), vals=np.ones((2, 1)))),
        lambda: tensor_eig_from_jax(eig),
        lambda: build_mass_tridiag_solver(lvl, np.zeros(lvl.n_u, bool)),
        lambda: build_tensor_solver(mesh, 1.0),
        lambda: pack_coef_ell(lvl.m_cols, lvl.m_vals, lvl.m_cells),
        lambda: coef_diag_structure(lvl.m_cols, lvl.m_vals, lvl.m_cells),
        lambda: coef_ell_from_jax(SimpleNamespace(cols=lvl.m_cols, mvals=lvl.m_vals,
                                                  cells=lvl.m_cells)),
        lambda: diag_coef_from_jax(SimpleNamespace(cells=lvl.m_cells, vals=lvl.m_vals)),
        lambda: build_mg_hierarchy([sp.identity(2, format="csr")], []),
        lambda: _build_schur_mg(mesh, np.ones((8, 3)), np.zeros(6, int), torch.float64, 100),
        lambda: build_coef_mg(mesh, np.zeros(lvl.n_u, bool)),
        lambda: build_coef_mg_graph(lvl.face_cells, lvl.face_signs, mesh.cell_centers()),
        lambda: prng.sample_normals(prng.PRNGKey(0), (2,)),
        lambda: prng.sample_uniforms(prng.PRNGKey(0), (2,)),
        lambda: prng.random_bits(prng.PRNGKey(0), 32, (2,)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.parametrize(
    "field,value,item",
    [("mesh", "cube.mesh", 15), ("dtype", "bfloat16", None),
     ("darcy_solver.spatial_shards", 2, 14), ("darcy_solver.name", "hybrid-cg", "15c")],
)
def test_build_problem_refuses_unported_configs(field, value, item):
    """What is not ported says it is not supported (bfloat16) instead of
    running something else. The cases of items 14, 15 and 15c, ported since,
    pin what replaced their refusal: spatial sharding builds through
    build_problem and solves like the unsharded solver, a mesh file that
    does not exist raises the reader's error, and the hybridized solver
    builds on a simplicial hierarchy and solves."""
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu_torch.mesh.mfem_io import read_mfem_mesh
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver

    cfg = tconfig.ProblemConfig(refinements=0)
    target = cfg
    *path, leaf = field.split(".")
    for name in path:
        target = getattr(target, name)
    setattr(target, leaf, value)
    if value == "cube.mesh":
        with pytest.raises(FileNotFoundError, match="cube.mesh"):
            build_problem(cfg, device=CPU)
        return
    if field == "darcy_solver.spatial_shards":
        cfg.dtype = "float64"
        cfg.darcy_solver.relative_tolerance = 1e-10
        prob = build_problem(cfg, device=CPU)
        ref = build_problem(dataclasses.replace(cfg, darcy_solver=dataclasses.replace(
            cfg.darcy_solver, spatial_shards=0)), device=CPU)
        w = torch.ones(2, prob.hierarchy.levels[0].n_s, dtype=torch.float64)
        q, _, info = prob.solver.solve_fwd(0, w)
        assert bool(info.converged.all()) and prob.solver._spatial(0).n_sp == value
        np.testing.assert_allclose(q.numpy(), ref.solver.solve_fwd(0, w)[0].numpy(), rtol=1e-8)
        return
    if value == "hybrid-cg":
        hier = build_simplicial_hierarchy(read_mfem_mesh_inline_tri(read_mfem_mesh), 2)
        cfg.dtype = "float64"
        solver = UnstructuredDarcySolver(hier, cfg, torch.float64, device=CPU)
        assert all(h is not None for h in solver._hybrid)
        q, _, info = solver.solve_fwd(0, torch.ones(2, hier.levels[0].n_s, dtype=torch.float64))
        assert bool(info.converged.all()) and torch.isfinite(q).all()
        return
    with pytest.raises(NotImplementedError, match=f"item {item}" if item else "not supported"):
        build_problem(cfg, device=CPU)


@pytest.mark.parametrize(
    "kw",
    [dict(embedding="matching"), dict(embedding="projection"), dict(sampler_name="analytic"),
     dict(sampler_name="matern"), dict(mesh="egg", embedding="projection")],
    ids=lambda kw: "-".join(kw.values()),
)
def test_build_problem_builds_every_structured_config(kw):
    """Every embedding, sampler and tensor-grid mesh of the structured
    build_problem builds; two sample shards on the CPU's one visible device
    raise ValueError, as the reference's config rule does."""
    from parelagmc_tpu_torch.uq import MLMCManager

    cfg = tconfig.ProblemConfig(refinements=1, dtype="float64", **kw)
    prob = build_problem(cfg, device=CPU)
    assert (prob.embed_hierarchy is not None) == ("embedding" in kw)
    assert prob.sampler.field_size(0) == prob.hierarchy.levels[0].n_s
    xi = prob.sampler.sample(1, (0, 1), 2)
    assert torch.isfinite(prob.sampler.eval(1, xi)).all()
    if kw.get("mesh") == "egg":
        assert prob.hierarchy.levels[0].mesh.shape == (60, 60, 7)
        assert prob.embed_hierarchy.levels[0].mesh.shape == (64, 64, 11)
        assert prob.embed_hierarchy.levels[1].mesh.shape == (32, 32, 5)
    cfg.sample_shards = 2
    with pytest.raises(ValueError, match="sample_shards=2"):
        MLMCManager(prob.solver, prob.sampler, cfg)


# -- the port's copy of the host code against the JAX package's ------------------


def test_problem_config_fields_match_the_jax_package():
    """A field added or changed on one side is caught here."""
    assert dataclasses.asdict(tconfig.ProblemConfig()) == dataclasses.asdict(
        jconfig.ProblemConfig())
    assert dataclasses.asdict(tconfig.SolverConfig()) == dataclasses.asdict(
        jconfig.SolverConfig())
    cfg = jconfig.ProblemConfig(refinements=3, ncells=(2, 3, 4), batch_size_per_level=[4, 8])
    cfg.darcy_solver.coefmg_line_axes = "zy"
    mine = port_config(cfg)
    assert type(mine) is tconfig.ProblemConfig
    assert type(mine.darcy_solver) is tconfig.SolverConfig
    assert dataclasses.asdict(mine) == dataclasses.asdict(cfg)
    assert mine.dim == cfg.dim and mine.nlevels == cfg.nlevels == 4


def _both_meshes(kind):
    """(JAX mesh, port mesh) of the same fine grid: the golden box or a
    16x32x8 SPE10-shaped grid with SPE10's spacings."""
    if kind == "golden":
        args = dict(ncells=(16, 16, 16), lengths=(2.0, 2.0, 2.0))
    else:
        args = dict(ncells=(16, 32, 8), spacings=tfactories.SPE10_SPACING)
    return jfactories.make_box_mesh(**args), tfactories.make_box_mesh(**args)


def _assert_same(a, b, what):
    if hasattr(a, "toarray"):
        a, b = a.tocsr(), b.tocsr()
        a.sort_indices()
        b.sort_indices()
        for f in ("indptr", "indices", "data"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=what)
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("kind", ["golden", "spe10"])
def test_host_copies_match_the_jax_package(kind):
    """The copied host builders reproduce the originals exactly: meshes,
    MixedLevel arrays, hierarchy parents and RT prolongators, the Galerkin
    block chain with its line weights, effective_kinv and the weighted
    prolongators."""
    jm, tm = _both_meshes(kind)
    assert jfactories.SPE10_NCELLS == tfactories.SPE10_NCELLS
    for a, b in zip(jm.axes, tm.axes):
        _assert_same(a, b, "axes")
    jh = jhierarchy.build_geometric_hierarchy_from_fine(jm, 3)
    th = thierarchy.build_geometric_hierarchy_from_fine(tm, 3)
    for l, (jl, tl) in enumerate(zip(jh.levels, th.levels)):
        assert isinstance(tl, tassembly.MixedLevel)
        for f in dataclasses.fields(jassembly.MixedLevel):
            if f.name != "mesh":
                _assert_same(getattr(jl, f.name), getattr(tl, f.name), f"level {l} {f.name}")
        _assert_same(jl.mesh.attributes, tl.mesh.attributes, f"level {l} attributes")
        ess = np.array([0, 1, 1, 1, 1, 0])
        _assert_same(jl.ess_faces(ess), tl.ess_faces(ess), f"level {l} ess")
        _assert_same(jl.mass_csr(), tl.mass_csr(), f"level {l} mass")
        _assert_same(jl.b_csr(), tl.b_csr(), f"level {l} divergence")
    for l in range(2):
        _assert_same(jh.parent[l], th.parent[l], f"parent {l}")
        _assert_same(jh.P_rt[l], th.P_rt[l], f"P_rt {l}")
        _assert_same(jh.p_l2(l), th.p_l2(l), f"p_l2 {l}")
    # Refinement from the coarse end builds the same levels.
    jr = jhierarchy.build_geometric_hierarchy(jh.levels[-1].mesh, 3)
    tr = thierarchy.build_geometric_hierarchy(th.levels[-1].mesh, 3)
    for jl, tl in zip(jr.levels, tr.levels):
        _assert_same(jl.cell_faces, tl.cell_faces, "refined cell_faces")
    kinv = np.exp(np.random.default_rng(1).normal(size=(tm.num_cells, 3)))
    meshes_j = [lvl.mesh for lvl in jh.levels]
    meshes_t = [lvl.mesh for lvl in th.levels]
    jchain, jw = jgalerkin.galerkin_block_chain(meshes_j, kinv)
    tchain, tw = tgalerkin.galerkin_block_chain(meshes_t, kinv)
    for l in range(3):
        for k in range(3):
            _assert_same(jchain[l][k], tchain[l][k], f"blocks {l}.{k}")
        _assert_same(jgalerkin.effective_kinv(meshes_j[l], jchain[l]),
                     tgalerkin.effective_kinv(meshes_t[l], tchain[l]), f"effective_kinv {l}")
    for l in range(2):
        for a in range(3):
            _assert_same(jw[l][a], tw[l][a], f"line weights {l}.{a}")
        _assert_same(jgalerkin.weighted_rt_prolongator(meshes_j[l], meshes_j[l + 1], jw[l]),
                     tgalerkin.weighted_rt_prolongator(meshes_t[l], meshes_t[l + 1], tw[l]),
                     f"weighted P_rt {l}")
        assert (thierarchy.axis_parent_map(meshes_t[l].axes[2], meshes_t[l + 1].axes[2])
                == jhierarchy.axis_parent_map(meshes_j[l].axes[2], meshes_j[l + 1].axes[2])).all()
    for a in range(3):
        _assert_same(jhierarchy.derefine_axis(jm.axes[a]), thierarchy.derefine_axis(tm.axes[a]),
                     "derefine_axis")
    for d in (2, 3):
        for a in range(d):
            for side in (0, 1):
                assert (tstructured._mfem_bdr_attr(d, a, side)
                        == jstructured._mfem_bdr_attr(d, a, side))


def test_scalar_helper_copies_match_the_jax_package():
    for corlen, d in ((0.1, 3), (100.0, 3), (0.3, 2)):
        assert tspecial.matern_spde_scaling(corlen, d) == jspecial.matern_spde_scaling(corlen, d)
    y = np.array([1.0, 0.4, 0.1, 0.02])
    x = np.array([64.0, 512.0, 4096.0, 32768.0])
    for skip in (0, 1, 3):
        assert (tregression.exp_weighted_regression(y, x, skip)
                == jregression.exp_weighted_regression(y, x, skip))


def _defs_without_docstrings(module):
    """{name: ast dump} of a module's top-level functions, classes and
    constants, docstrings dropped."""
    return _defs_of_tree(ast.parse(inspect.getsource(module)))


def _defs_of_tree(tree):
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            for sub in ast.walk(node):
                body = getattr(sub, "body", None)
                if (isinstance(sub, (ast.FunctionDef, ast.ClassDef)) and body
                        and isinstance(body[0], ast.Expr)
                        and isinstance(getattr(body[0], "value", None), ast.Constant)
                        and isinstance(body[0].value.value, str)):
                    sub.body = body[1:] or [ast.Pass()]
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[node.targets[0].id] = ast.dump(node)
    return out


@pytest.mark.parametrize(
    "name", ["minres-bj", "cg-schur-diag", "cg-schur-exact", "cg-schur", "cg-schur-coefmg"])
def test_build_problem_builds_every_darcy_solver(name):
    """Every Darcy solver name builds through build_problem with a kinv_ref
    (the gather coefMG and the stacked adjoint included) and solves a
    sample to convergence."""
    cfg = tconfig.ProblemConfig(ncells=(2, 3, 2), refinements=1, dtype="float64")
    cfg.darcy_solver.name = name
    cfg.darcy_solver.relative_tolerance = 1e-8
    cfg.darcy_solver.max_iterations = 2000
    if name == "cg-schur-coefmg":
        cfg.darcy_solver.coefmg_impl = "gather"
        cfg.darcy_solver.coarse_dense_cutoff = 10
    if name != "minres-bj":
        cfg.darcy_solver.adjoint_qoi = cfg.darcy_solver.adjoint_stacked = True
    kinv = np.exp(np.random.default_rng(0).normal(size=(4 * 6 * 4, 3)))
    prob = build_problem(cfg, kinv_ref=kinv, device=CPU)
    w = prob.sampler.eval(0, prob.sampler.sample(0, (0, 1), 2))
    q, _, info = prob.solver.solve_fwd(0, w)
    assert torch.isfinite(q).all() and bool(info.converged.all())
    L = prob.solver.levels[0]
    assert (L.m_op is not None) == (name == "minres-bj")
    assert (L.schur_mg is not None) == (name == "cg-schur")
    assert (L.sbar_dinv is not None) == (name == "cg-schur-diag")


def _host_defs(module, names):
    defs = _defs_without_docstrings(module)
    return {n: defs[n] for n in names}


def _class_methods(module, cls):
    """{name: ast dump} of the methods of `cls` in `module`, docstrings dropped."""
    node = next(n for n in ast.parse(inspect.getsource(module)).body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    tree = ast.Module(body=[m for m in node.body if isinstance(m, ast.FunctionDef)],
                      type_ignores=[])
    return _defs_of_tree(tree)


def test_copied_mixed_level_methods_match_the_jax_package():
    """Every method of the port's MixedLevel is the original's code,
    b_csr (the bench twin's scipy baseline) among them."""
    mine = _class_methods(tassembly, "MixedLevel")
    ref = _class_methods(jassembly, "MixedLevel")
    assert {"b_csr", "mass_csr", "ess_faces", "dim"} <= set(mine) <= set(ref)
    for name in mine:
        assert mine[name] == ref[name], f"MixedLevel.{name}"


def test_copied_host_code_of_the_new_modules_matches_the_jax_package():
    """The numpy/scipy host code the new modules carry is the original's,
    function for function: the partitioner, the Galerkin ELL values, the
    multigrid's damping and host Thomas, the gather tables' inversion."""
    from parelagmc_tpu.fem import agglomeration as jagg
    from parelagmc_tpu.ops import coef_multigrid as jcmg
    from parelagmc_tpu.ops import multigrid as jmg
    from parelagmc_tpu_torch.fem import agglomeration as tagg
    from parelagmc_tpu_torch.ops import coef_multigrid as tcmg
    from parelagmc_tpu_torch.ops import multigrid as tmg

    pairs = [(jagg, tagg, ("_morton_order", "partition_cells")),
             (jgalerkin, tgalerkin, ("blocks_to_ell_vals",)),
             (jmg, tmg, ("_spectral_omega", "_host_thomas")),
             (jcmg, tcmg, ("_invert_face_cells",))]
    for jm, tm, names in pairs:
        mine, ref = _host_defs(tm, names), _host_defs(jm, names)
        for n in names:
            assert mine[n] == ref[n], f"{tm.__name__}.{n}"
    jm, tm = _both_meshes("spe10")
    _assert_same(jm.face_axis(), tm.face_axis(), "face_axis")


def test_copied_host_modules_match_the_jax_package():
    """mesh/factories.py and samplers/covariance.py are copies (numpy/scipy
    only): every function, class and constant has the original's code, and
    the Bessel functions of utils/special.py too."""
    from parelagmc_tpu.samplers import covariance as jcovariance
    from parelagmc_tpu_torch.samplers import covariance as tcovariance

    for jm, tm in ((jfactories, tfactories), (jcovariance, tcovariance)):
        mine, ref = _defs_without_docstrings(tm), _defs_without_docstrings(jm)
        assert set(mine) == set(ref) and len(mine) >= 5
        for name in ref:
            assert mine[name] == ref[name], f"{tm.__name__}.{name}"
    mine, ref = _defs_without_docstrings(tspecial), _defs_without_docstrings(jspecial)
    for name in ("bessi1", "bessk1", "matern_spde_scaling"):
        assert mine[name] == ref[name]


def _defs_normalized(module, *replacements):
    """_defs_without_docstrings with imports inside functions dropped and
    the port's package name read as the JAX package's (the copies import
    their neighbours from their own package); each (old, new) of
    `replacements` is applied to the source first."""
    source = inspect.getsource(module)
    for old, new in replacements:
        source = source.replace(old, new)
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body:
            node.body = [b for b in body if not isinstance(b, (ast.Import, ast.ImportFrom))] or [
                ast.Pass()]
    return _defs_of_tree(ast.parse(ast.unparse(tree).replace("parelagmc_tpu_torch",
                                                             "parelagmc_tpu")))


def test_copied_unstructured_host_modules_match_the_jax_package():
    """mesh/mfem_io.py, fem/simplicial.py, fem/simplicial_hierarchy.py and
    fem/agglomeration.py are copies: every function, class and constant has
    the original's code. So do fem/assembly.pack_ell and the box labelling
    of unstructured.py."""
    from parelagmc_tpu import unstructured as jun
    from parelagmc_tpu.fem import agglomeration as jagg
    from parelagmc_tpu.fem import simplicial as jsimp
    from parelagmc_tpu.fem import simplicial_hierarchy as jsh
    from parelagmc_tpu.mesh import mfem_io as jmfem
    from parelagmc_tpu_torch import unstructured as tun
    from parelagmc_tpu_torch.fem import agglomeration as tagg
    from parelagmc_tpu_torch.fem import simplicial as tsimp
    from parelagmc_tpu_torch.fem import simplicial_hierarchy as tsh
    from parelagmc_tpu_torch.mesh import mfem_io as tmfem

    for jm, tm in ((jmfem, tmfem), (jsimp, tsimp), (jsh, tsh), (jagg, tagg)):
        mine, ref = _defs_normalized(tm), _defs_normalized(jm)
        assert set(mine) == set(ref) and len(mine) >= 3, tm.__name__
        for name in ref:
            assert mine[name] == ref[name], f"{tm.__name__}.{name}"
    pairs = [(jassembly, tassembly, ("pack_ell",)),
             (jun, tun, ("label_box_boundaries_gm", "label_box_boundaries", "_as_hierarchy",
                         "match_embedded_cells", "build_embedded_simplicial_hierarchies"))]
    for jm, tm, names in pairs:
        mine, ref = _defs_normalized(tm), _defs_normalized(jm)
        for n in names:
            assert mine[n] == ref[n], f"{tm.__name__}.{n}"


def test_copied_mesh_file_host_code_matches_the_jax_package():
    """transfer_integrators.py is a copy; native/ binds the same C entry
    points with the same marshalling, and its geometry.cc is the
    original's code (comments aside); the hybrid element mass is the
    original's."""
    from parelagmc_tpu import native as jnative
    from parelagmc_tpu import transfer_integrators as jti
    from parelagmc_tpu.physics import hybrid as jhybrid
    from parelagmc_tpu_torch import native as tnative
    from parelagmc_tpu_torch import transfer_integrators as tti
    from parelagmc_tpu_torch.physics import hybrid as thybrid

    mine, ref = _defs_normalized(tti), _defs_normalized(jti)
    assert set(mine) == set(ref) and len(mine) >= 6
    for name in ref:
        assert mine[name] == ref[name], f"transfer_integrators.{name}"
    mine, ref = _defs_normalized(tnative), _defs_normalized(jnative)
    for name in ("mesh_arrays", "_as_arrays", "mortar_p0_couple", "mortar_moments",
                 "detect_intersections_bruteforce", "element_measure"):
        assert mine[name] == ref[name], f"native.{name}"
    # _lib's body after the library is loaded: the types of every entry point.
    lib = lambda m: [ast.dump(n) for n in ast.parse(inspect.getsource(m._lib)).body[0].body[1]
                     .body[1:]]
    assert lib(tnative) == lib(jnative) and len(lib(tnative)) > 8

    def code(path):
        with open(path) as f:
            return [ln for ln in (l.split("//")[0].rstrip() for l in f) if ln]

    assert code(os.path.join(PKG, "native", "geometry.cc")) == code(
        os.path.join(REPO, "parelagmc_tpu", "native", "geometry.cc"))
    assert (_defs_normalized(thybrid)["element_outward_mass"]
            == _defs_normalized(jhybrid)["element_outward_mass"])


def test_copied_config_io_and_reporting_match_the_jax_package():
    """config.py (the XML ParameterList reader and from_parameterlist with
    the dataclasses) and utils/reporting.py are copies, definition for
    definition; utils/io_vtk.py too, its writers reading a field through
    `_host` (numpy, or a torch tensor on any device) where the original
    calls np.asarray."""
    from parelagmc_tpu.utils import io_vtk as jio
    from parelagmc_tpu.utils import reporting as jrep
    from parelagmc_tpu_torch.utils import io_vtk as tio
    from parelagmc_tpu_torch.utils import reporting as trep

    for jm, tm, n in ((jconfig, tconfig, 5), (jrep, trep, 6)):
        mine, ref = _defs_normalized(tm), _defs_normalized(jm)
        assert set(mine) == set(ref) and len(mine) == n, tm.__name__
        for name in ref:
            assert mine[name] == ref[name], f"{tm.__name__}.{name}"
    assert {"ParameterList", "_parse_value", "read_xml_parameterlist"} <= set(
        _defs_normalized(tconfig))
    mine = _defs_normalized(tio, ("= _host(field)", "= np.asarray(field)"))
    ref = _defs_normalized(jio)
    assert set(mine) - set(ref) == {"_host"} and len(ref) == 5
    for name in ref:
        assert mine[name] == ref[name], f"io_vtk.{name}"
