"""The port's sampler and unstructured evidence drivers (parelagmc_tpu_torch/
examples/spe10_sampler_performance.py, unstructured_performance.py) against
the JAX package's examples/ on the CPU, in process, from the same command
line and seed (the twins with --device cpu / --cpu). Compared: dofs, cells
and faces, the field moments (float32: 1e-4 relative), the level-0 QoI
oracle (float64: 1e-8), iteration counts (2 or 2 %) and converged
fractions. Timings are never compared; each driver module's `time` steps
one second a call, so both packages keep the first of their best-of rounds
(see tests/test_torch_evidence_spe10.py).

The unstructured comparison runs in float64: the JAX driver at its default
float32 stops in this process, whose jax runs with x64 (a while_loop carry
turns float64), and its --cpu update of jax's platform is a no-op here.
"""

import json

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (thread count)
from _torch_parity import close_iterations, drivers, general_mesh, write_general_mesh
from test_torch_evidence_spe10 import ERR_ATOL, Q_RTOL

F32_RTOL = 1e-4
SAMPLER_ARGV = ["--grid", "8,16,8", "--refinements", "1", "--batch", "4", "--samples", "8"]
UNSTRUCTURED_ARGV = ["--refine", "1", "--levels", "2", "--batch", "4", "--samples", "8",
                     "--compare", "--cpu", "--dtype", "float64"]


def test_spe10_sampler_performance_matches_the_original(tmp_path, monkeypatch):
    jmod, tmod = drivers(monkeypatch, "spe10_sampler_performance")
    ref = jmod.main(SAMPLER_ARGV + ["--out", str(tmp_path / "ref.json")])
    ev = tmod.main(SAMPLER_ARGV + ["--out", str(tmp_path / "ev.json"), "--device", "cpu"])
    assert json.loads((tmp_path / "ev.json").read_text()) == json.loads(json.dumps(ev))
    assert ev["device"] == "cpu" and ev["grid"] == ref["grid"]
    assert list(ev["variants"]) == list(ref["variants"]) == ["plain", "matching", "projection"]
    for variant, rows in ev["variants"].items():
        rrows = ref["variants"][variant]
        assert len(rows) == len(rrows) == 2
        for row, rrow in zip(rows, rrows):
            for k in ("level", "solve_dofs", "field_dofs", "batch"):
                assert row[k] == rrow[k], (variant, k)
            for k in ("field_mean", "field_std"):
                np.testing.assert_allclose(row[k], rrow[k], rtol=F32_RTOL, atol=0)
            assert "hbm_bytes" not in row  # the CPU has no device allocator peak
            timed = {"sample_eval"} | ({"embed_eval"} if variant != "plain" else set()) | (
                {"projector_apply"} if variant == "projection" else set())
            assert timed <= set(row) and all(row[t]["samples_per_sec"] > 0 for t in timed)
        # The embedded grids solve on more cells than the field has.
        assert (rows[0]["solve_dofs"] > rows[0]["field_dofs"]) is (variant != "plain")


def _cube_file(tmp_path):
    """The six-tet unit cube as an MFEM file (the reference's cube_tet.mesh
    has its shape; it is not in the repository)."""
    from parelagmc_tpu_torch.mesh import mfem_io

    return write_general_mesh(tmp_path / "cube_tet.mesh", general_mesh(mfem_io, (1, 1, 1)))


def test_unstructured_performance_matches_the_original(tmp_path, monkeypatch):
    jmod, tmod = drivers(monkeypatch, "unstructured_performance")
    argv = ["--mesh", _cube_file(tmp_path)] + UNSTRUCTURED_ARGV
    ref = jmod.main(argv + ["--out", str(tmp_path / "ref.json")])
    ev = tmod.main(argv + ["--out", str(tmp_path / "ev.json")])
    assert json.loads((tmp_path / "ev.json").read_text()) == json.loads(json.dumps(ev))
    assert ev["device"] == "cpu"
    assert ev["cells"] == ref["cells"] == [48, 7]
    assert ev["faces"] == ref["faces"]
    for k in ("q_device", "q_scipy"):
        np.testing.assert_allclose(ev["qoi_oracle"][k], ref["qoi_oracle"][k], rtol=Q_RTOL, atol=0)
    assert abs(ev["qoi_oracle"]["rel_err"] - ref["qoi_oracle"]["rel_err"]) <= ERR_ATOL
    assert ev["qoi_oracle"]["rel_err"] <= 1e-4  # rtol 1e-5 solve against the direct one
    rows = [r["pair"] for r in ev["levels"]] + list(ev["variants"].values())
    rrows = [r["pair"] for r in ref["levels"]] + list(ref["variants"].values())
    assert list(ev["variants"]) == list(ref["variants"]) == ["minres-bj", "minres-coefmg",
                                                             "hybrid-cg"]
    for row, rrow in zip(rows, rrows):
        assert row["converged_fraction"] == rrow["converged_fraction"] == 1.0
        assert close_iterations(row["mean_iterations"], rrow["mean_iterations"]), (row, rrow)
    for r, rr in zip(ev["levels"], ref["levels"]):
        assert r["darcy_dofs"] == rr["darcy_dofs"] and r["scipy_sec_per_sample_1core"] > 0
    assert set(ev["profile_level0"]) == set(ref["profile_level0"])


@pytest.mark.parametrize("bad", ["float16", "bfloat16"])
def test_unstructured_performance_refuses_unported_dtypes(bad, tmp_path):
    """The solver path runs in float32 or float64: another --dtype raises
    before the mesh is read."""
    from parelagmc_tpu_torch.examples import unstructured_performance

    with pytest.raises(NotImplementedError, match="not supported"):
        unstructured_performance.main(["--mesh", str(tmp_path / "none.mesh"), "--cpu",
                                       "--dtype", bad])


def _cube_problem(tmp_path):
    """The twin's hierarchy (the cube file refined once, two agglomerated
    levels) and its float64 solver on the CPU."""
    import torch

    from parelagmc_tpu_torch.config import ProblemConfig
    from parelagmc_tpu_torch.fem.agglomeration import build_agglomerated_hierarchy
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import refine_simplicial
    from parelagmc_tpu_torch.mesh.mfem_io import read_mfem_mesh
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver, label_box_boundaries_gm

    gm = read_mfem_mesh(_cube_file(tmp_path))
    label_box_boundaries_gm(gm)
    gm, _ = refine_simplicial(gm)
    hier = build_agglomerated_hierarchy(gm, 2, coarsening_factor=8)
    cfg = ProblemConfig(refinements=1, batch_size=2, dtype="float64")
    return hier, UnstructuredDarcySolver(hier, cfg, torch.float64, torch.device("cpu"))


@pytest.mark.parametrize("what,factorizations", [("main", 10), ("baseline-pair", 6),
                                                 ("baseline-coarsest", 3)])
def test_unstructured_scipy_factorizations(what, factorizations, tmp_path, monkeypatch):
    """The scipy baseline keeps the original's three rounds: a round factors
    the level pair's two saddle systems, or the coarsest level's one; main
    on two levels adds the oracle's one (1 + 3 * (2 + 1))."""
    from parelagmc_tpu_torch.examples import unstructured_performance as tmod

    calls = []
    real = tmod.spla.splu
    monkeypatch.setattr(tmod.spla, "splu", lambda A: calls.append(A.shape) or real(A))
    if what == "main":
        ev = tmod.main(["--mesh", _cube_file(tmp_path), "--refine", "1", "--levels", "2",
                        "--batch", "2", "--samples", "2", "--cpu", "--dtype", "float64",
                        "--out", str(tmp_path / "ev.json")])
        assert all(r["scipy_sec_per_sample_1core"] > 0 and r["vs_scipy_1core"] > 0
                   for r in ev["levels"])
        assert ev["qoi_oracle"]["rel_err"] <= 1e-4
    else:
        hier, solver = _cube_problem(tmp_path)
        level = 0 if what == "baseline-pair" else hier.nlevels - 1
        assert tmod.scipy_pair_baseline(hier, solver, level) > 0
        sizes = {solver.num_dofs(level)} | ({solver.num_dofs(1)} if level == 0 else set())
        assert {n for n, _ in calls} == sizes
    assert len(calls) == factorizations


def test_unstructured_oracle_system(tmp_path):
    """The oracle is its system's direct solve: oracle_system's saddle
    matrix for the field, solved by scipy's spsolve, gives scipy_qoi_oracle's
    QoI."""
    import scipy.sparse.linalg as spla

    from parelagmc_tpu_torch.examples import unstructured_performance as tmod

    hier, solver = _cube_problem(tmp_path)
    w = np.exp(0.5 * np.random.default_rng(7).normal(size=hier.levels[0].n_s))
    A, b, obs = tmod.oracle_system(hier, solver, 0, w)
    assert A.shape == (solver.num_dofs(0),) * 2 and b.shape == obs.shape == (A.shape[0],)
    q = tmod.scipy_qoi_oracle(hier, solver, 0, w)
    np.testing.assert_allclose(q, spla.spsolve(A.tocsc(), b) @ obs, rtol=1e-10)
    assert tmod.oracle_solve(A, b, obs) == q
