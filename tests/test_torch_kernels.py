"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports no jax, so it also runs on a machine with a card and no
jax: `python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`
(the repo's conftest configures jax and is skipped there). On a host
without a card the card tests skip through the `cuda_device` fixture; the
CPU tests here pin the wrappers' dispatch and the build's error path.
"""

import numpy as np
import pytest
import torch

from _torch_parity import CPU, cuda_device  # noqa: F401
from parelagmc_tpu_torch import kernels
from parelagmc_tpu_torch.fem import build_mixed_level
from parelagmc_tpu_torch.mesh import make_box_mesh
from parelagmc_tpu_torch.ops import prng
from parelagmc_tpu_torch.ops.mass_solve import build_mass_tridiag_solver
from parelagmc_tpu_torch.ops.tridiag_pallas import LineLayout, thomas, thomas_lines, thomas_plain


def _lines(n, L, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dl = torch.rand(n, L, generator=g, dtype=torch.float64) * 0.9 + 0.1
    du = torch.rand(n, L, generator=g, dtype=torch.float64) * 0.9 + 0.1
    d = dl + du + torch.rand(n, L, generator=g, dtype=torch.float64) + 0.5
    b = torch.randn(n, L, generator=g, dtype=torch.float64)
    return [t.to(device=device, dtype=dtype).contiguous() for t in (dl, d, du, b)]


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()


def test_cpu_tensors_take_the_plain_versions_uncounted():
    before = dict(kernels.launch_counts)
    dl, d, du, b = _lines(5, 7, torch.float64, "cpu")
    assert torch.equal(thomas(dl, d, du, b), thomas_plain(dl, d, du, b))
    prng.sample_normals(prng.PRNGKey(2), (3, 4), torch.float64, CPU)
    prng.sample_uniforms(prng.PRNGKey(2), (3, 4), torch.float32, CPU)
    assert kernels.launch_counts == before


def test_thomas_plain_bfloat16_runs_float32_and_rounds_once():
    """bf16 lines: the recurrence in float32, x rounded to bf16 at the end
    (what the kernel's bf16 instantiation does), so the result is the float32 solve of the
    bf16 tables, rounded."""
    dl, d, du, b = _lines(9, 11, torch.bfloat16, "cpu", seed=4)
    x = thomas(dl, d, du, b)
    assert x.dtype == torch.bfloat16
    ref = thomas_plain(*(t.float() for t in (dl, d, du, b))).to(torch.bfloat16)
    assert torch.equal(x, ref)


def test_full_precision_float32_matmul_is_the_default():
    """The tensor solve and restriction matmuls need full float32 (a
    truncated product gave a false Krylov floor on the TPU)."""
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n,L", [(17, 131072), (65, 4099), (1, 3), (221, 1000)])
def test_thomas_kernel_matches_plain(cuda_device, dtype, tol, n, L):
    dl, d, du, b = _lines(n, L, dtype, cuda_device, seed=n)
    n0 = kernels.launch_counts["thomas"]
    x = thomas(dl, d, du, b)
    assert kernels.launch_counts["thomas"] == n0 + 1
    ref = thomas_plain(dl, d, du, b)
    torch.cuda.synchronize()
    err = ((x - ref).abs().max() / ref.abs().max()).item()
    assert err <= tol, err


@pytest.mark.gpu
def test_thomas_kernel_rejects_non_contiguous(cuda_device):
    dl, d, du, b = _lines(4, 6, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        thomas(dl, d, du, b.t().contiguous().t())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_threefry_kernel_matches_plain(cuda_device, dtype, tol):
    key = prng.fold_in(prng.PRNGKey(3), 1)
    shape = (64, 4096 + 3)  # odd tail exercises the ragged last block
    for bw in (32, 64):
        got = prng.random_bits(key, bw, shape, cuda_device)
        ref = prng.random_bits_plain(key, bw, shape, cuda_device)
        assert torch.equal(got, ref)
    n0 = kernels.launch_counts["threefry_normal"]
    got = prng.sample_normals(key, shape, dtype, cuda_device)
    assert kernels.launch_counts["threefry_normal"] == n0 + 1
    ref = prng.normals_plain(key, shape, dtype, cuda_device)
    torch.cuda.synchronize()
    # Identical bits; CUDA's erfinv against PyTorch's, scaled for the tails.
    err = ((got - ref).abs() / (1.0 + ref.abs())).max().item()
    assert err <= tol, err


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(128, 24576), (128, 3081), (128, 387), (128, 48),
                                   (32, 196608)])
def test_threefry_kernel_at_the_unstructured_shapes(cuda_device, shape):
    """K2 at the noise shapes of the unstructured path (batch x cells of
    every level of the agglomerated 24 576-tet cube of chip_smoke.py, the
    nested 196 608-tet level), float32."""
    key = prng.fold_in(prng.PRNGKey(5), shape[1])
    n0 = kernels.launch_counts["threefry_normal"]
    got = prng.sample_normals(key, shape, torch.float32, cuda_device)
    assert kernels.launch_counts["threefry_normal"] == n0 + 1
    ref = prng.normals_plain(key, shape, torch.float32, cuda_device)
    torch.cuda.synchronize()
    err = ((got - ref).abs() / (1.0 + ref.abs())).max().item()
    assert err <= 1e-5, err


def _hybrid_solver(device):
    """hybrid-cg on the nested hierarchy of a 2 x 2 x 2 tet box (48 -> 6
    tets), float64, and a lognormal field on level 0."""
    from _torch_parity import general_mesh
    from parelagmc_tpu_torch.config import ProblemConfig
    from parelagmc_tpu_torch.fem.simplicial_hierarchy import build_simplicial_hierarchy
    from parelagmc_tpu_torch.mesh import mfem_io
    from parelagmc_tpu_torch.unstructured import UnstructuredDarcySolver

    hier = build_simplicial_hierarchy(general_mesh(mfem_io, (2, 2, 2)), 2)
    cfg = ProblemConfig(refinements=1, dtype="float64")
    cfg.darcy_solver.name = "hybrid-cg"
    cfg.darcy_solver.relative_tolerance = 1e-10
    cfg.darcy_solver.coarse_dense_cutoff = 20
    w = np.exp(0.5 * np.random.default_rng(0).normal(size=(3, hier.levels[0].n_s)))
    return (UnstructuredDarcySolver(hier, cfg, torch.float64, device=device),
            torch.as_tensor(w, device=device))


def test_hybrid_block_product_runs_without_tf32(monkeypatch):
    """hybrid_solve's block einsum runs with TF32 off and the float32
    matmul precision "highest", whatever the caller set, and gives the
    caller's setting back."""
    seen = []
    einsum = torch.einsum

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision()))
        return einsum(*args)

    solver, w = _hybrid_solver(CPU)
    monkeypatch.setattr(torch, "einsum", spy)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        q, _, info = solver.solve_fwd(0, w)
        after = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(prev)
    assert bool(info.converged.all()) and len(seen) > info.iterations
    assert set(seen) == {(False, "highest")}
    assert after == (True, "high")


@pytest.mark.gpu
def test_embedded_noise_and_hybrid_solve_on_the_card(cuda_device):
    """K2 at the embedded draw shapes of chip_smoke.py's mesh-file phase
    (batch 32 x the enlarged meshes' level-0 cells: 196 608 matching, 82 944
    non-matching): the raw bits bit for bit and the normals to 1e-5 against
    the plain version (CUDA's erfinvf against PyTorch's); then hybrid_solve
    on the card against the same solve on the CPU."""
    for shape in ((32, 196608), (32, 82944)):
        key = prng.fold_in(prng.PRNGKey(6), shape[1])
        assert torch.equal(prng.random_bits(key, 32, shape, cuda_device),
                           prng.random_bits_plain(key, 32, shape, cuda_device))
        n0 = kernels.launch_counts["threefry_normal"]
        got = prng.sample_normals(key, shape, torch.float32, cuda_device)
        assert kernels.launch_counts["threefry_normal"] == n0 + 1
        ref = prng.normals_plain(key, shape, torch.float32, cuda_device)
        err = ((got - ref).abs() / (1.0 + ref.abs())).max().item()
        assert err <= 1e-5, err
    (gpu, w_gpu), (cpu, w_cpu) = _hybrid_solver(cuda_device), _hybrid_solver(CPU)
    q_g, _, info_g, p_g = gpu.solve_fwd(0, w_gpu, return_pressure=True)
    q_c, _, info_c, p_c = cpu.solve_fwd(0, w_cpu, return_pressure=True)
    assert bool(info_g.converged.all()) and abs(info_g.iterations - info_c.iterations) <= 2
    assert ((q_g.cpu() - q_c).abs().max() / q_c.abs().max()).item() <= 1e-10
    assert ((p_g.cpu() - p_c).abs().max() / p_c.abs().max()).item() <= 1e-10


@pytest.mark.gpu
@pytest.mark.parametrize("n,L", [(17, 131072), (86, 4099)])
def test_thomas_bf16_kernel_matches_plain(cuda_device, n, L):
    """The bf16 instantiation rounds each step as the plain version's
    float32 ops do (no FMA contraction), so the two agree bit for bit."""
    dl, d, du, b = _lines(n, L, torch.bfloat16, cuda_device, seed=n)
    n0 = kernels.launch_counts["thomas"]
    x = thomas(dl, d, du, b)
    assert kernels.launch_counts["thomas"] == n0 + 1
    ref = thomas_plain(dl, d, du, b)
    torch.cuda.synchronize()
    assert x.dtype == torch.bfloat16
    assert torch.equal(x, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_threefry_uniform_kernel_matches_plain(cuda_device, dtype):
    key = prng.fold_in(prng.PRNGKey(5), 2)
    shape = (64, 4096 + 3)
    n0 = kernels.launch_counts["threefry_uniform"]
    got = prng.sample_uniforms(key, shape, dtype, cuda_device)
    assert kernels.launch_counts["threefry_uniform"] == n0 + 1
    ref = prng.uniforms_plain(key, shape, dtype, cuda_device)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, ref)
    assert 0.0 <= got.min().item() and got.max().item() < 1.0


def _mass_solver(shape, ess_attr, dtype, device):
    """M(w)^{-1} on a box of `shape` cells, built by the port's own builders."""
    lvl = build_mixed_level(make_box_mesh(shape))
    ess = lvl.ess_faces(np.array(ess_attr))
    return lvl, build_mass_tridiag_solver(lvl, ess, dtype=dtype, device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,B", [((16, 16, 16), 4), ((22, 6, 9), 3), ((220, 3, 2), 2),
                                     ((7, 5), 5)])
def test_minv_kernel_on_the_face_layout_matches_plain(cuda_device, dtype, tol, shape, B):
    """apply_factored on CUDA tensors (K1 on the flat face layout, one
    launch per axis) against the plain composed path on the same tables,
    relative to max |z|. (220, 3, 2) runs x lines of 221 rows: several
    chunks of the load ring."""
    lvl, ms = _mass_solver(shape, [0, 1, 1, 1, 1, 0][: 2 * len(shape)], dtype, cuda_device)
    rng = np.random.default_rng(len(shape) + B)
    w = torch.from_numpy(np.exp(rng.normal(size=(B, lvl.n_s)))).to(cuda_device, dtype)
    r = torch.from_numpy(rng.normal(size=(B, lvl.n_u))).to(cuda_device, dtype)
    fac = ms.factor(w)
    n0 = kernels.launch_counts["thomas"]
    z = ms.apply_factored(fac, r)
    assert kernels.launch_counts["thomas"] == n0 + len(shape)
    ref = ms.apply_plain(fac, r)
    torch.cuda.synchronize()
    assert torch.isfinite(z).all()
    assert ((z - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("n", [2, 3, 16, 17, 33, 221, 400])
def test_segment_path_matches_plain(cuda_device, dtype, tol, n):
    """Contiguous lines (sI = 1) take the kernel's segment path: one
    segment of 2 or 3 rows, segments of 8 to 16 rows, up to 25 segments
    per line. Nonzero dl[0] and du[n-1] must be ignored, as the plain
    recurrence ignores them."""
    L = 1000
    dl, d, du, b = (t.t().contiguous() for t in _lines(n, L, dtype, cuda_device, seed=n))
    x = torch.empty_like(b)
    thomas_lines(dl, d, du, b, x, LineLayout(n=n, L=L, J=1, O=L, sO=n, sB=0, sI=1, base=0))
    ref = thomas_plain(dl.t(), d.t(), du.t(), b.t()).t()
    torch.cuda.synchronize()
    assert ((x - ref).abs().max() / ref.abs().max()).item() <= tol


@pytest.mark.gpu
def test_thomas_lines_leaves_unaddressed_elements_and_refuses_long_lines(cuda_device):
    """A layout covering part of a vector writes only its lines; a line too
    long for the shared memory is refused, not run."""
    n, L = 9, 40
    dl, d, du, b = _lines(n, L, torch.float64, cuda_device, seed=3)
    x = torch.full_like(b, 7.0)
    half = LineLayout(n=n, L=L // 2, J=L // 2, O=1, sO=0, sB=0, sI=L, base=0)
    thomas_lines(dl, d, du, b, x, half)
    ref = thomas_plain(dl[:, : L // 2], d[:, : L // 2], du[:, : L // 2], b[:, : L // 2])
    torch.cuda.synchronize()
    assert ((x[:, : L // 2] - ref).abs().max() / ref.abs().max()).item() <= 1e-12
    assert (x[:, L // 2:] == 7.0).all()
    dl, d, du, b = _lines(2000, 3, torch.float64, cuda_device)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        thomas(dl, d, du, b)


def _rel(x, ref):
    return ((x.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


_RHS_TOL = {torch.float32: 1e-5, torch.float64: 1e-12, torch.bfloat16: 0.0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 2, 3, 8])
@pytest.mark.parametrize("n,L", [(42, 3300), (5, 77), (221, 130)])
def test_thomas_rhs_groups_on_strided_rows_match_plain(cuda_device, dtype, R, n, L):
    """R right-hand sides per (n, L) table set (rows at a stride, the Thomas
    path; groups of 1, 2 and 4 with a ragged last group): against the plain
    version, and against R separate launches exactly; bf16 bit for bit."""
    dl, d, du, _ = _lines(n, L, dtype, cuda_device, seed=n + R)
    b = torch.randn(R, n, L, device=cuda_device, dtype=torch.float64).to(dtype)
    n0 = kernels.launch_counts["thomas"]
    x = thomas(dl, d, du, b)
    assert kernels.launch_counts["thomas"] == n0 + 1
    ref = thomas_plain(dl, d, du, b)
    torch.cuda.synchronize()
    assert x.shape == b.shape and torch.isfinite(x.float()).all()
    assert _rel(x, ref) <= _RHS_TOL[dtype]
    for r in range(R):
        assert torch.equal(x[r], thomas(dl, d, du, b[r].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_thomas_many_rhs_on_small_shared_tables_match_plain(cuda_device, dtype):
    """More blocks than the card holds at once on tables that stay in L2
    (the static multigrid's line smoother at R = batch): the Thomas path
    takes groups of one with the right-hand sides' own addressing."""
    n, L, R = 110, 1260, 32
    dl, d, du, _ = _lines(n, L, dtype, cuda_device, seed=R)
    b = torch.randn(R, n, L, device=cuda_device, dtype=torch.float64).to(dtype)
    x = thomas(dl, d, du, b)
    ref = thomas_plain(dl, d, du, b)
    torch.cuda.synchronize()
    assert _rel(x, ref) <= _RHS_TOL[dtype]
    for r in (0, 17, R - 1):
        assert torch.equal(x[r], thomas(dl, d, du, b[r].contiguous()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 2, 8])
@pytest.mark.parametrize("n", [3, 61, 221])
def test_thomas_rhs_groups_on_contiguous_rows_match_plain(cuda_device, dtype, R, n):
    """The same on contiguous lines (sI = 1: the segment path for float32
    and float64, groups of two; the Thomas path for bfloat16), b and x laid
    out (L, R, n): the right-hand sides of a line side by side, their own
    batch stride R * n."""
    L = 500
    dl, d, du, _ = (t.t().contiguous() for t in _lines(n, L, dtype, cuda_device, seed=n + R))
    b = torch.randn(L, R, n, device=cuda_device, dtype=torch.float64).to(dtype)
    x = torch.empty_like(b)
    lay = LineLayout(n=n, L=L, J=1, O=1, sO=0, sB=n, sI=1, base=0)
    thomas_lines(dl, d, du, b, x, lay, rhs=R, rhs_stride=n, rhs_batch_stride=R * n)
    ref = thomas_plain(dl.t(), d.t(), du.t(), b.permute(1, 2, 0)).permute(2, 0, 1)
    torch.cuda.synchronize()
    assert _rel(x, ref) <= _RHS_TOL[dtype]
    one = torch.empty(L, n, device=cuda_device, dtype=dtype)
    for r in range(R):
        thomas_lines(dl, d, du, b[:, r].contiguous(), one, lay)
        assert torch.equal(x[:, r], one)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("shape,B,R", [((16, 16, 16), 4, 2), ((22, 6, 9), 3, 2), ((7, 5), 5, 3)])
def test_minv_kernel_with_stacked_right_hand_sides(cuda_device, dtype, tol, shape, B, R):
    """apply_factored on (B, R, n_u): one launch per axis solves R vectors
    per sample on that sample's tables, equal to R separate applies."""
    lvl, ms = _mass_solver(shape, [0, 1, 1, 1, 1, 0][: 2 * len(shape)], dtype, cuda_device)
    rng = np.random.default_rng(B + R)
    w = torch.from_numpy(np.exp(rng.normal(size=(B, lvl.n_s)))).to(cuda_device, dtype)
    r = torch.from_numpy(rng.normal(size=(B, R, lvl.n_u))).to(cuda_device, dtype)
    fac = ms.factor(w)
    n0 = kernels.launch_counts["thomas"]
    z = ms.apply_factored(fac, r)
    assert kernels.launch_counts["thomas"] == n0 + len(shape)
    ref = ms.apply_plain(fac, r)
    torch.cuda.synchronize()
    assert z.shape == r.shape and _rel(z, ref) <= tol
    for q in range(R):
        assert torch.equal(z[:, q], ms.apply_factored(fac, r[:, q].contiguous()))


def test_thomas_rhs_wrapper_on_the_cpu_and_its_checks():
    dl, d, du, _ = _lines(6, 4, torch.float64, "cpu")
    b = torch.randn(3, 6, 4, dtype=torch.float64)
    x = thomas(dl, d, du, b)
    for r in range(3):
        assert torch.equal(x[r], thomas_plain(dl, d, du, b[r]))
    with pytest.raises(ValueError):
        thomas(dl, d, du, torch.randn(3, 6, 5, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        thomas_lines(dl, d, du, b, torch.empty_like(b),
                     LineLayout(n=6, L=4, J=4, O=1, sO=0, sB=0, sI=4, base=0), rhs=3, rhs_stride=24)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_sharded_minv_kernel_matches_plain(cuda_device, dtype, tol):
    """The spatially sharded M(w)^{-1} (parallel/spatial_darcy.py: K1 on the
    slab x, z and decoupled y lines and the SPIKE spike solves with R = 2)
    on the card against the same solve on the CPU (thomas_plain), for three
    fields over 8 slabs of a (6, 14, 5) grid (ny padded to 16)."""
    from _torch_parity import spatial_one_level
    from parelagmc_tpu_torch.parallel.spatial_darcy import SpatialDarcy

    hier, solver = spatial_one_level((6, 14, 5), kinv_sigma=1.0)
    g = torch.Generator(device="cpu").manual_seed(1)
    w = torch.exp(0.5 * torch.randn(3, hier.levels[0].n_s, generator=g, dtype=torch.float64))
    out = []
    for dev in (CPU, cuda_device):
        sd = SpatialDarcy.from_darcy(solver, 0, n_sp=8, device=dev, dtype=dtype)
        grids = sd.grids
        wg = sd._to_slabs(w.to(dev, dtype), 1.0, slice(None)).masked_fill(grids.pad_cell, 1.0)
        fac = sd._minv_factor(grids, wg, sd.comm.halo_up(wg.narrow(-2, sd.m - 1, 1)))
        rhs = tuple((v + 1.0).expand(wg.shape[:2] + v.shape[2:]).contiguous()
                    for v in grids.rhs_u)
        out.append([z.cpu() for z in sd._minv_apply(fac, rhs)])
    for a, b in zip(*out):
        assert (a - b).abs().max() <= tol * b.abs().max()
