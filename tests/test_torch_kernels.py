"""The port's CUDA kernels against their plain PyTorch versions on the card.

This file imports no jax, so it also runs on a machine with a card and no
jax: `python -m pytest --noconftest -m gpu tests/test_torch_kernels.py`
(the repo's conftest configures jax and is skipped there). On a host
without a card the card tests skip through the `cuda_device` fixture; the
CPU tests here pin the wrappers' dispatch and the build's error path.
"""

import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401
from parelagmc_tpu_torch import kernels
from parelagmc_tpu_torch.ops import prng
from parelagmc_tpu_torch.ops.tridiag_pallas import thomas, thomas_plain


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
    prng.sample_normals(prng.PRNGKey(2), (3, 4), torch.float64, "cpu")
    prng.sample_uniforms(prng.PRNGKey(2), (3, 4), torch.float32, "cpu")
    assert kernels.launch_counts == before


def test_thomas_plain_bfloat16_runs_float32_and_rounds_once():
    """bf16 lines: the recurrence in float32, x rounded to bf16 at the end
    (what thomas_solve_bf16 does), so the result is the float32 solve of the
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
@pytest.mark.parametrize("n,L", [(17, 131072), (65, 4099), (1, 3)])
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
