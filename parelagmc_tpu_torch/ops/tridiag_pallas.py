"""K1 wrapper: batched Thomas tridiagonal solves, solved axis first.

Counterpart of parelagmc_tpu/ops/tridiag_pallas.py (the Pallas TPU kernel
`_thomas_kernel`); the module keeps its name so the pair is easy to find.
The CUDA kernel is csrc/thomas.cu (one thread per line); `thomas_plain`
beside it is the same recurrence in plain PyTorch, a loop over rows that
is vectorized over lines. Callers: M(w)^{-1} (ops/mass_solve.py) and the
coefMG line smoother (ops/coef_multigrid_structured.py), whose tables are
bfloat16 with a bfloat16 preconditioner state: bf16 lines run the
recurrence in float32 and store x in bf16, in both versions.

Layout contract: dl, d, du and b are (n, ...) tensors of one shape, the
solved axis FIRST and every trailing dim an independent line, so the
kernel sees (n, L) row-major arrays and each row step is coalesced. This is
the layout `MassTridiagSolver.factor` builds its tables in (the TPU kernel
reached the same layout with a host-side moveaxis, tridiag_pallas.py:142).

`thomas` runs the plain version for CPU tensors and the kernel for CUDA
tensors; for a CUDA tensor it launches or raises, never falls back.
"""

from __future__ import annotations

import torch

from parelagmc_tpu_torch import kernels


def thomas_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(dl, d, du) x = b along dim 0 (broadcast over the rest):
    c_i = du_i / (d_i - dl_i c_{i-1}), g_i = (b_i - dl_i g_{i-1}) / (same),
    x_i = g_i - c_i x_{i+1}. No pivoting (SPD diagonally dominant lines).
    bfloat16 lines run the recurrence in float32 and round x to bfloat16,
    as the kernel does."""
    if b.dtype == torch.bfloat16:
        up = [t.float() for t in (dl, d, du, b)]
        return thomas_plain(*up).to(torch.bfloat16)
    n = b.shape[0]
    c = torch.empty_like(b)
    g = torch.empty_like(b)
    c_prev = torch.zeros_like(b[0])
    g_prev = torch.zeros_like(b[0])
    for i in range(n):
        denom = d[i] - dl[i] * c_prev
        c_prev = du[i] / denom
        g_prev = (b[i] - dl[i] * g_prev) / denom
        c[i] = c_prev
        g[i] = g_prev
    x = torch.empty_like(b)
    x_next = torch.zeros_like(b[0])
    for i in range(n - 1, -1, -1):
        x_next = g[i] - c[i] * x_next
        x[i] = x_next
    return x


def _check(dl, d, du, b) -> None:
    for name, t in (("dl", dl), ("d", d), ("du", du)):
        if t.shape != b.shape:
            raise ValueError(f"thomas: {name} has shape {tuple(t.shape)}, b {tuple(b.shape)}")
        if t.dtype != b.dtype:
            raise TypeError(f"thomas: {name} is {t.dtype}, b is {b.dtype}")
        if t.device != b.device:
            raise ValueError(f"thomas: {name} on {t.device}, b on {b.device}")
    if b.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"thomas: unsupported dtype {b.dtype}")
    if b.dim() < 1 or b.shape[0] == 0:
        raise ValueError("thomas: need at least one row along dim 0")


def thomas(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """x with tridiag(dl, d, du) x = b along dim 0, for (n, ...) tensors of
    one shape, dtype (float32/float64/bfloat16) and device. CPU:
    thomas_plain. CUDA: the K1 kernel on the current stream (inputs must be
    contiguous)."""
    _check(dl, d, du, b)
    if b.device.type == "cpu":
        return thomas_plain(dl, d, du, b)
    if b.device.type != "cuda":
        raise ValueError(f"thomas: unsupported device {b.device}")
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"thomas: {name} must be contiguous")
    n = int(b.shape[0])
    L = b.numel() // n
    x = torch.empty_like(b)
    lib = kernels.library()
    ptrs = (dl.data_ptr(), d.data_ptr(), du.data_ptr(), b.data_ptr(), x.data_ptr())
    if b.dtype == torch.bfloat16:
        # float32 scratch for the multipliers c and the carried g.
        c, g = torch.empty((2,) + tuple(b.shape), dtype=torch.float32, device=b.device)
        kernels.launch("thomas", b.device, lib.thomas_solve_bf16, *ptrs,
                       c.data_ptr(), g.data_ptr(), n, L)
        return x
    c = torch.empty_like(b)  # forward-sweep multipliers; g is kept in x
    fn = lib.thomas_solve_f32 if b.dtype == torch.float32 else lib.thomas_solve_f64
    kernels.launch("thomas", b.device, fn, *ptrs, c.data_ptr(), n, L)
    return x
