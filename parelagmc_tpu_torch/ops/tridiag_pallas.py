"""K1 wrapper: batched Thomas tridiagonal solves on strided lines.

Counterpart of parelagmc_tpu/ops/tridiag_pallas.py (the Pallas TPU kernel
`_thomas_kernel`); the module keeps its name so the pair is easy to find.
The CUDA kernel is csrc/thomas.cu; `thomas_plain` beside it is the same
recurrence in plain PyTorch, a loop over rows that is vectorized over
lines. Callers: M(w)^{-1} (ops/mass_solve.py, whose composed plain path
slices, permutes and concatenates around `thomas_plain`) and the coefMG
line smoother (ops/coef_multigrid_structured.py), whose tables are
bfloat16 with a bfloat16 preconditioner state: bf16 lines run the
recurrence in float32 and store x in bf16, in both versions.

Layout: the kernel reads dl, d, du, b and writes x through one
`LineLayout` - line l, row i at
`base + bb * sB + o * sO + i * sI + j` with `l = (bb * O + o) * J + j`
(`line_index`, the arithmetic the kernel does). `grid_axis_layout` gives
the lines along one dim of a batch of C-contiguous grids (M(w)^{-1} on the
flat face vector, no copies); `rows_first_layout` the (n, L) row-major
tables with the solved axis first.

One table set may serve several right-hand sides (the stacked primal +
adjoint Schur solve: two vectors per sample; the static Schur multigrid's
line smoother: one (n, L) table set for the whole batch): the kernel reads
each row of dl, d, du once and carries one g and x recurrence per
right-hand side, which lie `rhs_stride` apart (`line_index` with `rhs`).

`thomas` (for (n, ...) tables) and `thomas_lines` (any layout) launch the
kernel for CUDA tensors, and `thomas` runs the plain version for CPU
tensors; for a CUDA tensor they launch or raise, never fall back.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import torch

from parelagmc_tpu_torch import kernels


class LineLayout(NamedTuple):
    """Where line l, row i of a batched line solve lives in a flat array
    (all counts and strides in elements)."""

    n: int  # rows per line
    L: int  # lines
    J: int  # lines at consecutive addresses
    O: int  # line groups
    sO: int  # stride between line groups
    sB: int  # stride between batch members
    sI: int  # stride between rows
    base: int  # offset of line 0, row 0


def line_index(lay: LineLayout, line, row, rhs=0, rhs_stride: int = 0, batch_stride=None):
    """Flat index of (line, row) under `lay` - the offset arithmetic of
    csrc/thomas.cu (line_base plus row * sI). Works on ints and on integer
    tensors or arrays, broadcasting. With several right-hand sides per table
    set, b and x hold right-hand side `rhs` of the line `rhs * rhs_stride`
    further on, with `batch_stride` (default: the layout's sB) between their
    batch members; the tables are addressed with the defaults."""
    j = line % lay.J
    t = line // lay.J
    sB = lay.sB if batch_stride is None else batch_stride
    return (lay.base + (t // lay.O) * sB + (t % lay.O) * lay.sO + row * lay.sI + j
            + rhs * rhs_stride)


def grid_axis_layout(batch: int, grid: Sequence[int], dim: int, base: int = 0,
                     batch_stride: int = 0) -> LineLayout:
    """Lines along array dim `dim` of `batch` C-contiguous grids of shape
    `grid`, the first at `base`, member bb at base + bb * batch_stride."""
    grid = tuple(int(g) for g in grid)
    n = grid[dim]
    J = math.prod(grid[dim + 1:])
    O = math.prod(grid[:dim])
    return LineLayout(n=n, L=int(batch) * O * J, J=J, O=O, sO=n * J, sB=int(batch_stride),
                      sI=J, base=int(base))


def rows_first_layout(n: int, L: int) -> LineLayout:
    """(n, L) row-major tables, the solved axis first."""
    return LineLayout(n=int(n), L=int(L), J=int(L), O=1, sO=0, sB=0, sI=int(L), base=0)


def thomas_plain(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Solve tridiag(dl, d, du) x = b along the tables' dim 0 (broadcast
    over the rest): c_i = du_i / (d_i - dl_i c_{i-1}),
    g_i = (b_i - dl_i g_{i-1}) / (same), x_i = g_i - c_i x_{i+1}. No
    pivoting (SPD diagonally dominant lines). b has the tables' (n, ...)
    shape, or (R, n, ...): R right-hand sides per table set, with the
    pivots and c computed once and one g and x recurrence each. bfloat16
    lines run the recurrence in float32 and round x to bfloat16, as the
    kernel does."""
    if b.dtype == torch.bfloat16:
        up = [t.float() for t in (dl, d, du, b)]
        return thomas_plain(*up).to(torch.bfloat16)
    if b.dim() == d.dim() + 1:
        # The right-hand sides ride a trailing dim the tables broadcast over.
        x = thomas_plain(dl.unsqueeze(-1), d.unsqueeze(-1), du.unsqueeze(-1), b.movedim(0, -1))
        return x.movedim(-1, 0).contiguous()
    n = d.shape[0]
    c = torch.empty_like(d)
    g = torch.empty_like(b)
    c_prev = torch.zeros_like(d[0])
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


def _check_same(dl, d, du, b, rhs: bool = False) -> None:
    """Tables of one shape, dtype and device; b of the tables' shape, or
    with `rhs` of any shape (its layout says where its elements lie)."""
    for name, t in (("dl", dl), ("du", du)) + ((() if rhs else (("b", b),))):
        if t.shape != d.shape:
            raise ValueError(f"thomas: {name} has shape {tuple(t.shape)}, d {tuple(d.shape)}")
    for name, t in (("dl", dl), ("d", d), ("du", du)):
        if t.dtype != b.dtype:
            raise TypeError(f"thomas: {name} is {t.dtype}, b is {b.dtype}")
        if t.device != b.device:
            raise ValueError(f"thomas: {name} on {t.device}, b on {b.device}")
    if b.dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise TypeError(f"thomas: unsupported dtype {b.dtype}")


_ENTRY = {torch.float32: "thomas_lines_f32", torch.float64: "thomas_lines_f64",
          torch.bfloat16: "thomas_lines_bf16"}


def thomas_lines(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor, b: torch.Tensor,
                 x: torch.Tensor, lay: LineLayout, rhs: int = 1, rhs_stride: int = 0,
                 rhs_batch_stride=None) -> None:
    """The K1 kernel on the lines `lay` addresses in the contiguous CUDA
    tensors dl, d, du (read; one shape), b (read) and x (written, b's
    shape), on the current stream. With `rhs` > 1 every table set serves
    that many right-hand sides: b and x hold right-hand side r of a line
    `r * rhs_stride` after the first, with `rhs_batch_stride` (default:
    the layout's sB) between batch members - `line_index` with the same
    arguments. Elements that no line addresses are left as they are in x."""
    _check_same(dl, d, du, b, rhs=True)
    if x.shape != b.shape or x.dtype != b.dtype or x.device != b.device:
        raise ValueError("thomas: x must match b in shape, dtype and device")
    if b.device.type != "cuda":
        raise ValueError(f"thomas: the kernel needs CUDA tensors, got {b.device}")
    for name, t in (("dl", dl), ("d", d), ("du", du), ("b", b), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"thomas: {name} must be contiguous")
    if lay.L <= 0 or lay.n <= 0 or rhs <= 0:
        return
    sBb = lay.sB if rhs_batch_stride is None else int(rhs_batch_stride)
    last = line_index(lay, lay.L - 1, lay.n - 1)
    last_b = line_index(lay, lay.L - 1, lay.n - 1, rhs - 1, rhs_stride, sBb)
    if (lay.base < 0 or last >= d.numel() or last_b >= b.numel() or min(lay.J, lay.O) < 1
            or rhs_stride < 0 or (rhs > 1 and rhs_stride == 0)):
        raise ValueError(f"thomas: layout {lay} with {rhs} right-hand sides (stride "
                         f"{rhs_stride}, batch stride {sBb}) does not fit {d.numel()} table "
                         f"and {b.numel()} right-hand-side elements")
    fn = getattr(kernels.library(), _ENTRY[b.dtype])
    kernels.launch("thomas", b.device, fn, dl.data_ptr(), d.data_ptr(), du.data_ptr(),
                   b.data_ptr(), x.data_ptr(), lay.n, lay.L, lay.J, lay.O, lay.sO, lay.sB,
                   lay.sI, lay.base, int(rhs), int(rhs_stride), sBb)


def thomas(dl: torch.Tensor, d: torch.Tensor, du: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """x with tridiag(dl, d, du) x = b along the tables' dim 0, for (n, ...)
    tables of one shape, dtype (float32/float64/bfloat16) and device, and b
    of that shape or (R, n, ...): R right-hand sides per table set. CPU:
    thomas_plain. CUDA: the K1 kernel on the (n, L) row-major layout, on the
    current stream (inputs must be contiguous)."""
    many = b.dim() == d.dim() + 1
    if many and b.shape[1:] != d.shape:
        raise ValueError(f"thomas: b has shape {tuple(b.shape)}, d {tuple(d.shape)}")
    _check_same(dl, d, du, b, rhs=many)
    if d.dim() < 1 or d.shape[0] == 0:
        raise ValueError("thomas: need at least one row along dim 0")
    if b.device.type == "cpu":
        return thomas_plain(dl, d, du, b)
    if b.device.type != "cuda":
        raise ValueError(f"thomas: unsupported device {b.device}")
    x = torch.empty_like(b)
    n = int(d.shape[0])
    thomas_lines(dl, d, du, b, x, rows_first_layout(n, d.numel() // n),
                 rhs=int(b.shape[0]) if many else 1, rhs_stride=d.numel() if many else 0)
    return x
