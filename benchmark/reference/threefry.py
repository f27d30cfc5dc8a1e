"""Threefry-2x32 keys and normal draws, in NumPy, for the plain reference.

Frozen copy of `threefry2x32`, `PRNGKey`, `fold_in`, `uniforms_plain` and
`normals_plain` of parelagmc_tpu_torch/ops/prng.py at commit 0ca6bbb
(jax.random's threefry2x32 stream under `jax_threefry_partitionable`),
rewritten on plain PyTorch int64 tensors holding uint32 words (on any
device) so that the reference shares no code with the program it judges.
The erfinv step runs in float64 on the float32 uniform, so a float32 draw
agrees with the program's to the last bit or two of erfinv.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import numpy as np
import torch

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) on Python ints or int64 tensors holding
    uint32 values."""
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ 0x1BD11BDA) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + g + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def _words(key: Key, idx: torch.Tensor):
    """The two 32-bit words of counters idx (int64)."""
    return threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)


def _normals_f32(key: Key, idx: torch.Tensor) -> torch.Tensor:
    """jax.random.normal(key, ..., float32) at counters idx: the mantissa
    trick on the word y0 ^ y1, then erfinv (taken in float64)."""
    y0, y1 = _words(key, idx)
    fbits = ((y0 ^ y1) >> 9) | 0x3F800000
    u = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.nextafter(torch.tensor(-1.0, dtype=torch.float32),
                         torch.tensor(0.0, dtype=torch.float32)).to(idx.device)
    u = torch.maximum(lo, u * (1.0 - lo) + lo)
    return math.sqrt(2.0) * torch.special.erfinv(u.to(torch.float64))


def _normals_f64(key: Key, idx: torch.Tensor) -> torch.Tensor:
    """jax.random.normal(key, ..., float64) at counters idx: the mantissa
    trick on the top 52 of the 64 bits (y0 << 32) | y1."""
    y0, y1 = _words(key, idx)
    mant = (y0 << 20) | (y1 >> 12)
    f = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo = math.nextafter(-1.0, 0.0)
    u = torch.clamp(f * (1.0 - lo) + lo, min=lo)
    return math.sqrt(2.0) * torch.special.erfinv(u)


def normals_rows(key: Key, n_cols: int, rows: Sequence[int], dtype: str,
                 device="cpu") -> torch.Tensor:
    """Rows `rows` of the (batch, n_cols) draw of `key` in the program's
    dtype ('float32' or 'float64'), as float64: (len(rows), n_cols)."""
    r = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
    idx = (r[:, None] * n_cols + torch.arange(n_cols, device=device)[None, :]).reshape(-1)
    draw = _normals_f32 if dtype == "float32" else _normals_f64
    return draw(key, idx).reshape(len(rows), n_cols)
