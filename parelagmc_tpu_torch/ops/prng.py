"""Counter-based normal noise: threefry2x32 with jax.random's layout.

Port of parelagmc_tpu/ops/prng.py. The reference draws on the TPU with the
hardware PRNG (Pallas kernel `_pallas_normal`) and on every other backend
with jax.random.normal; the TPU's bits cannot be reproduced on a GPU, so
the port reproduces the CPU stream - jax.random with the threefry2x32
implementation and `jax_threefry_partitionable=True` - bit for bit:

* a key is two uint32 words held as two Python ints on the host
  (`PRNGKey(s) = (s >> 32, s & 0xffffffff)`), so deriving keys never
  touches the device;
* `fold_in(k, d) = threefry2x32(k, (0, d))`;
* `split(k, num)[i] = threefry2x32(k, (0, i))`: with
  `jax_threefry_partitionable` the split runs the generator over an iota of
  64-bit counters, like a draw, and keeps both output words as the new key
  (so `split(k)[1] == fold_in(k, 1)`; the older layout, which paired the
  halves of one 2*num draw, is not reproduced);
* element i of a draw of shape S runs threefry2x32(k, (i >> 32, i &
  0xffffffff)) -> (y0, y1); 32-bit bits are y0 ^ y1, 64-bit bits
  (y0 << 32) | y1;
* normal = sqrt(2) * erfinv(max(lo, f * (1 - lo) + lo)), lo =
  nextafter(-1, 0), f the mantissa-trick uniform in [0, 1) from 32-bit bits
  (float32) or 64-bit bits (float64).

`sample_normals` launches the CUDA kernel K2 (csrc/threefry_normal.cu) for
a CUDA device and runs the plain PyTorch version below for the CPU;
`sample_uniforms` does the same with K3, the kernel's uniform mode (the
mantissa-trick float itself, equal to jax.random.uniform bit for bit). The
two agree bit for bit on the raw bits; the normals can differ only through
erfinv (CUDA's in the kernel, PyTorch's in the plain version; on an H100
the two gave identical values). Against jax.random.normal on the CPU the
gap is erfinv's implementation alone: <= 5e-5 abs in float32, <= 1e-10 in
float64.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from parelagmc_tpu_torch import kernels
from parelagmc_tpu_torch.device import resolve_device

Key = Tuple[int, int]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) on Python ints or int64 tensors holding
    uint32 values; every sum is masked back to 32 bits."""
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


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey(seed) key data as (hi, lo) words."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in: the new key is threefry2x32(key, (0, data))."""
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """jax.random.split(key, num) under jax_threefry_partitionable: key i is
    both output words of threefry2x32(key, (i >> 32, i & 0xffffffff))."""
    return tuple(threefry2x32(key[0], key[1], (i >> 32) & _MASK, i & _MASK)
                 for i in range(int(num)))


def _numel(shape: Sequence[int]) -> int:
    return int(math.prod(int(s) for s in shape))


def random_bits_plain(key: Key, bit_width: int, shape: Sequence[int],
                      device=None) -> torch.Tensor:
    """jax.random.bits(key, shape, uint{bit_width}) as an int64 tensor: the
    uint32 value for 32 bits, the uint64 bit pattern (two's complement) for
    64 bits. Plain PyTorch; runs on any device."""
    n = _numel(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    if bit_width == 32:
        bits = y0 ^ y1
    elif bit_width == 64:
        # (y0 << 32) | y1 without signed overflow: y0 as a signed 32-bit
        # value times 2^32 spans [-2^63, 2^63 - 2^32].
        y0s = torch.where(y0 >= 2 ** 31, y0 - 2 ** 32, y0)
        bits = y0s * (2 ** 32) + y1
    else:
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    return bits.reshape(tuple(shape))


def _normal_constants(dtype: torch.dtype) -> Tuple[float, float, float]:
    """(lo, scale, sqrt2) rounded to `dtype` exactly as jax.random.normal
    computes them: lo = nextafter(-1, 0), scale = (1 - lo) in the dtype."""
    npdt = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lo = np.nextafter(npdt(-1.0), npdt(0.0), dtype=npdt)
    scale = npdt(1.0) - lo
    sqrt2 = npdt(np.sqrt(2))
    return float(lo), float(scale), float(sqrt2)


def uniforms_plain(key: Key, shape: Sequence[int], dtype: torch.dtype,
                   device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype) on [0, 1) in plain PyTorch: the
    mantissa-trick float bitcast((bits >> (nbits - nmant)) | bits(1.0)) - 1
    from 32-bit bits (float32) or 64-bit bits (float64)."""
    if dtype == torch.float32:
        bits = random_bits_plain(key, 32, shape, device)
        fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
        return fbits.view(torch.float32) - 1.0
    if dtype == torch.float64:
        # The top 52 of the 64 bits, built from the words so nothing
        # overflows: bits >> 12 = (y0 << 20) | (y1 >> 12).
        idx = torch.arange(_numel(shape), dtype=torch.int64, device=device)
        y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
        mant = (y0 << 20) | (y1 >> 12)
        f = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
        return f.reshape(tuple(shape))
    raise NotImplementedError(f"random floats in {dtype} are not supported")


def normals_plain(key: Key, shape: Sequence[int], dtype: torch.dtype,
                  device=None) -> torch.Tensor:
    """jax.random.normal(key, shape, dtype) in plain PyTorch (threefry in
    int64 tensor ops, mantissa-trick uniform, erfinv)."""
    lo, scale, sqrt2 = _normal_constants(dtype)
    f = uniforms_plain(key, shape, dtype, device)
    lo_t = torch.tensor(lo, dtype=dtype, device=f.device)
    u = torch.maximum(lo_t, f * torch.tensor(scale, dtype=dtype, device=f.device) + lo_t)
    return torch.special.erfinv(u) * torch.tensor(sqrt2, dtype=dtype, device=f.device)


def _launch_threefry(fn_name: str, key: Key, out: torch.Tensor, *consts,
                     count: str = "threefry_normal") -> None:
    kernels.launch(count, out.device, getattr(kernels.library(), fn_name),
                   key[0], key[1], out.data_ptr(), out.numel(), *consts)


def random_bits(key: Key, bit_width: int, shape: Sequence[int],
                device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """jax.random.bits as int64 (see random_bits_plain): K2 in bits mode on
    a CUDA device (None: cuda:0), the plain version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return random_bits_plain(key, bit_width, shape, device)
    if device.type != "cuda":
        raise ValueError(f"random_bits: unsupported device {device}")
    if bit_width not in (32, 64):
        raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")
    out = torch.empty(tuple(shape), dtype=torch.int64, device=device)
    _launch_threefry(f"threefry_bits{bit_width}", key, out)
    return out


def _out_buffer(out: Optional[torch.Tensor], shape: Sequence[int], dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The tensor a CUDA draw writes: a new one, or the caller's `out`
    (contiguous, of the draw's shape, dtype and device)."""
    if out is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != dtype or out.device != device
            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {tuple(shape)} {dtype} tensor on {device}")
    return out


def sample_normals(key: Key, shape: Sequence[int], dtype: torch.dtype = torch.float32,
                   device: Union[str, torch.device, None] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """N(0,1) samples of `shape`, deterministic in `key`, equal to
    jax.random.normal(key, shape, dtype). K2 on a CUDA device (None:
    cuda:0; writes the dtype directly, into `out` if given), the plain
    version on the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        x = normals_plain(key, shape, dtype, device)
        return x if out is None else out.copy_(x)
    if device.type != "cuda":
        raise ValueError(f"sample_normals: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"normals in {dtype} are not supported")
    out = _out_buffer(out, shape, dtype, device)
    name = "threefry_normal_f32" if dtype == torch.float32 else "threefry_normal_f64"
    _launch_threefry(name, key, out, *_normal_constants(dtype))
    return out


def sample_uniforms(key: Key, shape: Sequence[int], dtype: torch.dtype = torch.float32,
                    device: Union[str, torch.device, None] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """U[0, 1) samples of `shape`, equal to jax.random.uniform(key, shape,
    dtype) bit for bit. K3 (the uniform mode of csrc/threefry_normal.cu) on a
    CUDA device (None: cuda:0; into `out` if given), the plain version on
    the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        x = uniforms_plain(key, shape, dtype, device)
        return x if out is None else out.copy_(x)
    if device.type != "cuda":
        raise ValueError(f"sample_uniforms: unsupported device {device}")
    if dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"random floats in {dtype} are not supported")
    out = _out_buffer(out, shape, dtype, device)
    name = "threefry_uniform_f32" if dtype == torch.float32 else "threefry_uniform_f64"
    _launch_threefry(name, key, out, count="threefry_uniform")
    return out
