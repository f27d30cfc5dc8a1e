// K2 and K3: counter-based threefry2x32 normals, uniforms (and raw bits),
// one thread per output element.
//
// Replaces the Pallas TPU kernels parelagmc_tpu/ops/prng.py (_pallas_normal,
// driven by sample_normals; _pallas_uniform, driven by sample_uniforms - the
// uniform modes below), which seeded the TPU's hardware PRNG per
// 512x1024 block and used Box-Muller. Those hardware bits cannot be
// reproduced off the TPU; the reference's CPU stream is jax.random.normal,
// and that is the stream this kernel reproduces exactly, so every module of
// the port can be held against the JAX package sample by sample and the
// fixed-seed anchors carry over:
//
//   bits   element i (row-major flat index) runs threefry2x32(key,
//          (hi32(i), lo32(i))) -> (y0, y1)   [jax_threefry_partitionable]
//          32-bit bits = y0 ^ y1, 64-bit bits = (y0 << 32) | y1
//   float  f = bitcast((bits >> (nbits - nmant)) | bits(1.0)) - 1  in [0,1)
//   normal sqrt(2) * erfinv(max(lo, f * scale + lo)),
//          lo = nextafter(-1, 0), scale = 1 - lo rounded to the dtype
//   uniform f itself (jax.random.uniform on [0, 1): the affine step to
//          [minval, maxval) is the identity there, so none is applied)
//
// float32 output uses the 32-bit bits, float64 the 64-bit bits, as jax does.
// The affine step is written with explicit round-to-nearest intrinsics so
// nvcc cannot contract it into an FMA (jax rounds the product and the sum
// separately); erfinvf/erfinv are CUDA's. The wrapper passes lo, scale and
// sqrt(2) already rounded to the dtype, computed the same way as the plain
// PyTorch version beside this kernel.
//
// The flat index goes up to 2^64 as a (hi, lo) counter pair; the grid is
// grid-stride so any size launches with a bounded grid.
//
// What bounds it on the card: integer ALU work (20 rounds of add/rotate/xor
// per element) plus erfinv; the only memory traffic is the output write.
// Why CUDA and not Triton: the generator needs exact uint32 wraparound
// arithmetic and rotates, which CUDA states directly.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[g & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

enum Mode { kNormalF32, kNormalF64, kBits32, kBits64, kUniformF32, kUniformF64 };

template <Mode M, typename T>
__global__ void threefry_kernel(uint32_t k0, uint32_t k1, T* __restrict__ out,
                                int64_t n, double lo, double scale,
                                double sqrt2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const uint64_t idx = static_cast<uint64_t>(i);
    uint32_t x0 = static_cast<uint32_t>(idx >> 32);
    uint32_t x1 = static_cast<uint32_t>(idx & 0xFFFFFFFFull);
    threefry2x32(k0, k1, x0, x1);
    if constexpr (M == kBits32) {
      out[i] = static_cast<T>(static_cast<uint64_t>(x0 ^ x1));
    } else if constexpr (M == kBits64) {
      out[i] = static_cast<T>((static_cast<uint64_t>(x0) << 32) | x1);
    } else if constexpr (M == kUniformF32) {
      const uint32_t bits = x0 ^ x1;
      out[i] = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
    } else if constexpr (M == kUniformF64) {
      const uint64_t bits = (static_cast<uint64_t>(x0) << 32) | x1;
      out[i] = __dsub_rn(
          __longlong_as_double(static_cast<long long>((bits >> 12) | 0x3FF0000000000000ull)),
          1.0);
    } else if constexpr (M == kNormalF32) {
      const uint32_t bits = x0 ^ x1;
      const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
      const float lo_f = static_cast<float>(lo);
      const float u = fmaxf(lo_f, __fadd_rn(__fmul_rn(f, static_cast<float>(scale)), lo_f));
      out[i] = __fmul_rn(static_cast<float>(sqrt2), erfinvf(u));
    } else {  // kNormalF64
      const uint64_t bits = (static_cast<uint64_t>(x0) << 32) | x1;
      const double f = __dsub_rn(
          __longlong_as_double(static_cast<long long>((bits >> 12) | 0x3FF0000000000000ull)),
          1.0);
      const double u = fmax(lo, __dadd_rn(__dmul_rn(f, scale), lo));
      out[i] = __dmul_rn(sqrt2, erfinv(u));
    }
  }
}

template <Mode M, typename T>
int launch(uint32_t k0, uint32_t k1, void* out, int64_t n, double lo,
           double scale, double sqrt2, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  const int64_t max_blocks = 132 * 64;  // grid-stride beyond this
  if (blocks > max_blocks) blocks = max_blocks;
  threefry_kernel<M, T><<<static_cast<unsigned int>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      k0, k1, static_cast<T*>(out), n, lo, scale, sqrt2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int threefry_normal_f32(uint32_t k0, uint32_t k1, void* out, int64_t n,
                        float lo, float scale, float sqrt2, void* stream) {
  return launch<kNormalF32, float>(k0, k1, out, n, lo, scale, sqrt2, stream);
}

int threefry_normal_f64(uint32_t k0, uint32_t k1, void* out, int64_t n,
                        double lo, double scale, double sqrt2, void* stream) {
  return launch<kNormalF64, double>(k0, k1, out, n, lo, scale, sqrt2, stream);
}

// U[0, 1) by the mantissa trick: float32 from the 32-bit bits, float64 from
// the 64-bit bits, equal to jax.random.uniform bit for bit.
int threefry_uniform_f32(uint32_t k0, uint32_t k1, void* out, int64_t n,
                         void* stream) {
  return launch<kUniformF32, float>(k0, k1, out, n, 0.0, 0.0, 0.0, stream);
}

int threefry_uniform_f64(uint32_t k0, uint32_t k1, void* out, int64_t n,
                         void* stream) {
  return launch<kUniformF64, double>(k0, k1, out, n, 0.0, 0.0, 0.0, stream);
}

// Raw bits into an int64 tensor: the uint32 value zero-extended (bits32) or
// the uint64 bit pattern (bits64), the representation the plain version uses.
int threefry_bits32(uint32_t k0, uint32_t k1, void* out, int64_t n,
                    void* stream) {
  return launch<kBits32, int64_t>(k0, k1, out, n, 0.0, 0.0, 0.0, stream);
}

int threefry_bits64(uint32_t k0, uint32_t k1, void* out, int64_t n,
                    void* stream) {
  return launch<kBits64, int64_t>(k0, k1, out, n, 0.0, 0.0, 0.0, stream);
}

}  // extern "C"
