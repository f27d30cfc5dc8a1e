// K1: batched Thomas tridiagonal solve, one thread per line.
//
// Replaces the Pallas TPU kernel parelagmc_tpu/ops/tridiag_pallas.py
// (_thomas_kernel, driven by _tridiag_thomas_pallas). Caller on the main
// path: the exact velocity mass inverse M(w)^{-1} of the Darcy Schur CG
// (parelagmc_tpu_torch/ops/mass_solve.py), once per CG iteration plus the
// right-hand side and the velocity recovery.
//
// Computes, for every line l of L independent systems of n rows,
//   tridiag(dl, d, du) x = b
// with the recurrences of the reference (no pivoting; the systems are SPD,
// diagonally dominant RT0 mass lines):
//   forward   c_i = du_i / (d_i - dl_i c_{i-1}),
//             g_i = (b_i - dl_i g_{i-1}) / (d_i - dl_i c_{i-1})
//   backward  x_i = g_i - c_i x_{i+1}.
//
// Layout: every array is (n, L) contiguous, solved axis first, so at each
// row step neighbouring threads read neighbouring addresses (coalesced).
// The TPU kernel tiled lines into (8, 128) VMEM blocks and walked rows with
// a fori_loop over VMEM-resident scratch; here the sequential row loop is
// inside one thread and the L lines spread over the grid - no block
// carries anything to another.
//
// What bounds it on the card: device-memory bandwidth. Per row a thread
// reads dl, d, du, b and writes c, g; the backward sweep reads c, g and
// writes x: 9 words per unknown, ~2 flops per word. The design keeps the
// traffic at that minimum for precomputed tables: g is kept in the output
// array x (no separate scratch), and each value is touched once per sweep.
// Later work (ROADMAP): build the rows from w and the static m_lo/m_mid/m_hi
// tables inside the kernel, and fold the per-axis transposes into the
// indexing, which would cut the bytes further.
//
// Second caller: the line smoother of the per-sample Galerkin Schur MG
// (parelagmc_tpu_torch/ops/coef_multigrid_structured.py; the reference's
// _tridiag_solve_last), one solve per configured axis per smoothing pass.
// With a bfloat16 preconditioner state its tables arrive in bf16:
// thomas_solve_bf16 loads and stores bf16 and runs the recurrence in f32,
// with c and g in f32 scratch (a bf16 g would round the carried value).
// Its arithmetic is written with round-to-nearest intrinsics so nvcc cannot
// contract it into FMAs: each step then rounds exactly as the plain
// version's float32 tensor ops do, and the two agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                              const T* __restrict__ du, const T* __restrict__ b,
                              T* __restrict__ x, T* __restrict__ c, int n,
                              int64_t L) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= L) return;  // ragged edge of the last block
  T c_prev = T(0);
  T g_prev = T(0);
  for (int i = 0; i < n; ++i) {
    const int64_t k = static_cast<int64_t>(i) * L + l;
    const T dl_i = dl[k];
    const T denom = d[k] - dl_i * c_prev;
    c_prev = du[k] / denom;
    g_prev = (b[k] - dl_i * g_prev) / denom;
    c[k] = c_prev;
    x[k] = g_prev;  // g lives in x until the backward sweep overwrites it
  }
  T x_next = T(0);
  for (int i = n - 1; i >= 0; --i) {
    const int64_t k = static_cast<int64_t>(i) * L + l;
    x_next = x[k] - c[k] * x_next;
    x[k] = x_next;
  }
}

__global__ void thomas_kernel_bf16(
    const __nv_bfloat16* __restrict__ dl, const __nv_bfloat16* __restrict__ d,
    const __nv_bfloat16* __restrict__ du, const __nv_bfloat16* __restrict__ b,
    __nv_bfloat16* __restrict__ x, float* __restrict__ c, float* __restrict__ g,
    int n, int64_t L) {
  const int64_t l = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float c_prev = 0.0f;
  float g_prev = 0.0f;
  for (int i = 0; i < n; ++i) {
    const int64_t k = static_cast<int64_t>(i) * L + l;
    const float dl_i = __bfloat162float(dl[k]);
    const float denom = __fsub_rn(__bfloat162float(d[k]), __fmul_rn(dl_i, c_prev));
    c_prev = __fdiv_rn(__bfloat162float(du[k]), denom);
    g_prev = __fdiv_rn(__fsub_rn(__bfloat162float(b[k]), __fmul_rn(dl_i, g_prev)), denom);
    c[k] = c_prev;
    g[k] = g_prev;
  }
  float x_next = 0.0f;
  for (int i = n - 1; i >= 0; --i) {
    const int64_t k = static_cast<int64_t>(i) * L + l;
    x_next = __fsub_rn(g[k], __fmul_rn(c[k], x_next));
    x[k] = __float2bfloat16_rn(x_next);
  }
}

template <typename T>
int launch(const void* dl, const void* d, const void* du, const void* b,
           void* x, void* c, int n, int64_t L, void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (L + threads - 1) / threads;
  thomas_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d),
      static_cast<const T*>(du), static_cast<const T*>(b),
      static_cast<T*>(x), static_cast<T*>(c), n, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int thomas_solve_f32(const void* dl, const void* d, const void* du,
                     const void* b, void* x, void* c, int n, int64_t L,
                     void* stream) {
  return launch<float>(dl, d, du, b, x, c, n, L, stream);
}

int thomas_solve_f64(const void* dl, const void* d, const void* du,
                     const void* b, void* x, void* c, int n, int64_t L,
                     void* stream) {
  return launch<double>(dl, d, du, b, x, c, n, L, stream);
}

// c and g: (n, L) float32 scratch.
int thomas_solve_bf16(const void* dl, const void* d, const void* du,
                      const void* b, void* x, void* c, void* g, int n,
                      int64_t L, void* stream) {
  if (L <= 0 || n <= 0) return 0;
  const int threads = 256;
  const int64_t blocks = (L + threads - 1) / threads;
  thomas_kernel_bf16<<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dl), static_cast<const __nv_bfloat16*>(d),
      static_cast<const __nv_bfloat16*>(du), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(x), static_cast<float*>(c),
      static_cast<float*>(g), n, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
