// K1: batched tridiagonal line solves on strided lines - the exact
// velocity-mass inverse z = M(w)^{-1} r on the port's flat face layout, and
// the coefMG line smoother's (n, L) tables.
//
// Replaces the Pallas TPU kernel parelagmc_tpu/ops/tridiag_pallas.py
// (_thomas_kernel, driven by _tridiag_thomas_pallas). Callers: M(w)^{-1} of
// the Darcy Schur CG (parelagmc_tpu_torch/ops/mass_solve.py), once per CG
// iteration plus the right-hand side and the velocity recovery; and the
// line smoother of the per-sample Schur MG (ops/coef_multigrid_structured.py).
//
// Each line solves tridiag(dl, d, du) x = b (no pivoting; the systems are
// SPD and diagonally dominant; dl of the first row and du of the last are
// ignored). The reference's Thomas recurrences:
//   forward   c_i = du_i / (d_i - dl_i c_{i-1}),
//             g_i = (b_i - dl_i g_{i-1}) / (d_i - dl_i c_{i-1})
//   backward  x_i = g_i - c_i x_{i+1}.
//
// Addressing: dl, d, du, b and x share one strided layout. Line l, row i
// lives at
//   base + bb * sB + o * sO + i * sI + j,   l = (bb * O + o) * J + j,
// which is LineLayout / line_index in parelagmc_tpu_torch/ops/tridiag_pallas.py
// (the CPU tests run the recurrence through that function). M(w)^{-1} reads
// r and writes z in the port's flat face layout (B, n_u): axis a is the
// block face_offsets[a]:face_offsets[a+1] of each sample, a reversed face
// grid (z, y, x), so no permute copy and no concatenation surround the
// kernel; the line smoother's solved-axis-first (n, L) tables are the
// special case J = L, sI = L.
//
// What bounds it: device-memory bandwidth. The least traffic is 5 words per
// unknown (read dl, d, du, b; write x), so the bound is 5 words per unknown
// over the card's 3.35 TB/s (bf16 tables: 2 bytes a word). Intermediates
// (c and g, or the segments' coefficients) never go to device memory. Two
// paths, by where the rows lie:
// * Strided rows (sI > 1: mesh axes y and z, the (n, L) tables): Thomas,
//   one lane per line, one warp per 32 lines. Neighbouring lanes load
//   neighbouring lines of one row, so every row step reads coalesced
//   straight from r, and the backward sweep writes z the same way. Rows
//   arrive through a ring of 2-3 chunks of 4 rows filled with cp.async
//   (commit/wait groups): while a lane runs the serial recurrence over one
//   chunk, the next ones are loading, so it never waits on device memory
//   at each row. c and g stay in shared memory (2 n words per line). The
//   forward step takes one reciprocal per row instead of two divisions (a
//   shorter serial chain).
// * Contiguous rows (sI == 1: mesh axis x), float32 and float64: segments
//   (the partitioned method). One lane per line kept 2 n words of c and g
//   per line in shared memory and ran all n rows serially, which on SPE10
//   level 0's x axis (40 800 lines of 221 rows) left 3 warps on an SM
//   (PERF.md). Instead a block of 128 threads loads a tile of whole lines
//   with coalesced cp.async; each thread eliminates one segment of at most
//   kSegRows rows in registers, expressing every row through the segment's
//   first and last unknowns; one thread per line solves the reduced
//   tridiagonal system of those 2 unknowns per segment in shared memory;
//   each thread back-substitutes its segment into the tile, and the tile is
//   stored coalesced.
// One launch per mesh axis, straight into z's slice: each axis gets the
// shared memory its own line length needs (221, 61 and 86 rows on SPE10
// level 0), so the short axes keep their occupancy.
// The Thomas path also takes bfloat16 and single-row lines wherever their
// rows lie (uncoalesced where sI == 1; no caller has such lines at scale).
// Its lines longer than the shared memory allows (about 430 rows in
// float64, 880 in float32 and bfloat16) are refused (cudaErrorInvalidValue).
//
// bfloat16 tables (the line smoother with a bf16 preconditioner state)
// always take the Thomas path: they load and store bf16 and run the
// recurrence in float32 with c and g in float32, written with
// round-to-nearest intrinsics so nvcc cannot contract them into FMAs: each
// step then rounds exactly as the plain version's float32 tensor ops do,
// and the two agree bit for bit. cp.async moves 4, 8 or 16 bytes, so 2-byte
// rows are fetched into registers before a chunk's recurrence and stored
// into the ring after it, which keeps the loads in flight meanwhile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLines = 32;          // lines per block: one warp, a lane per line
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr int kRC = 4;              // Thomas path: rows per ring chunk (2-byte rows: in registers)
constexpr int kSegRows = 16;        // segment path: most rows a thread eliminates
constexpr int kSegThreads = 128;    // segment path: threads per block

struct LineLayout {
  int n;       // rows per line
  int64_t L;   // lines
  int64_t J;   // lines at consecutive addresses (j)
  int64_t O;   // line groups (o)
  int64_t sO;  // stride of o
  int64_t sB;  // stride of bb
  int64_t sI;  // stride of the row i
  int64_t base;
};

// Arithmetic per storage type: S is the type of the recurrence and of c, g.
// One forward step: c = du / denom, g = (b - dl g_prev) / denom with
// denom = d - dl c_prev. float32 and float64 take one correctly rounded
// reciprocal and two products (a shorter dependent chain than two
// divisions; within an ulp of them); bfloat16 tables divide with
// round-to-nearest intrinsics, as the plain version's float32 ops do.
template <typename T>
struct Arith {
  using S = T;
  __device__ static S fms(S a, S b, S c) { return a - b * c; }
  __device__ static void step(S dl, S d, S du, S b, S& c, S& g) {
    const S inv = rcp(d - dl * c);
    c = du * inv;
    g = (b - dl * g) * inv;
  }
  __device__ static float rcp(float v) { return __frcp_rn(v); }
  __device__ static double rcp(double v) { return __drcp_rn(v); }
  __device__ static S load(T v) { return v; }
  __device__ static T store(S v) { return v; }
};

template <>
struct Arith<__nv_bfloat16> {
  using S = float;
  __device__ static S fms(S a, S b, S c) { return __fsub_rn(a, __fmul_rn(b, c)); }
  __device__ static void step(S dl, S d, S du, S b, S& c, S& g) {
    const S denom = fms(d, dl, c);
    c = __fdiv_rn(du, denom);
    g = __fdiv_rn(fms(b, dl, g), denom);
  }
  __device__ static S load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(S v) { return __float2bfloat16_rn(v); }
};

template <typename T>
__device__ __forceinline__ void copy_in(T* smem, const T* gmem) {
  if constexpr (sizeof(T) >= 4) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
                 "n"(static_cast<int>(sizeof(T)))
                 : "memory");
  } else {
    *smem = *gmem;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0-2) of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 2) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else if (pending == 1) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
}

__device__ __forceinline__ int64_t line_base(const LineLayout& g, int64_t l) {
  const int64_t j = l % g.J;
  const int64_t t = l / g.J;
  return g.base + (t / g.O) * g.sB + (t % g.O) * g.sO + j;
}

// Thomas, one lane per line: the path for rows at a stride (sI > 1), for
// bfloat16, and for what the segment path does not take (n == 1). Lanes
// hold neighbouring lines, which lie at neighbouring addresses where sI > 1,
// so each row's loads and stores are coalesced.
template <typename T>
__global__ void __launch_bounds__(kLines)
    line_solve_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                      const T* __restrict__ du, const T* __restrict__ b,
                      T* __restrict__ x, const LineLayout g, const int stages) {
  using A = Arith<T>;
  using S = typename A::S;
  constexpr bool kAsync = sizeof(T) >= 4;  // else rows are staged through registers
  extern __shared__ __align__(16) unsigned char smem[];
  S* s_c = reinterpret_cast<S*>(smem);                      // [n][kLines]
  S* s_g = s_c + static_cast<int64_t>(g.n) * kLines;          // [n][kLines]
  T* s_ring = reinterpret_cast<T*>(s_g + static_cast<int64_t>(g.n) * kLines);
  const int rc_rows = g.n < kRC ? g.n : kRC;   // rows a ring stage holds
  const int stage_elems = 4 * rc_rows * kLines;  // [4 arrays][rc_rows][kLines]

  const int lane = threadIdx.x;
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * kLines;
  const bool valid = l0 + lane < g.L;
  const int64_t base = valid ? line_base(g, l0 + lane) : 0;
  const int n = g.n;
  const int nchunks = (n + kRC - 1) / kRC;
  const T* src[4] = {dl, d, du, b};
  auto rows_of = [&](int k) { return n - k * kRC < kRC ? n - k * kRC : kRC; };
  auto offset = [&](int k, int r) { return base + static_cast<int64_t>(k * kRC + r) * g.sI; };

  auto load_chunk = [&](int k) {
    T* st = s_ring + (k % stages) * stage_elems + lane;
    if (!valid) return;
    for (int r = 0; r < rows_of(k); ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) copy_in(st + (q * rc_rows + r) * kLines, src[q] + offset(k, r));
    }
  };
  // 2-byte rows: the next chunk waits in registers.
  T held[4][kRC];
  auto fetch = [&](int k) {
#pragma unroll
    for (int r = 0; r < kRC; ++r) {
      if (valid && r < rows_of(k)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) held[q][r] = src[q][offset(k, r)];
      }
    }
  };
  auto put = [&](int k) {
    T* st = s_ring + (k % stages) * stage_elems + lane;
#pragma unroll
    for (int r = 0; r < kRC; ++r) {
      if (valid && r < rows_of(k)) {
#pragma unroll
        for (int q = 0; q < 4; ++q) st[(q * rc_rows + r) * kLines] = held[q][r];
      }
    }
  };

  for (int k = 0; k < stages - 1; ++k) {
    if constexpr (kAsync) {
      load_chunk(k);
      cp_async_commit();
    } else {
      fetch(k);
      put(k);
    }
  }
  S c_prev = S(0);
  S g_prev = S(0);
  for (int k = 0; k < nchunks; ++k) {
    const bool ahead = k + stages - 1 < nchunks;
    if constexpr (kAsync) {
      if (ahead) load_chunk(k + stages - 1);
      cp_async_commit();
      cp_async_wait(stages - 1);  // chunk k has landed
    } else {
      if (ahead) fetch(k + stages - 1);
    }
    if (valid) {
      const T* st = s_ring + (k % stages) * stage_elems + lane;
      const int i0 = k * kRC;
      for (int r = 0; r < rows_of(k); ++r) {
        const S dl_i = A::load(st[(0 * rc_rows + r) * kLines]);
        const S d_i = A::load(st[(1 * rc_rows + r) * kLines]);
        const S du_i = A::load(st[(2 * rc_rows + r) * kLines]);
        const S b_i = A::load(st[(3 * rc_rows + r) * kLines]);
        A::step(dl_i, d_i, du_i, b_i, c_prev, g_prev);
        s_c[(i0 + r) * kLines + lane] = c_prev;
        s_g[(i0 + r) * kLines + lane] = g_prev;
      }
    }
    if constexpr (!kAsync) {
      if (ahead) put(k + stages - 1);  // into the stage chunk k - 1 used
    }
  }

  if (valid) {
    S x_next = S(0);
    for (int i = n - 1; i >= 0; --i) {
      x_next = A::fms(s_g[i * kLines + lane], s_c[i * kLines + lane], x_next);
      x[base + static_cast<int64_t>(i) * g.sI] = A::store(x_next);
    }
  }
}

// Segments on contiguous lines (sI == 1, n >= 2), float32/float64. A block
// holds tile_lines whole lines; thread t * segs + k takes segment k of line
// t, rows [k n / segs, (k + 1) n / segs) - between 2 and kSegRows rows.
// Within a segment of m rows, local rows 1..m-1 are eliminated downwards
// against the segment's first unknown x_0 and upwards against its last
// x_{m-1}, so that every row reads
//   x_i + a_i x_0 + c_i x_{m-1} = d_i         (0 < i < m - 1),
// and the first and last rows give the reduced system's two equations for
// segment k, coupling x_0 to the previous segment's last unknown and
// x_{m-1} to the next segment's first (tridiagonal in the order first,
// last, first, last, ...).
template <typename T>
__global__ void __launch_bounds__(kSegThreads)
    segment_solve_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                         const T* __restrict__ du, const T* __restrict__ b,
                         T* __restrict__ x, const LineLayout g, const int segs,
                         const int tile_lines) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = g.n;
  const int tile = tile_lines * n;        // elements of one array's tile
  const int red = tile_lines * 2 * segs;  // elements of one reduced array
  int64_t* s_base = reinterpret_cast<int64_t*>(smem);   // [tile_lines]
  T* s_tile = reinterpret_cast<T*>(s_base + tile_lines);  // [dl, d, du, b][line][row]
  T* s_red = s_tile + 4 * tile;                         // [lo, diag, up, rhs][line][2 segs]

  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * tile_lines;
  const int nlines = static_cast<int>(g.L - l0 < tile_lines ? g.L - l0 : tile_lines);
  for (int t = threadIdx.x; t < nlines; t += blockDim.x) s_base[t] = line_base(g, l0 + t);
  __syncthreads();
  const T* src[4] = {dl, d, du, b};
  const int elems = nlines * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int t = e / n;
    const int64_t off = s_base[t] + (e - t * n);
#pragma unroll
    for (int q = 0; q < 4; ++q) copy_in(s_tile + q * tile + e, src[q] + off);
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  const int t = threadIdx.x / segs;
  const int k = threadIdx.x - t * segs;
  const bool active = t < nlines;
  const int r0 = (k * n) / segs;
  const int m = ((k + 1) * n) / segs - r0;
  T ap[kSegRows], cp[kSegRows], dp[kSegRows];
  if (active) {
    const T* Lo = s_tile + t * n + r0;
    const T* Di = Lo + tile;
    const T* Up = Lo + 2 * tile;
    const T* Rh = Lo + 3 * tile;
    T a_e = T(0), c_e = T(0), d_e = T(0);
    // Downwards: x_i + cp_i x_{i+1} + ap_i x_0 = dp_i.
#pragma unroll
    for (int i = 1; i < kSegRows; ++i) {
      if (i < m) {
        const T up = r0 + i == n - 1 ? T(0) : Up[i];
        if (i == 1) {
          const T inv = A::rcp(Di[1]);
          ap[1] = Lo[1] * inv;
          cp[1] = up * inv;
          dp[1] = Rh[1] * inv;
        } else {
          const T inv = A::rcp(Di[i] - Lo[i] * cp[i - 1]);
          ap[i] = -Lo[i] * ap[i - 1] * inv;
          cp[i] = up * inv;
          dp[i] = (Rh[i] - Lo[i] * dp[i - 1]) * inv;
        }
        a_e = ap[i];
        c_e = cp[i];
        d_e = dp[i];
      }
    }
    // Upwards from row m - 2, with row m - 1 read as x_{m-1} = x_{m-1}:
    // x_i + ap_i x_0 + cp_i x_{m-1} = dp_i.
    T an = T(0), cn = T(-1), dn = T(0);
#pragma unroll
    for (int i = kSegRows - 2; i >= 1; --i) {
      if (i <= m - 2) {
        dp[i] -= cp[i] * dn;
        ap[i] -= cp[i] * an;
        cp[i] = -cp[i] * cn;
        an = ap[i];
        cn = cp[i];
        dn = dp[i];
      }
    }
    // Reduced rows: first (lo couples the previous segment's last unknown,
    // up this segment's last) and last (lo couples this segment's first,
    // up the next segment's first).
    T* R = s_red + t * 2 * segs + 2 * k;
    const T lo0 = r0 == 0 ? T(0) : Lo[0];
    R[0] = lo0;
    R[red] = Di[0] - Up[0] * an;
    R[2 * red] = -Up[0] * cn;
    R[3 * red] = Rh[0] - Up[0] * dn;
    R[1] = a_e;
    R[red + 1] = T(1);
    R[2 * red + 1] = c_e;
    R[3 * red + 1] = d_e;
  }
  __syncthreads();
  if (threadIdx.x < nlines) {
    // The reduced system of one line, Thomas in place: its solution
    // replaces the right-hand side.
    T* rl = s_red + threadIdx.x * 2 * segs;
    T* rd = rl + red;
    T* ru = rl + 2 * red;
    T* rr = rl + 3 * red;
    T c = T(0), gg = T(0);
    for (int i = 0; i < 2 * segs; ++i) {
      A::step(rl[i], rd[i], ru[i], rr[i], c, gg);
      ru[i] = c;
      rr[i] = gg;
    }
    T x_next = T(0);
    for (int i = 2 * segs - 1; i >= 0; --i) {
      x_next = rr[i] - ru[i] * x_next;
      rr[i] = x_next;
    }
  }
  __syncthreads();
  if (active) {
    const T* R = s_red + 3 * red + t * 2 * segs + 2 * k;
    const T x0 = R[0];
    const T xm = R[1];
    T* X = s_tile + 3 * tile + t * n + r0;  // over b, read by nobody any more
    X[0] = x0;
#pragma unroll
    for (int i = 1; i < kSegRows - 1; ++i) {
      if (i <= m - 2) X[i] = dp[i] - ap[i] * x0 - cp[i] * xm;
    }
    X[m - 1] = xm;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int tt = e / n;
    x[s_base[tt] + (e - tt * n)] = s_tile[3 * tile + e];
  }
}

// Opt `kernel` in above the 48 KB of shared memory a launch gets by
// default, once per device and size (`configured` is the kernel's own).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t* configured) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 0 && dev < 64 && smem <= configured[dev]) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e == cudaSuccess && dev >= 0 && dev < 64) configured[dev] = smem;
  return e;
}

template <typename T>
int launch_lines(const T* dl, const T* d, const T* du, const T* b, T* x, const LineLayout& g,
                 cudaStream_t stream) {
  using S = typename Arith<T>::S;
  static size_t configured[64] = {};
  // Ring stages of kRC rows, measured on the H100 at the main paths'
  // M(w)^{-1} shapes (PERF.md): short chunks leave shared memory for more
  // warps per SM. float32 takes three stages, float64 two. 2-byte rows take
  // two, since the next chunk waits in registers, and keep both: a chunk is
  // put into the ring only after the previous chunk's recurrence.
  int stages = sizeof(T) == 4 ? 3 : 2;
  const int rc_rows = g.n < kRC ? g.n : kRC;
  const int nchunks = (g.n + kRC - 1) / kRC;
  if (sizeof(T) >= 4 && nchunks < stages) stages = nchunks;
  const size_t smem = 2 * static_cast<size_t>(g.n) * kLines * sizeof(S) +
                      static_cast<size_t>(stages) * 4 * rc_rows * kLines * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(line_solve_kernel<T>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (g.L + kLines - 1) / kLines;
  line_solve_kernel<T><<<static_cast<unsigned int>(blocks), kLines, smem, stream>>>(
      dl, d, du, b, x, g, stages);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segments(const T* dl, const T* d, const T* du, const T* b, T* x, const LineLayout& g,
                    cudaStream_t stream) {
  static size_t configured[64] = {};
  const int segs = (g.n + kSegRows - 1) / kSegRows;
  const int tile_lines = kSegThreads / segs;
  const size_t smem = tile_lines * sizeof(int64_t) +
                      4 * static_cast<size_t>(tile_lines) * (g.n + 2 * segs) * sizeof(T);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(segment_solve_kernel<T>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t blocks = (g.L + tile_lines - 1) / tile_lines;
  segment_solve_kernel<T><<<static_cast<unsigned int>(blocks), kSegThreads, smem, stream>>>(
      dl, d, du, b, x, g, segs, tile_lines);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* dl, const void* d, const void* du, const void* b, void* x,
           const LineLayout& g, void* stream) {
  if (g.L <= 0 || g.n <= 0) return 0;
  if (g.J <= 0 || g.O <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pdl = static_cast<const T*>(dl);
  const auto* pd = static_cast<const T*>(d);
  const auto* pdu = static_cast<const T*>(du);
  const auto* pb = static_cast<const T*>(b);
  auto* px = static_cast<T*>(x);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) >= 4) {
    if (g.sI == 1 && g.n >= 2 && (g.n + kSegRows - 1) / kSegRows <= kSegThreads) {
      return launch_segments<T>(pdl, pd, pdu, pb, px, g, s);
    }
  }
  return launch_lines<T>(pdl, pd, pdu, pb, px, g, s);
}

}  // namespace

extern "C" {

// int thomas_lines_{f32,f64,bf16}(dl, d, du, b, x, n, L, J, O, sO, sB, sI,
//                                  base, stream): every pointer to the
// element type; the layout in elements (see LineLayout above).
#define K1_ENTRY(NAME, T)                                                                \
  int NAME(const void* dl, const void* d, const void* du, const void* b, void* x, int n, \
           int64_t L, int64_t J, int64_t O, int64_t sO, int64_t sB, int64_t sI,          \
           int64_t base, void* stream) {                                                 \
    const LineLayout g{n, L, J, O, sO, sB, sI, base};                                    \
    return launch<T>(dl, d, du, b, x, g, stream);                                        \
  }

K1_ENTRY(thomas_lines_f32, float)
K1_ENTRY(thomas_lines_f64, double)
K1_ENTRY(thomas_lines_bf16, __nv_bfloat16)

#undef K1_ENTRY

}  // extern "C"
