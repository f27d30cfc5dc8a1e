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
// float64, 880 in float32 and bfloat16) are refused
// (cudaErrorInvalidValue).
//
// bfloat16 tables (the line smoother with a bf16 preconditioner state)
// always take the Thomas path: they load and store bf16 and run the
// recurrence in float32 with c and g in float32, written with
// round-to-nearest intrinsics so nvcc cannot contract them into FMAs: each
// step then rounds exactly as the plain version's float32 tensor ops do,
// and the two agree bit for bit. cp.async moves 4, 8 or 16 bytes, so 2-byte
// rows are fetched into registers before a chunk's recurrence and stored
// into the ring after it, which keeps the loads in flight meanwhile.

//
// Several right-hand sides per table set (R >= 1): the stacked
// primal + adjoint Schur solve applies M(w)^{-1} to two vectors per sample
// (R = 2), and the static Schur multigrid's line smoother solves one
// (n, L) table set for every sample of the batch (R = batch). The tables
// are addressed by the layout; right-hand side r of line l, row i lives at
//   base + bb * sBb + o * sO + i * sI + j + r * sR
// (b and x may have their own batch stride sBb, since R vectors per sample
// lie between two samples' rows). A block takes a group of up to kMaxGroup
// (Thomas path) or kMaxSegGroup (segment path) right-hand sides of its
// lines (blockIdx.y walks the groups): it reads its rows of dl, d, du once,
// computes the pivots and c once, and carries one g (and x) recurrence per
// right-hand side, so the least traffic is 3 words per unknown for the
// tables plus 2 R for b and x. A group costs shared memory (one more g per
// right-hand side) and with it warps per SM, so the Thomas path picks its
// group by what it can see of the launch (pick_group): tables small enough
// for L2 that many right-hand sides share are read once per right-hand
// side by groups of one. One vector laid out like the tables (R = 1,
// sBb = sB) is a group of one with the groups' tests and second addressing
// compiled out: the single-vector solve of the Schur CG, at its earlier
// speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLines = 32;          // lines per block: one warp, a lane per line
constexpr int kMaxSmem = 232448;    // bytes of shared memory a block may use
constexpr int kRC = 4;              // Thomas path: rows per ring chunk (2-byte rows: in registers)
constexpr int kSegRows = 16;        // segment path: most rows a thread eliminates
constexpr int kSegThreads = 128;    // segment path: threads per block
constexpr int kMaxGroup = 4;        // Thomas path: most right-hand sides a block carries
constexpr int kMaxSegGroup = 2;     // segment path: the same (its rows wait in registers)
constexpr size_t kSmemPerSM = 233472;  // bytes of shared memory an SM has (228 KB)
constexpr size_t kMaxBlocksPerSM = 32;
constexpr size_t kL2TableBytes = 16u << 20;  // tables this small stay in the 50 MB L2

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

// R right-hand sides per table set: b and x of right-hand side r lie r * sR
// after the first, with sB between batch members (the tables keep the
// layout's own sB).
struct RhsLayout {
  int R;
  int64_t sR;
  int64_t sB;
};

// Arithmetic per storage type: S is the type of the recurrence and of c, g.
// One forward step: c = du / denom, g = (b - dl g_prev) / denom with
// denom = d - dl c_prev, split into the pivot (once per row) and the c and
// g updates (g once per right-hand side). float32 and float64 take one
// correctly rounded reciprocal as the pivot and two products (a shorter
// dependent chain than two divisions; within an ulp of them); bfloat16
// tables keep denom as the pivot and divide with round-to-nearest
// intrinsics, as the plain version's float32 ops do.
template <typename T>
struct Arith {
  using S = T;
  __device__ static S fms(S a, S b, S c) { return a - b * c; }
  __device__ static S pivot(S dl, S d, S c) { return rcp(d - dl * c); }
  __device__ static S next_c(S du, S piv) { return du * piv; }
  __device__ static S next_g(S b, S dl, S g, S piv) { return (b - dl * g) * piv; }
  __device__ static float rcp(float v) { return __frcp_rn(v); }
  __device__ static double rcp(double v) { return __drcp_rn(v); }
  __device__ static S load(T v) { return v; }
  __device__ static T store(S v) { return v; }
};

template <>
struct Arith<__nv_bfloat16> {
  using S = float;
  __device__ static S fms(S a, S b, S c) { return __fsub_rn(a, __fmul_rn(b, c)); }
  __device__ static S pivot(S dl, S d, S c) { return fms(d, dl, c); }
  __device__ static S next_c(S du, S piv) { return __fdiv_rn(du, piv); }
  __device__ static S next_g(S b, S dl, S g, S piv) { return __fdiv_rn(fms(b, dl, g), piv); }
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

// Offset of line l's first row, with sB between batch members (the
// layout's for the tables, the right-hand sides' own for b and x).
__device__ __forceinline__ int64_t line_base(const LineLayout& g, int64_t l, int64_t sB) {
  const int64_t j = l % g.J;
  const int64_t t = l / g.J;
  return g.base + (t / g.O) * sB + (t % g.O) * g.sO + j;
}

// Thomas, one lane per line: the path for rows at a stride (sI > 1), for
// bfloat16, and for what the segment path does not take (n == 1). Lanes
// hold neighbouring lines, which lie at neighbouring addresses where sI > 1,
// so each row's loads and stores are coalesced. The block carries the
// right-hand sides [RG * blockIdx.y, RG * blockIdx.y + nr) of its lines;
// with kOwn they have their own addressing (rhs), else b and x are one
// vector laid out like the tables.
template <typename T, int RG, bool kOwn>
__global__ void __launch_bounds__(kLines)
    line_solve_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                      const T* __restrict__ du, const T* __restrict__ b,
                      T* __restrict__ x, const LineLayout g, const RhsLayout rhs,
                      const int stages) {
  using A = Arith<T>;
  using S = typename A::S;
  constexpr bool kAsync = sizeof(T) >= 4;  // else rows are staged through registers
  constexpr int kArr = 3 + RG;             // arrays a ring stage holds: dl, d, du, b_0..
  extern __shared__ __align__(16) unsigned char smem[];
  S* s_c = reinterpret_cast<S*>(smem);                      // [n][kLines]
  S* s_g = s_c + static_cast<int64_t>(g.n) * kLines;          // [RG][n][kLines]
  T* s_ring = reinterpret_cast<T*>(s_g + static_cast<int64_t>(RG) * g.n * kLines);
  const int rc_rows = g.n < kRC ? g.n : kRC;   // rows a ring stage holds
  const int stage_elems = kArr * rc_rows * kLines;  // [kArr arrays][rc_rows][kLines]

  const int lane = threadIdx.x;
  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * kLines;
  const bool valid = l0 + lane < g.L;
  const int r0 = static_cast<int>(blockIdx.y) * RG;
  // Right-hand sides of this block: a constant in a group of one, so that
  // its loops carry nothing of the groups; the single-vector solve (!kOwn)
  // also shares the tables' addressing.
  const int nr = RG == 1 ? 1 : (rhs.R - r0 < RG ? rhs.R - r0 : RG);
  const int64_t base = valid ? line_base(g, l0 + lane, g.sB) : 0;
  const int64_t base_b =
      !kOwn ? base : (valid ? line_base(g, l0 + lane, rhs.sB) + r0 * rhs.sR : 0);
  const int n = g.n;
  const int nchunks = (n + kRC - 1) / kRC;
  // This lane's line in every array: row i lies i * sI further on.
  const T* src[kArr] = {dl + base, d + base, du + base};
#pragma unroll
  for (int q = 0; q < RG; ++q) src[3 + q] = b + base_b + q * rhs.sR;
  auto rows_of = [&](int k) { return n - k * kRC < kRC ? n - k * kRC : kRC; };
  auto row_off = [&](int k, int r) { return static_cast<int64_t>(k * kRC + r) * g.sI; };

  auto load_chunk = [&](int k) {
    T* st = s_ring + (k % stages) * stage_elems + lane;
    if (!valid) return;
    for (int r = 0; r < rows_of(k); ++r) {
      const int64_t off = row_off(k, r);
#pragma unroll
      for (int q = 0; q < kArr; ++q) {
        if (q < 3 + nr) copy_in(st + (q * rc_rows + r) * kLines, src[q] + off);
      }
    }
  };
  // 2-byte rows: the next chunk waits in registers.
  T held[kArr][kRC];
  auto fetch = [&](int k) {
#pragma unroll
    for (int r = 0; r < kRC; ++r) {
      if (valid && r < rows_of(k)) {
        const int64_t off = row_off(k, r);
#pragma unroll
        for (int q = 0; q < kArr; ++q) {
          if (q < 3 + nr) held[q][r] = src[q][off];
        }
      }
    }
  };
  auto put = [&](int k) {
    T* st = s_ring + (k % stages) * stage_elems + lane;
#pragma unroll
    for (int r = 0; r < kRC; ++r) {
      if (valid && r < rows_of(k)) {
#pragma unroll
        for (int q = 0; q < kArr; ++q) {
          if (q < 3 + nr) st[(q * rc_rows + r) * kLines] = held[q][r];
        }
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
  S g_prev[RG];
#pragma unroll
  for (int q = 0; q < RG; ++q) g_prev[q] = S(0);
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
        // Every load of the row before any store: the compiler must keep
        // shared-memory loads behind earlier shared-memory stores.
        const S dl_i = A::load(st[(0 * rc_rows + r) * kLines]);
        const S d_i = A::load(st[(1 * rc_rows + r) * kLines]);
        const S du_i = A::load(st[(2 * rc_rows + r) * kLines]);
        S b_i[RG];
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          if (q < nr) b_i[q] = A::load(st[((3 + q) * rc_rows + r) * kLines]);
        }
        const S piv = A::pivot(dl_i, d_i, c_prev);
        c_prev = A::next_c(du_i, piv);
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          if (q < nr) g_prev[q] = A::next_g(b_i[q], dl_i, g_prev[q], piv);
        }
        s_c[(i0 + r) * kLines + lane] = c_prev;
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          if (q < nr) s_g[((q * n) + i0 + r) * kLines + lane] = g_prev[q];
        }
      }
    }
    if constexpr (!kAsync) {
      if (ahead) put(k + stages - 1);  // into the stage chunk k - 1 used
    }
  }

  if (valid) {
    S x_next[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) x_next[q] = S(0);
    for (int i = n - 1; i >= 0; --i) {
      const S c_i = s_c[i * kLines + lane];
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        if (q < nr) {
          x_next[q] = A::fms(s_g[(q * n + i) * kLines + lane], c_i, x_next[q]);
          x[base_b + q * rhs.sR + static_cast<int64_t>(i) * g.sI] = A::store(x_next[q]);
        }
      }
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
// last, first, last, ...). a_i and c_i come from the tables alone; each of
// the block's right-hand sides (RG of them, nr in use) has its own d_i.
template <typename T, int RG>
__global__ void __launch_bounds__(kSegThreads)
    segment_solve_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                         const T* __restrict__ du, const T* __restrict__ b,
                         T* __restrict__ x, const LineLayout g, const RhsLayout rhs,
                         const int segs, const int tile_lines) {
  using A = Arith<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = g.n;
  const int tile = tile_lines * n;        // elements of one array's tile
  const int red = tile_lines * 2 * segs;  // elements of one reduced array
  // A group of one is the single-vector solve, whose b and x share the
  // tables' addressing (the launcher sees to it): one array of bases there.
  constexpr int kBases = RG == 1 ? 1 : 2;
  int64_t* s_base = reinterpret_cast<int64_t*>(smem);     // [tile_lines] tables
  int64_t* s_base_b = s_base + (kBases - 1) * tile_lines;  // [tile_lines] b and x
  T* s_tile = reinterpret_cast<T*>(s_base + kBases * tile_lines);  // [dl, d, du, b_0..][line][row]
  T* s_red = s_tile + (3 + RG) * tile;                    // [lo, diag, up, rhs_0..][line][2 segs]

  const int64_t l0 = static_cast<int64_t>(blockIdx.x) * tile_lines;
  const int nlines = static_cast<int>(g.L - l0 < tile_lines ? g.L - l0 : tile_lines);
  const int q0 = static_cast<int>(blockIdx.y) * RG;
  const int nr = RG == 1 ? 1 : (rhs.R - q0 < RG ? rhs.R - q0 : RG);  // of this block
  for (int t = threadIdx.x; t < nlines; t += blockDim.x) {
    s_base[t] = line_base(g, l0 + t, g.sB);
    if constexpr (RG > 1) s_base_b[t] = line_base(g, l0 + t, rhs.sB) + q0 * rhs.sR;
  }
  __syncthreads();
  const T* tab[3] = {dl, d, du};
  const int elems = nlines * n;
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int t = e / n;
    const int64_t off = s_base[t] + (e - t * n);
#pragma unroll
    for (int q = 0; q < 3; ++q) copy_in(s_tile + q * tile + e, tab[q] + off);
    const int64_t off_b = RG == 1 ? off : s_base_b[t] + (e - t * n);
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      if (q < nr) copy_in(s_tile + (3 + q) * tile + e, b + off_b + q * rhs.sR);
    }
  }
  cp_async_commit();
  cp_async_wait(0);
  __syncthreads();

  const int t = threadIdx.x / segs;
  const int k = threadIdx.x - t * segs;
  const bool active = t < nlines;
  const int r0 = (k * n) / segs;
  const int m = ((k + 1) * n) / segs - r0;
  T ap[kSegRows], cp[kSegRows], dp[RG][kSegRows];
  if (active) {
    const T* Lo = s_tile + t * n + r0;
    const T* Di = Lo + tile;
    const T* Up = Lo + 2 * tile;
    const T* Rh = Lo + 3 * tile;  // right-hand side q at Rh + q * tile
    T a_e = T(0), c_e = T(0), d_e[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) d_e[q] = T(0);
    // Downwards: x_i + cp_i x_{i+1} + ap_i x_0 = dp_i.
#pragma unroll
    for (int i = 1; i < kSegRows; ++i) {
      if (i < m) {
        const T up = r0 + i == n - 1 ? T(0) : Up[i];
        if (i == 1) {
          const T inv = A::rcp(Di[1]);
          ap[1] = Lo[1] * inv;
          cp[1] = up * inv;
#pragma unroll
          for (int q = 0; q < RG; ++q) {
            if (q < nr) dp[q][1] = Rh[q * tile + 1] * inv;
          }
        } else {
          const T inv = A::rcp(Di[i] - Lo[i] * cp[i - 1]);
          ap[i] = -Lo[i] * ap[i - 1] * inv;
          cp[i] = up * inv;
#pragma unroll
          for (int q = 0; q < RG; ++q) {
            if (q < nr) dp[q][i] = (Rh[q * tile + i] - Lo[i] * dp[q][i - 1]) * inv;
          }
        }
        a_e = ap[i];
        c_e = cp[i];
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          if (q < nr) d_e[q] = dp[q][i];
        }
      }
    }
    // Upwards from row m - 2, with row m - 1 read as x_{m-1} = x_{m-1}:
    // x_i + ap_i x_0 + cp_i x_{m-1} = dp_i.
    T an = T(0), cn = T(-1), dn[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) dn[q] = T(0);
#pragma unroll
    for (int i = kSegRows - 2; i >= 1; --i) {
      if (i <= m - 2) {
#pragma unroll
        for (int q = 0; q < RG; ++q) {
          if (q < nr) {
            dp[q][i] -= cp[i] * dn[q];
            dn[q] = dp[q][i];
          }
        }
        ap[i] -= cp[i] * an;
        cp[i] = -cp[i] * cn;
        an = ap[i];
        cn = cp[i];
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
    R[1] = a_e;
    R[red + 1] = T(1);
    R[2 * red + 1] = c_e;
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      if (q < nr) {
        R[(3 + q) * red] = Rh[q * tile] - Up[0] * dn[q];
        R[(3 + q) * red + 1] = d_e[q];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < nlines) {
    // The reduced system of one line, Thomas in place: its solutions
    // replace the right-hand sides.
    T* rl = s_red + threadIdx.x * 2 * segs;
    T* rd = rl + red;
    T* ru = rl + 2 * red;
    T* rr = rl + 3 * red;  // right-hand side q at rr + q * red
    T c = T(0), gg[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) gg[q] = T(0);
    for (int i = 0; i < 2 * segs; ++i) {
      const T lo = rl[i];
      T rhs_i[RG];
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        if (q < nr) rhs_i[q] = rr[q * red + i];
      }
      const T piv = A::pivot(lo, rd[i], c);
      c = A::next_c(ru[i], piv);
      ru[i] = c;
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        if (q < nr) {
          gg[q] = A::next_g(rhs_i[q], lo, gg[q], piv);
          rr[q * red + i] = gg[q];
        }
      }
    }
    T x_next[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) x_next[q] = T(0);
    for (int i = 2 * segs - 1; i >= 0; --i) {
#pragma unroll
      for (int q = 0; q < RG; ++q) {
        if (q < nr) {
          x_next[q] = rr[q * red + i] - ru[i] * x_next[q];
          rr[q * red + i] = x_next[q];
        }
      }
    }
  }
  __syncthreads();
  if (active) {
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      if (q < nr) {
        const T* R = s_red + (3 + q) * red + t * 2 * segs + 2 * k;
        const T x0 = R[0];
        const T xm = R[1];
        T* X = s_tile + (3 + q) * tile + t * n + r0;  // over b, read by nobody any more
        X[0] = x0;
#pragma unroll
        for (int i = 1; i < kSegRows - 1; ++i) {
          if (i <= m - 2) X[i] = dp[q][i] - ap[i] * x0 - cp[i] * xm;
        }
        X[m - 1] = xm;
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < elems; e += blockDim.x) {
    const int tt = e / n;
    const int64_t off_b = (RG == 1 ? s_base[tt] : s_base_b[tt]) + (e - tt * n);
#pragma unroll
    for (int q = 0; q < RG; ++q) {
      if (q < nr) x[off_b + q * rhs.sR] = s_tile[(3 + q) * tile + e];
    }
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

// Groups of RG right-hand sides along blockIdx.y.
inline unsigned int groups_of(int R, int RG) { return static_cast<unsigned int>((R + RG - 1) / RG); }

template <typename T, int RG>
size_t lines_smem(const LineLayout& g, int stages) {
  using S = typename Arith<T>::S;
  const int rc_rows = g.n < kRC ? g.n : kRC;
  return (1 + RG) * static_cast<size_t>(g.n) * kLines * sizeof(S) +
         static_cast<size_t>(stages) * (3 + RG) * rc_rows * kLines * sizeof(T);
}

template <typename T, int RG, bool kOwn>
int launch_lines_group(const T* dl, const T* d, const T* du, const T* b, T* x,
                       const LineLayout& g, const RhsLayout& rhs, int stages,
                       cudaStream_t stream) {
  static size_t configured[64] = {};
  const size_t smem = lines_smem<T, RG>(g, stages);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(line_solve_kernel<T, RG, kOwn>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned int>((g.L + kLines - 1) / kLines), groups_of(rhs.R, RG));
  line_solve_kernel<T, RG, kOwn><<<grid, kLines, smem, stream>>>(dl, d, du, b, x, g, rhs, stages);
  return static_cast<int>(cudaGetLastError());
}

// One-warp blocks of `smem` bytes an SM holds at once (each block also
// takes 1 KB of the SM's shared memory for the system).
inline int blocks_per_sm(size_t smem) {
  const size_t fit = kSmemPerSM / (smem + 1024);
  return fit > kMaxBlocksPerSM ? kMaxBlocksPerSM : static_cast<int>(fit);
}

// SMs of the current device.
inline int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    sms[dev] = 132;
  }
  return sms[dev];
}

// Right-hand sides a block carries (1, 2 or kMaxGroup) when b and x have
// their own addressing. A larger group reads the tables less often but
// takes one more g of shared memory per right-hand side, so fewer warps fit
// an SM, and the solve is bound by the latency of its rows, not by bytes,
// once few warps are resident. Measured on the H100 (PERF.md):
// - where the largest group's blocks are all resident at once, take it
//   (the time is one block's, and its recurrences overlap);
// - else, tables small enough to stay in L2 (the static multigrid's, shared
//   by the batch) cost nothing to read again: a group of one, the most
//   warps per SM (n 110, 128 right-hand sides: 0.16 ms against 0.17 and
//   0.25 with groups of two and four);
// - else (a sample's own tables, streamed from device memory: M(w)^{-1} of
//   the stacked adjoint) the largest group, which moves the fewest bytes.
template <typename T>
int pick_group(const LineLayout& g, int R, int stages) {
  if (R == 1) return 1;
  const bool four = R > 2 && lines_smem<T, kMaxGroup>(g, stages) <= static_cast<size_t>(kMaxSmem);
  const int big = four ? kMaxGroup : 2;
  const size_t smem_big = four ? lines_smem<T, kMaxGroup>(g, stages) : lines_smem<T, 2>(g, stages);
  if (smem_big > static_cast<size_t>(kMaxSmem)) return 1;  // only a group of one fits
  const int64_t blocks = (g.L + kLines - 1) / kLines * groups_of(R, big);
  if (blocks <= static_cast<int64_t>(sm_count()) * blocks_per_sm(smem_big)) return big;
  const size_t table_bytes = 3 * sizeof(T) * static_cast<size_t>(g.n) * static_cast<size_t>(g.L);
  return table_bytes <= kL2TableBytes ? 1 : big;
}

template <typename T>
int launch_lines(const T* dl, const T* d, const T* du, const T* b, T* x, const LineLayout& g,
                 const RhsLayout& rhs, cudaStream_t stream) {
  // Ring stages of kRC rows, measured on the H100 at the main paths'
  // M(w)^{-1} shapes (PERF.md): short chunks leave shared memory for more
  // warps per SM. float32 takes three stages, float64 two. 2-byte rows take
  // two, since the next chunk waits in registers, and keep both: a chunk is
  // put into the ring only after the previous chunk's recurrence.
  int stages = sizeof(T) == 4 ? 3 : 2;
  const int nchunks = (g.n + kRC - 1) / kRC;
  if (sizeof(T) >= 4 && nchunks < stages) stages = nchunks;
  if (rhs.R == 1 && rhs.sB == g.sB) {  // one vector laid out like the tables
    return launch_lines_group<T, 1, false>(dl, d, du, b, x, g, rhs, stages, stream);
  }
  const int group = pick_group<T>(g, rhs.R, stages);
  if (group == kMaxGroup) {
    return launch_lines_group<T, kMaxGroup, true>(dl, d, du, b, x, g, rhs, stages, stream);
  }
  if (group == 2) return launch_lines_group<T, 2, true>(dl, d, du, b, x, g, rhs, stages, stream);
  return launch_lines_group<T, 1, true>(dl, d, du, b, x, g, rhs, stages, stream);
}

template <typename T, int RG>
size_t segments_smem(const LineLayout& g, int segs, int tile_lines) {
  return (RG == 1 ? 1 : 2) * tile_lines * sizeof(int64_t) +
         (3 + RG) * static_cast<size_t>(tile_lines) * (g.n + 2 * segs) * sizeof(T);
}

template <typename T, int RG>
int launch_segments_group(const T* dl, const T* d, const T* du, const T* b, T* x,
                          const LineLayout& g, const RhsLayout& rhs, int segs, int tile_lines,
                          cudaStream_t stream) {
  static size_t configured[64] = {};
  const size_t smem = segments_smem<T, RG>(g, segs, tile_lines);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = allow_smem(segment_solve_kernel<T, RG>, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned int>((g.L + tile_lines - 1) / tile_lines),
                  groups_of(rhs.R, RG));
  segment_solve_kernel<T, RG><<<grid, kSegThreads, smem, stream>>>(dl, d, du, b, x, g, rhs, segs,
                                                                   tile_lines);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_segments(const T* dl, const T* d, const T* du, const T* b, T* x, const LineLayout& g,
                    const RhsLayout& rhs, cudaStream_t stream) {
  const int segs = (g.n + kSegRows - 1) / kSegRows;
  const int tile_lines = kSegThreads / segs;
  if (rhs.R == 1 && rhs.sB == g.sB) {  // one vector laid out like the tables
    return launch_segments_group<T, 1>(dl, d, du, b, x, g, rhs, segs, tile_lines, stream);
  }
  return launch_segments_group<T, kMaxSegGroup>(dl, d, du, b, x, g, rhs, segs, tile_lines, stream);
}

template <typename T>
int launch(const void* dl, const void* d, const void* du, const void* b, void* x,
           const LineLayout& g, const RhsLayout& rhs, void* stream) {
  if (g.L <= 0 || g.n <= 0 || rhs.R <= 0) return 0;
  // The groups of right-hand sides lie along grid.y (at most 65535).
  if (g.J <= 0 || g.O <= 0 || rhs.R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pdl = static_cast<const T*>(dl);
  const auto* pd = static_cast<const T*>(d);
  const auto* pdu = static_cast<const T*>(du);
  const auto* pb = static_cast<const T*>(b);
  auto* px = static_cast<T*>(x);
  const auto s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) >= 4) {
    if (g.sI == 1 && g.n >= 2 && (g.n + kSegRows - 1) / kSegRows <= kSegThreads) {
      return launch_segments<T>(pdl, pd, pdu, pb, px, g, rhs, s);
    }
  }
  return launch_lines<T>(pdl, pd, pdu, pb, px, g, rhs, s);
}

}  // namespace

extern "C" {

// int thomas_lines_{f32,f64,bf16}(dl, d, du, b, x, n, L, J, O, sO, sB, sI,
//                                  base, R, sR, sBb, stream): every pointer
// to the element type; the layout in elements (see LineLayout and RhsLayout
// above: R right-hand sides sR apart, sBb between b's batch members).
#define K1_ENTRY(NAME, T)                                                                \
  int NAME(const void* dl, const void* d, const void* du, const void* b, void* x, int n, \
           int64_t L, int64_t J, int64_t O, int64_t sO, int64_t sB, int64_t sI,          \
           int64_t base, int R, int64_t sR, int64_t sBb, void* stream) {                 \
    const LineLayout g{n, L, J, O, sO, sB, sI, base};                                    \
    const RhsLayout rhs{R, sR, sBb};                                                     \
    return launch<T>(dl, d, du, b, x, g, rhs, stream);                                   \
  }

K1_ENTRY(thomas_lines_f32, float)
K1_ENTRY(thomas_lines_f64, double)
K1_ENTRY(thomas_lines_bf16, __nv_bfloat16)

#undef K1_ENTRY

}  // extern "C"
