// The structured coefMG V-cycle's grid passes as fused kernels: a
// Chebyshev or Jacobi smoothing step with its S apply, the residual with
// its restriction, and the prolongation with its add.
//
// Replaces no Pallas kernel: on the TPU, XLA fused these slices, pads and
// group sums of parelagmc_tpu/ops/coef_multigrid_structured.py itself. In
// PyTorch every one of them was a kernel of its own - about 14 full passes
// over the grid per S apply and some 500 launches a cycle, which is where
// the Krylov iteration's device time went. Caller: the cycle of
// parelagmc_tpu_torch/ops/coef_multigrid_structured.py (_cheb_first,
// _cheb_step, _jacobi, _residual_restrict, _prolong_add), eagerly or
// captured into its CUDA graph; the plain twins there are the same
// arithmetic in PyTorch ops.
//
// S is the 7-point face-conductance stencil of _s_apply_grid with a zero
// exterior: per mesh axis, flux t_k = d_k (u_{k-1} - u_k), and
//   (S u)_i = sum over axes of d_{i+1} (u_i - u_{i+1}) - d_i (u_{i-1} - u_i).
// Layout: cell grids (batch, z, y, x), x contiguous; the face grid of axis a
// has n_a + 1 entries along its own axis. Each tensor's grid is contiguous;
// its batch is up to two dims (b0, b1) with strides of its own, 0 where it
// broadcasts: the stacked solve's state has a singleton right-hand-side
// axis against the two vectors of r. A 2-D or 1-D grid runs with nz (and
// ny) 1 and no face grid for the missing axes.
//
// Precision: loads convert to float32 (float64 for a float64 state), the
// arithmetic runs in that type in the plain twin's order with
// round-to-nearest intrinsics (so nvcc contracts nothing into FMAs), and a
// value is rounded to the storage type only where it is stored. A stored
// value that the same step reads again (r before dvec, x before its last
// add) is read back as stored. So float32 and float64 follow the plain
// twin's operations one for one; bfloat16 rounds once per stored value
// where the twin rounds after every operation.
//
// What bounds them: device-memory bandwidth (a few flops per word), and,
// for 2-byte words, the instructions a cell costs. Threads run along the
// contiguous x axis of a plane (a block is a 32 x 8 tile), so every load
// and store of a warp is coalesced; a smoothing thread walks a column of
// four planes and carries the stencil's values below, at and above the
// cell and the z face below it from one plane to the next, so a cell loads
// one new z neighbour and one z face. The x and y neighbours and faces come
// from L1/L2 (a level-0 bf16 vector at batch 8 is 18 MB, within the 50 MB
// L2), so device memory sees each word about once. The least traffic per
// cell, in words: Chebyshev step 10 (x, r, dvec, idiag, 3 faces read; x,
// r, dvec written), its last step 8, first step 8 (b, x, idiag, faces; r,
// dvec), Jacobi sweep 7; residual with restriction 5 + 1/8 (the coarse
// sum), prolongation 2 + 1/8.
//
// Nothing is allocated here and nothing synchronizes: every output comes
// from the wrapper, the launch goes to the caller's stream, and each entry
// point returns cudaGetLastError - so the kernels run inside a CUDA graph
// capture as they do eagerly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

// A block is a tile of kTx x kTy cells of one z plane of one batch member:
// grid.x walks the x tiles, grid.y the y tiles of every plane (y tile
// fastest), grid.z the batch members, so a thread finds its cell with one
// block-uniform division and no per-cell one. Offsets inside a member are
// 32-bit (grid_of refuses grids whose faces would not fit).
constexpr int kTx = 32;
constexpr int kTy = 8;
constexpr int kThreads = kTx * kTy;
constexpr int kZ = 4;  // planes a smoothing thread walks
constexpr int kMaxGridYZ = 65535;

// Smoothing modes. kFirst: r = b - S x (b where x is null), dvec = w idiag r.
// kStep: x' = x + dvec, r' = r - S dvec, dvec' = a dvec + c idiag r'; with
// `last`, x' + dvec' alone. kJacobi: x' = x + w idiag (b - S x), w idiag b
// where x is null.
constexpr int kFirst = 0;
constexpr int kStep = 1;
constexpr int kJacobi = 2;

// Tensor slots of a smoothing step.
enum Slot { kX = 0, kB, kD, kIdiag, kFx, kFy, kFz, kXo, kRo, kDo, kSlots };

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// v as the storage type T holds it.
template <typename T> __device__ __forceinline__ float stored(float v) { return v; }
template <> __device__ __forceinline__ float stored<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
template <typename T> __device__ __forceinline__ double stored(double v) { return v; }

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }

struct Grid {
  int nx, ny, nz;  // cells per axis (1 for a missing axis)
  int n1;          // inner batch count: slot bb is (bb / n1, bb % n1)
};

// The three face grids of one batch member (null: no such axis).
template <typename T>
struct Faces {
  const T* x;
  const T* y;
  const T* z;
};

// The x and y terms of (S u) at cell c = (k, j, i) of the grid g, uc = u
// there, u and the faces at their batch member: each hi - lo, x first.
template <typename T>
__device__ __forceinline__ typename Acc<T>::type s_xy(const T* u, const Faces<T>& f,
                                                      typename Acc<T>::type uc, int i, int j,
                                                      int k, int c, const Grid& g) {
  using A = typename Acc<T>::type;
  const A zero = A(0);
  A lo = i > 0 ? load(u + c - 1) : zero;
  A hi = i + 1 < g.nx ? load(u + c + 1) : zero;
  const int fx = (k * g.ny + j) * (g.nx + 1) + i;
  A y = sub(mul(load(f.x + fx + 1), sub(uc, hi)), mul(load(f.x + fx), sub(lo, uc)));
  if (f.y != nullptr) {
    lo = j > 0 ? load(u + c - g.nx) : zero;
    hi = j + 1 < g.ny ? load(u + c + g.nx) : zero;
    const int fy = (k * (g.ny + 1) + j) * g.nx + i;
    y = add(y, sub(mul(load(f.y + fy + g.nx), sub(uc, hi)), mul(load(f.y + fy), sub(lo, uc))));
  }
  return y;
}

// The z term of (S u): u below, at and above the cell, and the faces below
// (flo) and above (fhi) it.
template <typename A>
__device__ __forceinline__ A s_z(A uc, A lo, A hi, A flo, A fhi) {
  return sub(mul(fhi, sub(uc, hi)), mul(flo, sub(lo, uc)));
}

// (S u) at cell (k, j, i): the x, y and z terms summed in that order, as
// the plain twin's _s_apply_grid does.
template <typename T>
__device__ __forceinline__ typename Acc<T>::type s_apply(const T* u, const Faces<T>& f, int i,
                                                         int j, int k, const Grid& g) {
  using A = typename Acc<T>::type;
  const int plane = g.nx * g.ny;
  const int c = k * plane + j * g.nx + i;
  const A uc = load(u + c);
  A y = s_xy(u, f, uc, i, j, k, c, g);
  if (f.z != nullptr) {
    const A lo = k > 0 ? load(u + c - plane) : A(0);
    const A hi = k + 1 < g.nz ? load(u + c + plane) : A(0);
    y = add(y, s_z(uc, lo, hi, load(f.z + c), load(f.z + c + plane)));
  }
  return y;
}

// The first cell (i, j, k) of this thread's column of KZ planes, in a grid
// of nty y tiles per plane; false past the grid's edge.
template <int KZ>
__device__ __forceinline__ bool locate(const Grid& g, int nty, int& i, int& j, int& k) {
  const int kb = static_cast<int>(blockIdx.y) / nty;
  i = static_cast<int>(blockIdx.x) * kTx + static_cast<int>(threadIdx.x);
  j = (static_cast<int>(blockIdx.y) - kb * nty) * kTy + static_cast<int>(threadIdx.y);
  k = kb * KZ;
  return i < g.nx && j < g.ny;
}

template <typename T>
struct SmoothArgs {
  T* p[kSlots];  // null where a slot is unused (kX: x = 0)
  int64_t s0[kSlots], s1[kSlots];
  Grid g;
  int nty;  // y tiles per plane
  double a, c, w;
  int last;
};

// Slot `slot`'s pointer at batch member (b0, b1).
template <typename S>
__device__ __forceinline__ auto at(const S& s, int slot, int64_t b0, int64_t b1) {
  return s.p[slot] == nullptr ? nullptr : s.p[slot] + b0 * s.s0[slot] + b1 * s.s1[slot];
}

// One thread walks kZ planes of its (i, j) column, upward: the stencil's
// input below, at and above the cell and the z face below it carry over
// from the plane before, so each plane loads one new value of each.
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) coefmg_smooth_kernel(const SmoothArgs<T> s) {
  using A = typename Acc<T>::type;
  const Grid& g = s.g;
  int i, j, k0;
  if (!locate<kZ>(g, s.nty, i, j, k0)) return;
  const int64_t b0 = blockIdx.z / g.n1, b1 = blockIdx.z % g.n1;
  const Faces<T> f{at(s, kFx, b0, b1), at(s, kFy, b0, b1), at(s, kFz, b0, b1)};
  const T* x = at(s, kX, b0, b1);
  const T* b = at(s, kB, b0, b1);
  const T* d = at(s, kD, b0, b1);
  const T* idiag = at(s, kIdiag, b0, b1);
  T* xo = at(s, kXo, b0, b1);
  T* ro = at(s, kRo, b0, b1);
  T* dout = at(s, kDo, b0, b1);
  const T* u = MODE == kStep ? d : x;  // the stencil's input; null: x = 0, no S term
  const A zero = A(0);
  const int plane = g.nx * g.ny;
  const int k1 = min(k0 + kZ, g.nz);
  int c = (k0 * g.ny + j) * g.nx + i;
  A ulo = zero, uc = zero, flo = zero;
  if (u != nullptr) {
    ulo = k0 > 0 ? load(u + c - plane) : zero;
    uc = load(u + c);
    if (f.z != nullptr) flo = load(f.z + c);
  }
  for (int k = k0; k < k1; ++k, c += plane) {
    A su = zero, uhi = zero;
    if (u != nullptr) {
      uhi = k + 1 < g.nz ? load(u + c + plane) : zero;
      su = s_xy(u, f, uc, i, j, k, c, g);
      if (f.z != nullptr) {
        const A fhi = load(f.z + c + plane);
        su = add(su, s_z(uc, ulo, uhi, flo, fhi));
        flo = fhi;
      }
    }
    const A idg = load(idiag + c);
    if (MODE == kFirst) {
      A r = load(b + c);
      if (x != nullptr) {
        r = stored<T>(sub(r, su));
        store(ro + c, r);
      }
      store(dout + c, mul(mul(A(s.w), idg), r));
    } else if (MODE == kStep) {
      const A xn = stored<T>(add(x != nullptr ? load(x + c) : zero, uc));
      const A rn = stored<T>(sub(load(b + c), su));
      const A dn = stored<T>(add(mul(A(s.a), uc), mul(A(s.c), mul(idg, rn))));
      if (s.last) {
        store(xo + c, add(xn, dn));
      } else {
        store(xo + c, xn);
        store(ro + c, rn);
        store(dout + c, dn);
      }
    } else {
      const A wd = mul(A(s.w), idg);
      const A bc = load(b + c);
      store(xo + c, x == nullptr ? mul(wd, bc) : add(uc, mul(wd, sub(bc, su))));
    }
    ulo = uc;
    uc = uhi;
  }
}

// Group [lo, hi) of fine cells of coarse cell c along one axis: pairs, the
// last group taking the 2-3 cells left over (fem/hierarchy.derefine_axis);
// a passthrough axis (n_c == n_f) maps each cell to itself.
__device__ __forceinline__ void group(int c, int nf, int nc, int& lo, int& hi) {
  if (nc == nf) {
    lo = c;
    hi = c + 1;
  } else {
    lo = 2 * c;
    hi = c + 1 < nc ? lo + 2 : nf;
  }
}

// Tensor slots of the transfers.
enum RSlot { kRx = 0, kRb, kRfx, kRfy, kRfz, kRout, kRSlots };
enum PSlot { kPx = 0, kPxc, kPout, kPSlots };

template <typename T, int N>
struct TransferArgs {
  T* p[N];
  int64_t s0[N], s1[N];
  Grid g;   // fine
  Grid gc;  // coarse (its n1 unused)
  int nty;  // y tiles per plane of the grid the threads walk
};

// rc = the group sums of b - S x over each coarse cell: one thread per
// coarse cell, summing its fine residuals x first, then y, then z, as the
// twin's per-axis group sums do.
template <typename T>
__global__ void __launch_bounds__(kThreads) coefmg_restrict_kernel(
    const TransferArgs<T, kRSlots> s) {
  using A = typename Acc<T>::type;
  const Grid& g = s.g;
  const Grid& gc = s.gc;
  int ic, jc, kc;
  if (!locate<1>(gc, s.nty, ic, jc, kc)) return;
  const int64_t b0 = blockIdx.z / g.n1, b1 = blockIdx.z % g.n1;
  const Faces<T> f{at(s, kRfx, b0, b1), at(s, kRfy, b0, b1), at(s, kRfz, b0, b1)};
  const T* x = at(s, kRx, b0, b1);
  const T* b = at(s, kRb, b0, b1);
  int i0, i1, j0, j1, k0, k1;
  group(ic, g.nx, gc.nx, i0, i1);
  group(jc, g.ny, gc.ny, j0, j1);
  group(kc, g.nz, gc.nz, k0, k1);
  A sz = A(0);
  for (int k = k0; k < k1; ++k) {
    A sy = A(0);
    for (int j = j0; j < j1; ++j) {
      A sx = A(0);
      for (int i = i0; i < i1; ++i) {
        const A r = sub(load(b + (k * g.ny + j) * g.nx + i), s_apply(x, f, i, j, k, g));
        sx = i == i0 ? r : add(sx, r);
      }
      sy = j == j0 ? sx : add(sy, sx);
    }
    sz = k == k0 ? sy : add(sz, sy);
  }
  store(at(s, kRout, b0, b1) + (kc * gc.ny + jc) * gc.nx + ic, sz);
}

// x' = x + xc at each fine cell's coarse cell.
template <typename T>
__global__ void __launch_bounds__(kThreads) coefmg_prolong_kernel(
    const TransferArgs<T, kPSlots> s) {
  const Grid& g = s.g;
  const Grid& gc = s.gc;
  int i, j, k;
  if (!locate<1>(g, s.nty, i, j, k)) return;
  const int64_t b0 = blockIdx.z / g.n1, b1 = blockIdx.z % g.n1;
  const auto coarse = [](int c, int nf, int nc) { return nc == nf ? c : min(c / 2, nc - 1); };
  const int cc = (coarse(k, g.nz, gc.nz) * gc.ny + coarse(j, g.ny, gc.ny)) * gc.nx +
                 coarse(i, g.nx, gc.nx);
  const int c = (k * g.ny + j) * g.nx + i;
  store(at(s, kPout, b0, b1) + c,
        add(load(at(s, kPx, b0, b1) + c), load(at(s, kPxc, b0, b1) + cc)));
}

// The grid from dims[0..3] (nx, ny, nz, n1); false unless every count is
// positive and a member's face grids stay within 32-bit offsets.
bool grid_of(const int64_t* d, Grid& g) {
  for (int a = 0; a < 4; ++a) {
    if (d[a] <= 0) return false;
  }
  if ((d[0] + 1) * (d[1] + 1) * (d[2] + 1) > INT_MAX) return false;
  g = Grid{static_cast<int>(d[0]), static_cast<int>(d[1]), static_cast<int>(d[2]),
           static_cast<int>(d[3])};
  return true;
}

// The launch grid over `walk` (nb batch members): x tiles, y tiles times
// columns of kz planes, members; false where a count leaves what grid.y
// and grid.z hold.
bool blocks_of(const Grid& walk, int64_t nb, int kz, int& nty, dim3& blocks) {
  const int64_t ntx = (walk.nx + kTx - 1) / kTx;
  nty = (walk.ny + kTy - 1) / kTy;
  const int64_t ny = static_cast<int64_t>(nty) * ((walk.nz + kz - 1) / kz);
  if (nb <= 0 || nb % walk.n1 != 0 || ny > kMaxGridYZ || nb > kMaxGridYZ) return false;
  blocks = dim3(static_cast<unsigned int>(ntx), static_cast<unsigned int>(ny),
                static_cast<unsigned int>(nb));
  return true;
}

template <typename T>
int launch_smooth(int mode, int last, const void* const* ptrs, const int64_t* st,
                  const int64_t* dims, const double* scal, void* stream) {
  SmoothArgs<T> s;
  for (int k = 0; k < kSlots; ++k) {
    s.p[k] = static_cast<T*>(const_cast<void*>(ptrs[k]));
    s.s0[k] = st[2 * k];
    s.s1[k] = st[2 * k + 1];
  }
  dim3 blocks;
  if (!grid_of(dims, s.g) || !blocks_of(s.g, dims[4], kZ, s.nty, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.a = scal[0];
  s.c = scal[1];
  s.w = scal[2];
  s.last = last;
  const auto cs = static_cast<cudaStream_t>(stream);
  const dim3 threads(kTx, kTy);
  if (mode == kFirst) {
    coefmg_smooth_kernel<T, kFirst><<<blocks, threads, 0, cs>>>(s);
  } else if (mode == kStep) {
    coefmg_smooth_kernel<T, kStep><<<blocks, threads, 0, cs>>>(s);
  } else if (mode == kJacobi) {
    coefmg_smooth_kernel<T, kJacobi><<<blocks, threads, 0, cs>>>(s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
bool transfer_args(const void* const* ptrs, const int64_t* st, const int64_t* dims,
                   TransferArgs<T, N>& s) {
  for (int k = 0; k < N; ++k) {
    s.p[k] = static_cast<T*>(const_cast<void*>(ptrs[k]));
    s.s0[k] = st[2 * k];
    s.s1[k] = st[2 * k + 1];
  }
  const int64_t coarse[4] = {dims[4], dims[5], dims[6], dims[3]};
  if (!grid_of(dims, s.g) || !grid_of(coarse, s.gc)) return false;
  const int nf[3] = {s.g.nx, s.g.ny, s.g.nz}, nc[3] = {s.gc.nx, s.gc.ny, s.gc.nz};
  for (int a = 0; a < 3; ++a) {
    // Groups of 2 with a tail of at least one cell, or a passthrough axis.
    if (nc[a] != nf[a] && 2 * (nc[a] - 1) >= nf[a]) return false;
  }
  return true;
}

template <typename T>
int launch_restrict(const void* const* ptrs, const int64_t* st, const int64_t* dims,
                    void* stream) {
  TransferArgs<T, kRSlots> s;
  dim3 blocks;
  if (!transfer_args(ptrs, st, dims, s) || !blocks_of(s.gc, dims[7], 1, s.nty, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  coefmg_restrict_kernel<T><<<blocks, dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_prolong(const void* const* ptrs, const int64_t* st, const int64_t* dims,
                   void* stream) {
  TransferArgs<T, kPSlots> s;
  dim3 blocks;
  if (!transfer_args(ptrs, st, dims, s) || !blocks_of(s.g, dims[7], 1, s.nty, blocks)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  coefmg_prolong_kernel<T><<<blocks, dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// int coefmg_smooth_{f32,f64,bf16}(mode, last, ptrs[10], strides[20],
//     dims[5], scal[3], stream): slots x, b (r for a step), dvec, idiag,
// faces x, y, z, x out, r out, dvec out (null where unused); strides
// (s0, s1) per slot in elements; dims nx, ny, nz, n1, nb; scal a, c, w.
// int coefmg_{restrict,prolong}_{f32,f64,bf16}(ptrs, strides, dims[8],
//     stream): restrict slots x, b, faces x, y, z, rc out; prolong slots
// x, xc, x out; dims fine nx, ny, nz, n1, coarse nx, ny, nz, nb.
#define COEFMG_ENTRIES(SUFFIX, T)                                                           \
  int coefmg_smooth_##SUFFIX(int mode, int last, const void* const* ptrs, const int64_t* st, \
                             const int64_t* dims, const double* scal, void* stream) {       \
    return launch_smooth<T>(mode, last, ptrs, st, dims, scal, stream);                      \
  }                                                                                         \
  int coefmg_restrict_##SUFFIX(const void* const* ptrs, const int64_t* st,                  \
                               const int64_t* dims, void* stream) {                         \
    return launch_restrict<T>(ptrs, st, dims, stream);                                      \
  }                                                                                         \
  int coefmg_prolong_##SUFFIX(const void* const* ptrs, const int64_t* st,                   \
                              const int64_t* dims, void* stream) {                          \
    return launch_prolong<T>(ptrs, st, dims, stream);                                       \
  }

COEFMG_ENTRIES(f32, float)
COEFMG_ENTRIES(f64, double)
COEFMG_ENTRIES(bf16, __nv_bfloat16)

#undef COEFMG_ENTRIES

}  // extern "C"
