// Small-SPD kernels for Hopper (sm_90a): batched inverse, inverse with the
// Cholesky factor of the inverse, and trace product.
//
// All entry points share two device functions: `cholesky`, the unrolled
// Cholesky factorisation of an M x M SPD matrix (pivot clamped at 1e-30
// before the square root), and `inverse_factor`, which follows it with
// forward substitution for Li = L^-1.  Then
//
//   spd_inverse        writes S^-1 = Li^T Li              (n, M, M) row-major -> (n, M, M)
//   spd_inverse_factor writes S^-1 and U = chol(S^-1),    (n, M, M) -> 2 x (n, M, M)
//                      lower, U U^T = S^-1, zeros above the diagonal
//   spd_trace_product  writes tr(S^-1 G) = sum_{i>=j} (2 - d_ij) S^-1[i,j] G[i,j]
//                      for symmetric G, never storing S^-1, from packed lower
//                      triangles, entries-major           (outer, T, inner) x 2 -> (outer, inner)
//
// T = M(M+1)/2, and entry (i, j), i >= j, of block (o, c) lies at
// (o*T + i(i+1)/2 + j)*inner + c.
//
// What each replaces:
//   spd_inverse       - the TPU kernel `spd_inverse_pallas` / `_spd_inverse_kernel`
//                       (ipp_rl_tpu/ops/pallas_kernels.py:71, body :29).  On the
//                       port's main path it inverts the B innovation matrices of
//                       the belief commit (ops/kalman.kf_update).
//   spd_inverse_factor - the unrolled XLA pair `spd_inverse` then
//                       `spd_cholesky_dense` of the edge update `kf_gain_factor_t`
//                       (ipp_rl_tpu/ops/kalman.py:107-108, ops/smallchol.py:91,112).
//                       On the port's MCTS-zero path it runs once per descent
//                       step of every simulation, on the B innovation matrices
//                       of the tree edges being priced.
//   spd_trace_product - the unrolled XLA program `spd_trace_product`
//                       (ipp_rl_tpu/ops/smallchol.py:51), the per-action output of
//                       the all-action sweep (ops/kalman.kf_sweep_gains_batched):
//                       2 x 100 x B blocks per replan step on the canonical config,
//                       in the layouts (B, T, 100) (gather group) and (100, T, B)
//                       (dense group).
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   spd_inverse at B = 4096, M = 9, f32 moves 2 x 4096 x 81 x 4 B = 2.65 MB
//   (0.79 us) and does ~3 MFLOP: bytes-bound, and below the cost of a launch.
//   spd_inverse_factor at B = 1024, M = 9, f32 moves 3 x 1024 x 81 x 4 B =
//   1.0 MB (0.30 us) and does ~1.6 MFLOP: a launch costs more than either.
//   spd_trace_product at 819,200 blocks reads two packed triangles and
//   writes one value per block, (2 x 45 + 1) x 4 B = 364 B, so 298 MB
//   (89 us) for ~0.7 GFLOP (~10 us): bytes-bound.
//
// Design.  One thread per matrix; L and Li live in registers (45 + 45
// values at M = 9; M is a template parameter so every loop unrolls and
// every index is a compile-time constant).
//   spd_trace_product: one thread per block (o, c), threads consecutive in
//   c, so each of a warp's 2 x T loads is one contiguous 128 B line (f32)
//   and every byte fetched is used: the entries-major idea of the TPU
//   kernel (pallas_kernels.py:9-13), restricted to the lower triangle that
//   the function reads.  The sweep builds its blocks in this layout, so no
//   caller transposes or copies full blocks.
//   spd_inverse: a CTA of one warp owns a tile of kInverseTile = 32
//   consecutive matrices, which is one contiguous range of memory.  The
//   warp copies it into shared memory with 16-byte vector loads, each
//   thread inverts its matrix there and writes S^-1 back in place, and the
//   warp stores the tile with 16-byte vector stores.
//   spd_inverse_factor: the same tile, with a second pass over it: after
//   S^-1 is stored, each thread factors its S^-1 from shared memory,
//   writes U in place and the warp stores the tile again.  One launch
//   takes the place of the ~350 small operations of the unrolled pair.  A matrix's stride of
//   M*M words is odd at M = 9, so the per-thread shared reads and writes
//   are free of bank conflicts.  B = 4096 gives 128 CTAs for the 132 SMs.
// The ragged tail is masked by index, with no padding.
//
// Numerics: the operations and their order are those of the plain PyTorch
// versions (ops/smallchol.py), and the library is built with -fmad=false
// (no multiply-add contraction) and IEEE division and square root, so on
// the same inputs kernel and plain version agree to the last bit.  Only
// the addressing differs between the layouts.
//
// Interface: plain C, loaded with ctypes by ops/kernels.py; pointers and
// the stream arrive as void*.  Each launcher returns 0, a cudaError_t from
// cudaGetLastError() after the launch, or -1 for an unsupported M or
// dtype (nothing launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxM = 12;
constexpr int kInverseTile = 32;  // matrices, and threads, per CTA of spd_inverse
constexpr int kTraceThreads = 128;

template <typename T>
__device__ __forceinline__ T clamp_pivot(T x) {
  const T floor_v = T(1e-30);
  return x < floor_v ? floor_v : x;  // a NaN passes through, as in torch.clamp
}

// entry (i, j) of a row-major M x M matrix (here in shared memory)
template <int M, typename T>
struct RowMajor {
  const T* p;
  __device__ __forceinline__ T operator()(int i, int j) const { return p[i * M + j]; }
};

// entry (i, j), i >= j, of a packed lower triangle whose entries lie
// `stride` elements apart in global memory
template <typename T>
struct Packed {
  const T* p;
  int64_t stride;
  __device__ __forceinline__ T operator()(int i, int j) const {
    return __ldg(p + (i * (i + 1) / 2 + j) * stride);
  }
};

// L, lower, with L L^T = the SPD matrix whose entry (i, j), i >= j, is
// s(i, j); only the lower triangle is read.
template <int M, typename T, typename Entry>
__device__ __forceinline__ void cholesky(const Entry& s, T (&L)[M][M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T acc = s(j, j);
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
    L[j][j] = sqrt(clamp_pivot(acc));
    const T inv_d = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T a = s(i, j);
#pragma unroll
      for (int k = 0; k < j; ++k) a = a - L[i][k] * L[j][k];
      L[i][j] = a * inv_d;
    }
  }
}

// Li = L^-1 (lower triangle) for the SPD matrix whose entry (i, j), i >= j,
// is s(i, j); only the lower triangle is read.
template <int M, typename T, typename Entry>
__device__ __forceinline__ void inverse_factor(const Entry& s, T (&Li)[M][M]) {
  T L[M][M];
  cholesky<M>(s, L);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    Li[j][j] = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T acc = L[i][j] * Li[j][j];
#pragma unroll
      for (int k = j + 1; k < i; ++k) acc = acc + L[i][k] * Li[k][j];
      Li[i][j] = -acc / L[i][i];
    }
  }
}

// S^-1[i][j] for i >= j
template <int M, typename T>
__device__ __forceinline__ T inverse_entry(const T (&Li)[M][M], int i, int j) {
  T acc = Li[i][i] * Li[i][j];
#pragma unroll
  for (int k = i + 1; k < M; ++k) acc = acc + Li[k][i] * Li[k][j];
  return acc;
}

// count elements from src to dst by the CTA's threads: 16-byte vectors
// where both ends are 16-byte aligned and the length allows, else scalars
template <typename T>
__device__ __forceinline__ void copy_tile(T* __restrict__ dst, const T* __restrict__ src,
                                          int count) {
  const int bytes = count * static_cast<int>(sizeof(T));
  const uintptr_t ends = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if ((ends & 15) == 0 && bytes % 16 == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int k = threadIdx.x; k < bytes / 16; k += blockDim.x) d4[k] = s4[k];
  } else {
    for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
  }
}

// overwrite the row-major SPD matrix m (shared memory) with its inverse
template <int M, typename T>
__device__ __forceinline__ void invert_in_place(T* m) {
  T Li[M][M];
  inverse_factor<M>(RowMajor<M, T>{m}, Li);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const T v = inverse_entry<M>(Li, i, j);
      m[i * M + j] = v;
      m[j * M + i] = v;
    }
  }
}

// overwrite the row-major SPD matrix m (shared memory) with its lower
// Cholesky factor, zeros above the diagonal
template <int M, typename T>
__device__ __forceinline__ void factor_in_place(T* m) {
  T L[M][M];
  cholesky<M>(RowMajor<M, T>{m}, L);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) m[i * M + j] = j <= i ? L[i][j] : T(0);
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kInverseTile)
spd_inverse_kernel(const T* __restrict__ s, T* __restrict__ out, int64_t n) {
  __shared__ __align__(16) T tile[kInverseTile * M * M];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kInverseTile;
  const int mats = n - b0 < kInverseTile ? static_cast<int>(n - b0) : kInverseTile;
  copy_tile(tile, s + b0 * (M * M), mats * M * M);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < mats) invert_in_place<M>(tile + threadIdx.x * (M * M));
  __syncthreads();
  copy_tile(out + b0 * (M * M), tile, mats * M * M);
}

template <int M, typename T>
__global__ void __launch_bounds__(kInverseTile)
spd_inverse_factor_kernel(const T* __restrict__ s, T* __restrict__ inv,
                          T* __restrict__ chol, int64_t n) {
  __shared__ __align__(16) T tile[kInverseTile * M * M];
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * kInverseTile;
  const int mats = n - b0 < kInverseTile ? static_cast<int>(n - b0) : kInverseTile;
  const bool mine = static_cast<int>(threadIdx.x) < mats;
  T* m = tile + threadIdx.x * (M * M);
  copy_tile(tile, s + b0 * (M * M), mats * M * M);
  __syncthreads();
  if (mine) invert_in_place<M>(m);
  __syncthreads();
  copy_tile(inv + b0 * (M * M), tile, mats * M * M);
  __syncthreads();  // the store reads every matrix before any is overwritten
  if (mine) factor_in_place<M>(m);
  __syncthreads();
  copy_tile(chol + b0 * (M * M), tile, mats * M * M);
}

template <int M, typename T>
__global__ void __launch_bounds__(kTraceThreads)
spd_trace_product_kernel(const T* __restrict__ s, const T* __restrict__ g,
                         T* __restrict__ out, int64_t outer, int64_t inner) {
  constexpr int kT = M * (M + 1) / 2;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kTraceThreads + threadIdx.x;
  if (t >= outer * inner) return;
  const int64_t o = t / inner;
  const int64_t base = o * (kT - 1) * inner + t;  // (o*T)*inner + (t - o*inner)
  T Li[M][M];
  inverse_factor<M>(Packed<T>{s + base, inner}, Li);
  const Packed<T> gb{g + base, inner};
  T total = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T term = inverse_entry<M>(Li, i, j) * gb(i, j);
      if (i != j) term = term + term;
      total = (i == 0) ? term : total + term;
    }
  }
  out[t] = total;
}

template <int M, typename T>
void launch_inverse(const void* s, void* out, int64_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kInverseTile - 1) / kInverseTile);
  spd_inverse_kernel<M, T><<<blocks, kInverseTile, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n);
}

template <int M, typename T>
void launch_inverse_factor(const void* s, void* inv, void* chol, int64_t n,
                           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kInverseTile - 1) / kInverseTile);
  spd_inverse_factor_kernel<M, T><<<blocks, kInverseTile, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(inv), static_cast<T*>(chol), n);
}

template <int M, typename T>
void launch_trace(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                  cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((outer * inner + kTraceThreads - 1) / kTraceThreads);
  spd_trace_product_kernel<M, T><<<blocks, kTraceThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner);
}

// calls F::template run<M, T>() for the runtime M; false if M is unsupported
template <typename T, typename F>
bool dispatch_m(int m, F f) {
  switch (m) {
    case 1: f.template run<1, T>(); return true;
    case 2: f.template run<2, T>(); return true;
    case 3: f.template run<3, T>(); return true;
    case 4: f.template run<4, T>(); return true;
    case 5: f.template run<5, T>(); return true;
    case 6: f.template run<6, T>(); return true;
    case 7: f.template run<7, T>(); return true;
    case 8: f.template run<8, T>(); return true;
    case 9: f.template run<9, T>(); return true;
    case 10: f.template run<10, T>(); return true;
    case 11: f.template run<11, T>(); return true;
    case 12: f.template run<12, T>(); return true;
    default: return false;
  }
}

struct InverseLaunch {
  const void* s; void* out; int64_t n; cudaStream_t stream;
  template <int M, typename T> void run() const { launch_inverse<M, T>(s, out, n, stream); }
};

struct InverseFactorLaunch {
  const void* s; void* inv; void* chol; int64_t n; cudaStream_t stream;
  template <int M, typename T> void run() const {
    launch_inverse_factor<M, T>(s, inv, chol, n, stream);
  }
};

struct TraceLaunch {
  const void* s; const void* g; void* out; int64_t outer; int64_t inner; cudaStream_t stream;
  template <int M, typename T> void run() const {
    launch_trace<M, T>(s, g, out, outer, inner, stream);
  }
};

// dtype codes: 0 = float32, 1 = float64
template <typename F>
int launch(int m, int dtype, F f) {
  bool ok;
  if (dtype == 0) ok = dispatch_m<float>(m, f);
  else if (dtype == 1) ok = dispatch_m<double>(m, f);
  else ok = false;
  if (!ok) return -1;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int smallchol_max_m() { return kMaxM; }

int smallchol_spd_inverse(const void* s, void* out, long long n, int m, int dtype,
                          void* stream) {
  if (n <= 0) return 0;
  return launch(m, dtype, InverseLaunch{s, out, n, static_cast<cudaStream_t>(stream)});
}

int smallchol_spd_inverse_factor(const void* s, void* inv, void* chol, long long n, int m,
                                 int dtype, void* stream) {
  if (n <= 0) return 0;
  return launch(m, dtype,
                InverseFactorLaunch{s, inv, chol, n, static_cast<cudaStream_t>(stream)});
}

int smallchol_spd_trace_product(const void* s, const void* g, void* out, long long outer,
                                long long inner, int m, int dtype, void* stream) {
  if (outer <= 0 || inner <= 0) return 0;
  return launch(m, dtype,
                TraceLaunch{s, g, out, outer, inner, static_cast<cudaStream_t>(stream)});
}

const char* smallchol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
