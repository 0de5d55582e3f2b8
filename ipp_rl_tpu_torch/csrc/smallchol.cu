// Small-SPD kernels for Hopper (sm_90a): batched inverse and trace product.
//
// Both entry points share one device function, `inverse_factor`: the
// unrolled Cholesky factorisation of an M x M SPD matrix (pivot clamped
// at 1e-30 before the square root) followed by forward substitution for
// Li = L^-1.  Then
//
//   spd_inverse        writes S^-1 = Li^T Li                (n, M, M) -> (n, M, M)
//   spd_trace_product  writes tr(S^-1 G) = sum_{i>=j} (2 - d_ij) S^-1[i,j] G[i,j]
//                      for symmetric G, never storing S^-1   (n, M, M) x 2 -> (n)
//
// What each replaces:
//   spd_inverse       - the TPU kernel `spd_inverse_pallas` / `_spd_inverse_kernel`
//                       (ipp_rl_tpu/ops/pallas_kernels.py:71, body :29).  On the
//                       port's main path it inverts the B innovation matrices of
//                       the belief commit (ops/kalman.kf_update).
//   spd_trace_product - the unrolled XLA program `spd_trace_product`
//                       (ipp_rl_tpu/ops/smallchol.py:51), the per-action output of
//                       the all-action sweep (ops/kalman.kf_sweep_gains_batched):
//                       2 x 100 x B blocks per replan step on the canonical config.
//
// Bound on an H100 (3.35 TB/s, 67 TFLOP/s f32 outside the tensor cores):
//   spd_inverse at B = 4096, M = 9, f32 moves 2 x 4096 x 81 x 4 B = 2.65 MB
//   (~0.8 us) and does ~3 MFLOP: bytes-bound, and in practice launch-bound.
//   spd_trace_product at 819,200 blocks moves ~531 MB (~160 us) for ~0.7
//   GFLOP (~10 us): bytes-bound.
//
// Design: one thread per matrix; L and Li live in registers (45 + 45
// values at M = 9; M is a template parameter so every loop unrolls and
// every index is a compile-time constant).  The ragged tail is masked by
// the thread index, with no padding.  Each thread reads its matrix as
// row-major (M, M) storage, so a warp's loads are strided by M*M*4 B
// (324 B at M = 9) and rely on L1 to reuse the sectors.  Staging the
// blocks through shared memory, or an entries-major (M*M, n) layout as the
// TPU kernel used, would coalesce them; that is left for a later change.
//
// Numerics: the operations and their order are those of the plain PyTorch
// versions (ops/smallchol.py), and the library is built with -fmad=false
// (no multiply-add contraction) and IEEE division and square root, so on
// the same inputs kernel and plain version agree to the last bit.
//
// Interface: plain C, loaded with ctypes by ops/kernels.py; pointers and
// the stream arrive as void*.  Each launcher returns 0, a cudaError_t from
// cudaGetLastError() after the launch, or -1 for an unsupported M or
// dtype (nothing launched).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 12;

template <typename T>
__device__ __forceinline__ T clamp_pivot(T x) {
  const T floor_v = T(1e-30);
  return x < floor_v ? floor_v : x;  // a NaN passes through, as in torch.clamp
}

// Li = L^-1 (lower triangle) for the SPD matrix at s (row-major M x M);
// only the lower triangle of s is read.
template <int M, typename T>
__device__ __forceinline__ void inverse_factor(const T* __restrict__ s, T (&Li)[M][M]) {
  T L[M][M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T acc = s[j * M + j];
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - L[j][k] * L[j][k];
    L[j][j] = sqrt(clamp_pivot(acc));
    const T inv_d = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < M; ++i) {
      T a = s[i * M + j];
#pragma unroll
      for (int k = 0; k < j; ++k) a = a - L[i][k] * L[j][k];
      L[i][j] = a * inv_d;
    }
  }
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

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
spd_inverse_kernel(const T* __restrict__ s, T* __restrict__ out, int64_t n) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n) return;
  T Li[M][M];
  inverse_factor<M>(s + b * (M * M), Li);
  T* o = out + b * (M * M);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const T v = inverse_entry<M>(Li, i, j);
      o[i * M + j] = v;
      o[j * M + i] = v;
    }
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
spd_trace_product_kernel(const T* __restrict__ s, const T* __restrict__ g,
                         T* __restrict__ out, int64_t n) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= n) return;
  T Li[M][M];
  inverse_factor<M>(s + b * (M * M), Li);
  const T* gb = g + b * (M * M);
  T total = T(0);
#pragma unroll
  for (int i = 0; i < M; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T term = inverse_entry<M>(Li, i, j) * gb[i * M + j];
      if (i != j) term = term + term;
      total = (i == 0) ? term : total + term;
    }
  }
  out[b] = total;
}

template <int M, typename T>
void launch_inverse(const void* s, void* out, int64_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  spd_inverse_kernel<M, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n);
}

template <int M, typename T>
void launch_trace(const void* s, const void* g, void* out, int64_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  spd_trace_product_kernel<M, T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), n);
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

struct TraceLaunch {
  const void* s; const void* g; void* out; int64_t n; cudaStream_t stream;
  template <int M, typename T> void run() const { launch_trace<M, T>(s, g, out, n, stream); }
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

int smallchol_spd_trace_product(const void* s, const void* g, void* out, long long n,
                                int m, int dtype, void* stream) {
  if (n <= 0) return 0;
  return launch(m, dtype, TraceLaunch{s, g, out, n, static_cast<cudaStream_t>(stream)});
}

const char* smallchol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
