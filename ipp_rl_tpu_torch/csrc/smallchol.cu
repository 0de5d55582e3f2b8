// Small-SPD kernels for Hopper (sm_90a): batched inverse, inverse with the
// Cholesky factor of the inverse, trace product, and the search's edge
// update from (S, A) to the whitened gain factor and its gain.
//
// The first three entry points share two device functions: `cholesky`, the unrolled
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
//   edge_factor_gain   writes WcT = U^T A and its masked gain from S_raw and A,
//                      U = chol(S^-1) (below)     (n, M, M), (n, M, N) -> (n, M, N), (n,)
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
// edge_factor_gain: the whole small-matrix tail of the search's edge update
// (ipp_rl_tpu/planners/zero/mcts.py:187-207, ZeroMCTS.edge_update, with
// ipp_rl_tpu/ops/kalman.py:88-126, kf_gain_factor_t and _small_mm), per
// mission b with action a[b]:
//   S    = 0.5 (S_raw + S_raw^T) + diag(R[a[b]])      S_raw = A H^T, (M, M)
//   U    = chol(S^-1)                                 S^-1 is not stored
//   WcT  = U^T A in _small_mm order: row m is U[0,m] A[0], then + U[k,m] A[k]
//          for k = 1..M-1, the zero terms above U's diagonal kept
//   WcT  = bf16(WcT) when round_bf16 (round to nearest even, and back)
//   sq_n = sum_m WcT[m,n]^2 (m in order) * mask[n]
//   gain = sum_n sq_n in the warp order below
// It replaces K3 and the ~12 eager launches around it per descent step
// (the R gather, symmetrisation, U^T A, casts and sums).
//
//   Bound at B = 1024, M = 9, N = 100, f32 (H100: 3.35 TB/s, 67 TFLOP/s
//   f32): it reads S_raw and A (81 + 900 words) and writes WcT and the gain
//   (900 + 1 words) per mission, ~7.7 MB, plus R rows, the indices and a
//   (B, N) mask (~0.4 MB): ~2.4 us.  It does ~20 kFLOP per mission
//   (U^T A is 15.3k of it), ~20 MFLOP in all: 0.3 us.  Bytes-bound.
//   No tensor cores: f32 products run in full f32 everywhere in the port
//   (TF32 off), wgmma takes no full-f32 input, and U^T A is ~16 kFLOP per
//   mission; the order of every sum is fixed for bitwise agreement.
//
//   Design: one warp per mission, a CTA of kEdgeWarps = 4 warps (B = 1024
//   gives 256 CTAs for the 132 SMs).  Each warp first starts cp.async
//   copies of its mission's S_raw (one group) and A block (a second group)
//   into its own slice of dynamic shared memory, 16-byte copies where both
//   ends are aligned, so A lands while the warp factors S.  The
//   factorisations are spread across lanes, each sum in the order of the
//   device functions above, so results stay bitwise:
//     Cholesky, column by column: lane i keeps row i of L in registers; for
//       column j every lane i >= j forms s(i,j) - sum_k L[i][k] L[j][k]
//       (L[j][k] by shuffle from lane j), lane j's value gives the pivot;
//     forward substitution: lane j owns column j of L^-1 and runs down it;
//     the M(M+1)/2 entries of S^-1 are spread over the lanes;
//     the second Cholesky works as the first.
//   The dependent chain falls from ~M^3 to ~M^2 steps.  Then the lanes own
//   columns n = lane, lane + 32, ...: each forms the M rows of WcT for its
//   column from U (shared-memory broadcasts) and A (shared memory, one bank
//   per lane), stores them coalesced along N, and sums its squares.  Gain:
//   lane l adds the masked sq of columns l, l + 32, l + 64, ... in turn
//   (zero past N), then an xor-shuffle tree over 16, 8, 4, 2, 1; the plain
//   version spells out the same order.  No atomics.
//
// The large-M route (13 <= M <= 32, the same four entry points): the
// register-resident design above needs M(M+1)/2 values per thread for L
// alone (325 at M = 25, past the 255 registers a thread may hold), and 20
// more fully unrolled M values would multiply the build's time.  So M is a
// runtime argument there, and each matrix (each packed block, each
// mission) is one warp's, its workspace in shared memory (L and L^-1 at a
// row stride of M | 1 elements, odd, so the lanes' rows fall in distinct
// banks; 2 x 32 x 33 x 8 B = 16.5 KB per warp at M = 32 in float64), a CTA
// of kLargeWarps = 4 warps:
//   Cholesky, column by column (warp_cholesky_rt): lane i owns row i and
//     forms s(i,j) - sum_k L[i][k] L[j][k] (k in order) with L[j][k] read
//     from shared memory; lane j's sum gives the pivot by shuffle;
//   forward substitution (warp_invert_lower): lane j runs down column j;
//   the entries of S^-1 (each a sum over k in order) spread over the lanes.
// Each sum keeps the order of the plain versions, so the route is bitwise
// equal to them too; the one sum that the lanes cannot split without
// changing its order, the trace product's M(M+1)/2 terms, lane 0 adds up
// in order.  spd_inverse and spd_inverse_factor stage each matrix through
// shared memory with coalesced copies; the trace product reads its block's
// entries (`inner` apart) straight from global memory; edge_factor_gain
// reads A straight from global memory, the lanes on consecutive columns.
// A simple design, not a fast one: at M = 25 a warp does ~M^2 dependent
// steps with most lanes idle.
//
// The CTA route (M >= 33, any M; the same four entry points, and
// edge_factor_gain at M <= 12 where the register route's shared slices of N
// columns do not fit a CTA): the warp route lifted to a CTA.  Each matrix
// (each packed block, each mission) is one CTA's, of ceil(M/32) warps (at
// most 1024 threads; edge_factor_gain at least 256), thread i owning row i
// (rows i, i + 1024, ... past 1024):
//   Cholesky, column by column (cta_cholesky), in place on the staged lower
//     triangle: each thread forms s(i,j) - sum_k L[i][k] L[j][k] (k in
//     order); row j's sum is the pivot, passed on through the workspace
//     between two __syncthreads();
//   forward substitution (cta_invert_lower): thread j runs down column j;
//   the entries of S^-1 (each a sum over k in order) spread over the CTA;
//   the second Cholesky (spd_inverse_factor, edge_factor_gain) as the first.
// The workspace is two packed triangles, X and Y (M(M+1) elements: 26.5 KB
// at M = 81 and 59 KB at M = 121 in float32, 118 KB at M = 121 in
// float64), the pivot, and for edge_factor_gain the N masked squares.  It
// lives in shared memory up to kMaxSharedBytes per CTA (every M <= 169 in
// float64), else in global memory (L2-resident): the same code through
// another pointer, a caller-allocated slice per CTA for kWorkspaceCtas CTAs
// that stride over the batch (smallchol_workspace_bytes says how much).
// The trace product's M(M+1)/2 terms go to X and thread 0 adds them up in
// order.  edge_factor_gain forms U^T A with the threads on consecutive
// columns of A (global memory), kWctRows rows of WcT per pass over a
// column, each row's sum in _small_mm order; warp 0 then walks the masked
// squares in the warp route's lane order and xor tree, so a CTA of any
// width gives the warp route's gain bit for bit.
//
// Numerics: the operations and their order are those of the plain PyTorch
// versions (ops/smallchol.py), and the library is built with -fmad=false
// (no multiply-add contraction) and IEEE division and square root, so on
// the same inputs kernel and plain version agree to the last bit.  Only
// the addressing differs between the layouts.
//
// Interface: plain C, loaded with ctypes by ops/kernels.py; pointers and
// the stream arrive as void*.  Each launcher returns 0, a cudaError_t from
// cudaGetLastError() after the launch, -1 for an unsupported M (below 1),
// dtype or size, or -2 for a missing global workspace (nothing launched).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxUnrolledM = 12;  // the register-resident route: M = 1..12
constexpr int kMaxWarpM = 32;      // the warp route: M = 13..32; the CTA route takes M >= 33
constexpr int kLargeWarps = 4;     // matrices, and warps, per CTA of the large-M route
constexpr int kInverseTile = 32;  // matrices, and threads, per CTA of spd_inverse
constexpr int kTraceThreads = 128;
constexpr int kEdgeWarps = 4;  // missions, and warps, per CTA of edge_factor_gain
constexpr int kMaxSharedBytes = 232448;  // dynamic shared memory a CTA may use
constexpr unsigned kFullMask = 0xffffffffu;

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

// ---------------------------------------------------------------- edge update

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

template <int Bytes>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(Bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `Pending` of this thread's committed groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// count elements from global src to shared dst by the warp's lanes, as
// asynchronous copies: 16-byte copies where both ends are 16-byte aligned
// and the length allows, else one element each
template <typename T>
__device__ __forceinline__ void warp_copy_async(T* dst, const T* src, int count, int lane) {
  const int bytes = count * static_cast<int>(sizeof(T));
  const uintptr_t ends = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  if ((ends & 15) == 0 && bytes % 16 == 0) {
    for (int k = lane; k < bytes / 16; k += 32) {
      cp_async_16(reinterpret_cast<char*>(dst) + 16 * k,
                  reinterpret_cast<const char*>(src) + 16 * k);
    }
  } else {
    for (int k = lane; k < count; k += 32) cp_async_small<sizeof(T)>(dst + k, src + k);
  }
}

// x rounded to bfloat16 (to nearest even) and back, as x.to(torch.bfloat16)
// .to(x.dtype) does; a double goes through float first, as torch's does
template <typename T>
__device__ __forceinline__ T round_to_bf16(T x) {
  return static_cast<T>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(x))));
}

// elements of one warp's slice of shared memory: the A block (M * N), then
// S_raw and two M x M scratch matrices, each slice a multiple of 16 bytes
template <typename T>
__host__ __device__ constexpr int64_t edge_a_elems(int m, int n) {
  return (m * static_cast<int64_t>(n) * sizeof(T) + 15) / 16 * 16 / sizeof(T);
}

template <typename T>
__host__ __device__ constexpr int64_t edge_warp_elems(int m, int n) {
  return edge_a_elems<T>(m, n) + (3 * m * m * sizeof(T) + 15) / 16 * 16 / sizeof(T);
}

// bytes of dynamic shared memory of one CTA of edge_factor_gain_kernel
template <typename T>
int64_t edge_register_bytes(int m, int n) {
  return kEdgeWarps * edge_warp_elems<T>(m, n) * static_cast<int64_t>(sizeof(T));
}

// Cholesky across the warp: lane `row` (rows past M - 1 repeat row M - 1)
// returns row `row` of L, zeros above the diagonal, for the SPD matrix whose
// entry (i, j), i >= j, is s(i, j).  Each entry's sum runs over k in the
// order of `cholesky`; every lane computes the pivot from lane j's sum.
template <int M, typename T, typename Entry>
__device__ __forceinline__ void warp_cholesky(const Entry& s, int row, T (&Lrow)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T acc = s(row, j);
#pragma unroll
    for (int k = 0; k < j; ++k) acc = acc - Lrow[k] * __shfl_sync(kFullMask, Lrow[k], j);
    const T d = sqrt(clamp_pivot(__shfl_sync(kFullMask, acc, j)));
    const T inv_d = T(1) / d;
    Lrow[j] = row == j ? d : (row > j ? acc * inv_d : T(0));
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kEdgeWarps * 32)
edge_factor_gain_kernel(const T* __restrict__ s_raw, const T* __restrict__ a_blk,
                        const T* __restrict__ r_table, const int64_t* __restrict__ action,
                        const T* __restrict__ mask, int64_t mask_stride,
                        T* __restrict__ wct, T* __restrict__ gain, int64_t n_missions, int n,
                        int round_bf16) {
  extern __shared__ __align__(16) unsigned char edge_smem[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kEdgeWarps + warp;
  if (b >= n_missions) return;  // whole warps only: nothing below syncs the CTA

  T* A = reinterpret_cast<T*>(edge_smem) + warp * edge_warp_elems<T>(M, n);
  T* S = A + edge_a_elems<T>(M, n);  // S_raw, row-major
  T* X = S + M * M;                  // L, then S^-1 (lower triangle)
  T* Y = X + M * M;                  // L^-1 (lower triangle), then U
  warp_copy_async(S, s_raw + b * (M * M), M * M, lane);
  cp_async_commit();
  warp_copy_async(A, a_blk + b * M * n, M * n, lane);
  cp_async_commit();

  const int row = lane < M ? lane : M - 1;  // the row (or column) this lane owns
  const int64_t act = __ldg(reinterpret_cast<const long long*>(action) + b);
  const T r_row = __ldg(r_table + act * M + row);
  cp_async_wait<1>();  // S_raw has landed; A may still be in flight
  __syncwarp();

  // L of S = 0.5 (S_raw + S_raw^T) + diag(R), lane `row` holding row `row`
  T Lrow[M];
  warp_cholesky<M>(
      [&](int i, int j) {
        return T(0.5) * (S[i * M + j] + S[j * M + i]) + (i == j ? r_row : T(0));
      },
      row, Lrow);
  if (lane < M) {
#pragma unroll
    for (int k = 0; k < M; ++k) X[row * M + k] = Lrow[k];
  }
  __syncwarp();

  // L^-1 by forward substitution, lane `row` running down column `row`
  {
    const int col = row;
    const T diag = T(1) / X[col * M + col];
    T Lic[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (i == col) {
        Lic[i] = diag;
      } else if (i > col) {
        T acc = X[i * M + col] * diag;
#pragma unroll
        for (int k = 1; k < i; ++k) {
          if (k > col) acc = acc + X[i * M + k] * Lic[k];
        }
        Lic[i] = -acc / X[i * M + i];
      } else {
        Lic[i] = T(0);
      }
    }
    if (lane < M) {
#pragma unroll
      for (int i = 0; i < M; ++i) {
        if (i >= col) Y[i * M + col] = Lic[i];
      }
    }
  }
  __syncwarp();

  // the lower triangle of S^-1 = L^-T L^-1 into X, entries spread over lanes
  constexpr int kT = M * (M + 1) / 2;
  for (int e = lane; e < kT; e += 32) {
    int i = 0;
#pragma unroll
    for (int r = 1; r < M; ++r) {
      if (e >= r * (r + 1) / 2) i = r;
    }
    const int j = e - i * (i + 1) / 2;
    T acc = Y[i * M + i] * Y[i * M + j];
#pragma unroll
    for (int k = 1; k < M; ++k) {
      if (k > i) acc = acc + Y[k * M + i] * Y[k * M + j];
    }
    X[i * M + j] = acc;
  }
  __syncwarp();

  // U = chol(S^-1) into Y, zeros above the diagonal
  T Urow[M];
  warp_cholesky<M>([&](int i, int j) { return X[i * M + j]; }, row, Urow);
  if (lane < M) {
#pragma unroll
    for (int k = 0; k < M; ++k) Y[row * M + k] = Urow[k];
  }
  cp_async_wait<0>();  // A has landed
  __syncwarp();

  // WcT = U^T A, the squares and this lane's share of the gain
  T* out = wct + b * M * n;
  const T* mrow = mask == nullptr ? nullptr : mask + b * mask_stride;
  T g = T(0);
  for (int c = 0, col = lane; col - lane < n; ++c, col += 32) {
    T sq = T(0);
    if (col < n) {
      T a[M];
#pragma unroll
      for (int k = 0; k < M; ++k) a[k] = A[k * n + col];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        T acc = Y[m] * a[0];  // U[0][m] A[0][col]
#pragma unroll
        for (int k = 1; k < M; ++k) acc = acc + Y[k * M + m] * a[k];
        if (round_bf16) acc = round_to_bf16(acc);
        out[m * n + col] = acc;
        sq = m == 0 ? acc * acc : sq + acc * acc;
      }
      if (mrow != nullptr) sq = sq * __ldg(mrow + col);
    }
    g = c == 0 ? sq : g + sq;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) g = g + __shfl_xor_sync(kFullMask, g, w);
  if (lane == 0) gain[b] = g;
}

// ---------------------------------------------------------------- large-M route

// row stride of the large route's L and L^-1 in shared memory: odd, so the
// lanes' rows start in distinct banks
__host__ __device__ constexpr int large_ld(int m) { return m | 1; }

// position of the packed entry e in the lower triangle: (i, j), i >= j
__device__ __forceinline__ void packed_pair(int e, int& i, int& j) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= e) ++i;
  j = e - i * (i + 1) / 2;
}

// L (rows of `ld` elements in shared memory, zeros above the diagonal) with
// L L^T = the SPD matrix whose entry (i, j), i >= j, is s(i, j), across the
// warp: lane i owns row i, each entry's sum over k in the order of
// `cholesky`, the pivot from lane j's sum.  s is called only for i >= j.
template <typename T, typename Entry>
__device__ __forceinline__ void warp_cholesky_rt(const Entry& s, int m, T* L, int ld, int lane) {
  for (int j = 0; j < m; ++j) {
    T acc = T(0);
    if (lane >= j && lane < m) {
      acc = s(lane, j);
      for (int k = 0; k < j; ++k) acc = acc - L[lane * ld + k] * L[j * ld + k];
    }
    const T d = sqrt(clamp_pivot(__shfl_sync(kFullMask, acc, j)));
    if (lane < m) L[lane * ld + j] = lane == j ? d : (lane > j ? acc * (T(1) / d) : T(0));
    __syncwarp();
  }
}

// Li = L^-1 (lower triangle) by forward substitution, lane j running down
// column j in the order of `inverse_factor`
template <typename T>
__device__ __forceinline__ void warp_invert_lower(const T* L, int m, T* Li, int ld, int lane) {
  if (lane < m) {
    const int c = lane;
    const T diag = T(1) / L[c * ld + c];
    Li[c * ld + c] = diag;
    for (int i = c + 1; i < m; ++i) {
      T acc = L[i * ld + c] * diag;
      for (int k = c + 1; k < i; ++k) acc = acc + L[i * ld + k] * Li[k * ld + c];
      Li[i * ld + c] = -acc / L[i * ld + i];
    }
  }
  __syncwarp();
}

// S^-1[i][j], i >= j, from Li in shared memory, in the order of `inverse_entry`
template <typename T>
__device__ __forceinline__ T inverse_entry_rt(const T* Li, int m, int ld, int i, int j) {
  T acc = Li[i * ld + i] * Li[i * ld + j];
  for (int k = i + 1; k < m; ++k) acc = acc + Li[k * ld + i] * Li[k * ld + j];
  return acc;
}

// elements of one warp's shared workspace: the staged matrix (m * m) and
// two matrices of row stride large_ld(m)
__host__ __device__ constexpr int large_warp_elems(int m) {
  return m * m + 2 * m * large_ld(m);
}

// overwrite the row-major SPD matrix buf (m x m, shared memory) with its
// inverse, using L and Li (shared memory) as scratch
template <typename T>
__device__ __forceinline__ void warp_invert_in_place(T* buf, int m, T* L, T* Li, int lane) {
  const int ld = large_ld(m);
  warp_cholesky_rt([&](int i, int j) { return buf[i * m + j]; }, m, L, ld, lane);
  warp_invert_lower(L, m, Li, ld, lane);
  for (int e = lane; e < m * (m + 1) / 2; e += 32) {
    int i, j;
    packed_pair(e, i, j);
    const T v = inverse_entry_rt(Li, m, ld, i, j);
    buf[i * m + j] = v;
    buf[j * m + i] = v;
  }
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ void warp_copy(T* __restrict__ dst, const T* __restrict__ src,
                                          int count, int lane) {
  for (int k = lane; k < count; k += 32) dst[k] = src[k];
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
spd_inverse_large_kernel(const T* __restrict__ s, T* __restrict__ out, int64_t n, int m) {
  extern __shared__ __align__(16) unsigned char large_smem[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLargeWarps + warp;
  if (b >= n) return;  // whole warps only: nothing below syncs the CTA
  T* buf = reinterpret_cast<T*>(large_smem) + warp * large_warp_elems(m);
  T* L = buf + m * m;
  T* Li = L + m * large_ld(m);
  const int64_t mm = static_cast<int64_t>(m) * m;
  warp_copy(buf, s + b * mm, m * m, lane);
  warp_invert_in_place(buf, m, L, Li, lane);
  warp_copy(out + b * mm, buf, m * m, lane);
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
spd_inverse_factor_large_kernel(const T* __restrict__ s, T* __restrict__ inv,
                                T* __restrict__ chol, int64_t n, int m) {
  extern __shared__ __align__(16) unsigned char large_smem[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLargeWarps + warp;
  if (b >= n) return;
  const int ld = large_ld(m);
  T* buf = reinterpret_cast<T*>(large_smem) + warp * large_warp_elems(m);
  T* L = buf + m * m;
  T* Li = L + m * ld;
  const int64_t mm = static_cast<int64_t>(m) * m;
  warp_copy(buf, s + b * mm, m * m, lane);
  warp_invert_in_place(buf, m, L, Li, lane);
  warp_copy(inv + b * mm, buf, m * m, lane);
  // U = chol(S^-1), zeros above the diagonal, written over buf
  warp_cholesky_rt([&](int i, int j) { return buf[i * m + j]; }, m, L, ld, lane);
  for (int k = lane; k < m * m; k += 32) buf[k] = L[(k / m) * ld + k % m];
  __syncwarp();
  warp_copy(chol + b * mm, buf, m * m, lane);
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
spd_trace_product_large_kernel(const T* __restrict__ s, const T* __restrict__ g,
                               T* __restrict__ out, int64_t outer, int64_t inner, int m) {
  extern __shared__ __align__(16) unsigned char large_smem[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kLargeWarps + warp;
  if (t >= outer * inner) return;
  const int ld = large_ld(m);
  const int kT = m * (m + 1) / 2;
  T* L = reinterpret_cast<T*>(large_smem) + warp * (2 * m * ld);
  T* Li = L + m * ld;
  const int64_t o = t / inner;
  const int64_t base = o * (kT - 1) * inner + t;  // (o*T)*inner + (t - o*inner)
  const Packed<T> sb{s + base, inner};
  const Packed<T> gb{g + base, inner};
  warp_cholesky_rt(sb, m, L, ld, lane);
  warp_invert_lower(L, m, Li, ld, lane);
  T* terms = L;  // L is spent: the terms, in packed order
  for (int e = lane; e < kT; e += 32) {
    int i, j;
    packed_pair(e, i, j);
    T term = inverse_entry_rt(Li, m, ld, i, j) * gb(i, j);
    if (i != j) term = term + term;
    terms[e] = term;
  }
  __syncwarp();
  if (lane == 0) {
    T total = terms[0];
    for (int e = 1; e < kT; ++e) total = total + terms[e];
    out[t] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kLargeWarps * 32)
edge_factor_gain_large_kernel(const T* __restrict__ s_raw, const T* __restrict__ a_blk,
                              const T* __restrict__ r_table, const int64_t* __restrict__ action,
                              const T* __restrict__ mask, int64_t mask_stride,
                              T* __restrict__ wct, T* __restrict__ gain, int64_t n_missions,
                              int n, int m, int round_bf16) {
  extern __shared__ __align__(16) unsigned char large_smem[];
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kLargeWarps + warp;
  if (b >= n_missions) return;
  const int ld = large_ld(m);
  T* S = reinterpret_cast<T*>(large_smem) + warp * large_warp_elems(m);  // S_raw, row-major
  T* X = S + m * m;   // L, then S^-1 (lower triangle)
  T* Y = X + m * ld;  // L^-1 (lower triangle), then U
  const int64_t mm = static_cast<int64_t>(m) * m;
  warp_copy(S, s_raw + b * mm, m * m, lane);
  const int64_t act = __ldg(reinterpret_cast<const long long*>(action) + b);
  const T r_row = lane < m ? __ldg(r_table + act * m + lane) : T(0);

  // L of S = 0.5 (S_raw + S_raw^T) + diag(R); s(i, j) is asked of lane i
  warp_cholesky_rt(
      [&](int i, int j) {
        return T(0.5) * (S[i * m + j] + S[j * m + i]) + (i == j ? r_row : T(0));
      },
      m, X, ld, lane);
  warp_invert_lower(X, m, Y, ld, lane);
  for (int e = lane; e < m * (m + 1) / 2; e += 32) {
    int i, j;
    packed_pair(e, i, j);
    X[i * ld + j] = inverse_entry_rt(Y, m, ld, i, j);
  }
  __syncwarp();
  // U = chol(S^-1) into Y, zeros above the diagonal
  warp_cholesky_rt([&](int i, int j) { return X[i * ld + j]; }, m, Y, ld, lane);

  // WcT = U^T A, the squares and this lane's share of the gain; A is read
  // from global memory, the lanes on consecutive columns
  const T* A = a_blk + b * m * static_cast<int64_t>(n);
  T* out = wct + b * m * static_cast<int64_t>(n);
  const T* mrow = mask == nullptr ? nullptr : mask + b * mask_stride;
  T g = T(0);
  for (int c = 0, col = lane; col - lane < n; ++c, col += 32) {
    T sq = T(0);
    if (col < n) {
      T a[kMaxWarpM];
#pragma unroll
      for (int k = 0; k < kMaxWarpM; ++k) a[k] = k < m ? __ldg(A + k * n + col) : T(0);
      for (int r = 0; r < m; ++r) {
        T acc = Y[r] * a[0];  // U[0][r] A[0][col]
#pragma unroll
        for (int k = 1; k < kMaxWarpM; ++k) {
          if (k < m) acc = acc + Y[k * ld + r] * a[k];
        }
        if (round_bf16) acc = round_to_bf16(acc);
        out[r * n + col] = acc;
        sq = r == 0 ? acc * acc : sq + acc * acc;
      }
      if (mrow != nullptr) sq = sq * __ldg(mrow + col);
    }
    g = c == 0 ? sq : g + sq;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) g = g + __shfl_xor_sync(kFullMask, g, w);
  if (lane == 0) gain[b] = g;
}

// a kernel that needs more than 48 KB of dynamic shared memory is allowed
// it first: cudaSuccess, or the error that refused the size
template <typename K>
int allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
}

// ---------------------------------------------------------------- CTA route (M >= 33)

// position of row i of a packed lower triangle: entry (i, j) lies at tri(i) + j
__host__ __device__ __forceinline__ int64_t tri(int i) {
  return static_cast<int64_t>(i) * (i + 1) / 2;
}

// calls f(e, i, j) for the packed entries e = threadIdx.x, + blockDim.x, ...
// of an m x m lower triangle, (i, j) found by walking down the rows
template <typename F>
__device__ __forceinline__ void for_packed_entries(int m, F f) {
  int i = 0;
  int64_t row = 0;  // tri(i)
  for (int64_t e = threadIdx.x; e < tri(m); e += blockDim.x) {
    while (e >= row + i + 1) {
      row += i + 1;
      ++i;
    }
    f(e, i, static_cast<int>(e - row));
  }
}

// In place, across the CTA: on entry L holds the lower triangle of the SPD
// matrix (packed), on exit its Cholesky factor.  Column by column: each
// thread owns the rows i = threadIdx.x, + blockDim.x, ... and forms
// s(i, j) - sum_k L[i][k] L[j][k] (k in order, as `cholesky`); row j's sum
// is the pivot, passed on through `pivot` (one element of the workspace).
template <typename T>
__device__ __forceinline__ void cta_cholesky(T* L, int m, T* pivot) {
  for (int j = 0; j < m; ++j) {
    const T* Lj = L + tri(j);
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      if (i < j) continue;
      T* Li = L + tri(i);
      T acc = Li[j];
      for (int k = 0; k < j; ++k) acc = acc - Li[k] * Lj[k];
      if (i == j) {
        *pivot = acc;
      } else {
        Li[j] = acc;
      }
    }
    __syncthreads();
    const T d = sqrt(clamp_pivot(*pivot));
    const T inv_d = T(1) / d;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      if (i == j) {
        L[tri(j) + j] = d;
      } else if (i > j) {
        L[tri(i) + j] = L[tri(i) + j] * inv_d;
      }
    }
    __syncthreads();
  }
}

// Li = L^-1 (both packed) by forward substitution, the thread that owns
// column c running down it in the order of `inverse_factor`
template <typename T>
__device__ __forceinline__ void cta_invert_lower(const T* L, int m, T* Li) {
  for (int c = threadIdx.x; c < m; c += blockDim.x) {
    const T diag = T(1) / L[tri(c) + c];
    Li[tri(c) + c] = diag;
    for (int i = c + 1; i < m; ++i) {
      const T* Lr = L + tri(i);
      T acc = Lr[c] * diag;
      int64_t p = tri(c + 1) + c;  // Li[k][c], k = c + 1
      for (int k = c + 1; k < i; ++k) {
        acc = acc + Lr[k] * Li[p];
        p += k + 1;
      }
      Li[tri(i) + c] = -acc / Lr[i];
    }
  }
  __syncthreads();
}

// S^-1[i][j], i >= j, from the packed Li, in the order of `inverse_entry`
template <typename T>
__device__ __forceinline__ T cta_inverse_entry(const T* Li, int m, int i, int j) {
  int64_t p = tri(i);
  T acc = Li[p + i] * Li[p + j];
  for (int k = i + 1; k < m; ++k) {
    p += k;
    acc = acc + Li[p + i] * Li[p + j];
  }
  return acc;
}

// Cholesky (X in place), L^-1 into Y, then the lower triangle of S^-1 into
// X: on entry X holds the SPD matrix's lower triangle, packed
template <typename T>
__device__ __forceinline__ void cta_inverse(T* X, T* Y, int m, T* pivot) {
  cta_cholesky(X, m, pivot);
  cta_invert_lower(X, m, Y);
  for_packed_entries(m, [&](int64_t e, int i, int j) { X[e] = cta_inverse_entry(Y, m, i, j); });
  __syncthreads();
}

// the full m x m matrix whose lower triangle X holds (packed): symmetric,
// or with zeros above the diagonal
template <typename T>
__device__ __forceinline__ void cta_store(T* out, const T* X, int m, bool symmetric) {
  for (int64_t e = threadIdx.x; e < static_cast<int64_t>(m) * m; e += blockDim.x) {
    const int i = static_cast<int>(e / m), j = static_cast<int>(e % m);
    out[e] = i >= j ? X[tri(i) + j] : (symmetric ? X[tri(j) + i] : T(0));
  }
}

// elements of one CTA's workspace: the pivot (16 bytes), X and Y (two
// packed triangles) and, for edge_factor_gain, the n squares
template <typename T>
__host__ __device__ constexpr int64_t cta_pivot_elems() {
  return 16 / static_cast<int64_t>(sizeof(T));
}

template <typename T>
int64_t cta_workspace_elems(int m, int squares) {
  const int64_t elems = cta_pivot_elems<T>() + 2 * tri(m) + squares;
  return (elems + 31) / 32 * 32;  // a multiple of 128 bytes, so each CTA's slice stays aligned
}

// the workspace of CTA blockIdx.x: shared memory, or its slice of `global`
template <typename T>
__device__ __forceinline__ T* cta_workspace(T* global, int64_t elems) {
  extern __shared__ __align__(16) unsigned char cta_smem[];
  return global == nullptr ? reinterpret_cast<T*>(cta_smem) : global + blockIdx.x * elems;
}

template <typename T>
__global__ void __launch_bounds__(1024)
spd_inverse_cta_kernel(const T* __restrict__ s, T* __restrict__ out, int64_t n, int m,
                       T* workspace, int64_t ws_elems) {
  T* pivot = cta_workspace(workspace, ws_elems);
  T* X = pivot + cta_pivot_elems<T>();
  T* Y = X + tri(m);
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    const T* sb = s + b * mm;
    for_packed_entries(m, [&](int64_t e, int i, int j) { X[e] = sb[static_cast<int64_t>(i) * m + j]; });
    __syncthreads();
    cta_inverse(X, Y, m, pivot);
    cta_store(out + b * mm, X, m, true);
    __syncthreads();  // the next matrix overwrites X
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
spd_inverse_factor_cta_kernel(const T* __restrict__ s, T* __restrict__ inv,
                              T* __restrict__ chol, int64_t n, int m, T* workspace,
                              int64_t ws_elems) {
  T* pivot = cta_workspace(workspace, ws_elems);
  T* X = pivot + cta_pivot_elems<T>();
  T* Y = X + tri(m);
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    const T* sb = s + b * mm;
    for_packed_entries(m, [&](int64_t e, int i, int j) { X[e] = sb[static_cast<int64_t>(i) * m + j]; });
    __syncthreads();
    cta_inverse(X, Y, m, pivot);
    cta_store(inv + b * mm, X, m, true);
    __syncthreads();  // the store reads X before the factorisation overwrites it
    cta_cholesky(X, m, pivot);  // U = chol(S^-1)
    cta_store(chol + b * mm, X, m, false);
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
spd_trace_product_cta_kernel(const T* __restrict__ s, const T* __restrict__ g,
                             T* __restrict__ out, int64_t outer, int64_t inner, int m,
                             T* workspace, int64_t ws_elems) {
  T* pivot = cta_workspace(workspace, ws_elems);
  T* X = pivot + cta_pivot_elems<T>();
  T* Y = X + tri(m);
  const int64_t kT = tri(m);
  for (int64_t t = blockIdx.x; t < outer * inner; t += gridDim.x) {
    const int64_t o = t / inner;
    const int64_t base = o * (kT - 1) * inner + t;  // (o*T)*inner + (t - o*inner)
    for_packed_entries(m, [&](int64_t e, int, int) { X[e] = s[base + e * inner]; });
    __syncthreads();
    cta_cholesky(X, m, pivot);
    cta_invert_lower(X, m, Y);
    // X is spent: the terms, in packed order
    for_packed_entries(m, [&](int64_t e, int i, int j) {
      T term = cta_inverse_entry(Y, m, i, j) * g[base + e * inner];
      if (i != j) term = term + term;
      X[e] = term;
    });
    __syncthreads();
    if (threadIdx.x == 0) {  // the sum in packed order, as the plain version's
      T total = X[0];
      for (int64_t e = 1; e < kT; ++e) total = total + X[e];
      out[t] = total;
    }
    __syncthreads();
  }
}

constexpr int kWctRows = 8;  // rows of WcT that one pass over A's column accumulates

template <typename T>
__global__ void __launch_bounds__(1024)
edge_factor_gain_cta_kernel(const T* __restrict__ s_raw, const T* __restrict__ a_blk,
                            const T* __restrict__ r_table, const int64_t* __restrict__ action,
                            const T* __restrict__ mask, int64_t mask_stride,
                            T* __restrict__ wct, T* __restrict__ gain, int64_t n_missions,
                            int n, int m, int round_bf16, T* workspace, int64_t ws_elems) {
  T* pivot = cta_workspace(workspace, ws_elems);
  T* X = pivot + cta_pivot_elems<T>();  // S, L, S^-1, then U
  T* Y = X + tri(m);                    // L^-1
  T* SQ = Y + tri(m);                   // the masked squares of each column
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int64_t b = blockIdx.x; b < n_missions; b += gridDim.x) {
    const T* S = s_raw + b * mm;
    const T* R = r_table + __ldg(reinterpret_cast<const long long*>(action) + b) * m;
    // the lower triangle of S = 0.5 (S_raw + S_raw^T) + diag(R)
    for_packed_entries(m, [&](int64_t e, int i, int j) {
      X[e] = T(0.5) * (S[static_cast<int64_t>(i) * m + j] + S[static_cast<int64_t>(j) * m + i]) +
             (i == j ? R[i] : T(0));
    });
    __syncthreads();
    cta_inverse(X, Y, m, pivot);
    cta_cholesky(X, m, pivot);  // U = chol(S^-1)

    // WcT = U^T A in _small_mm order, kWctRows rows per pass over a column
    // of A (read from global memory, the threads on consecutive columns);
    // then each column's squares, summed over m in order, and masked
    const T* A = a_blk + b * m * static_cast<int64_t>(n);
    T* out = wct + b * m * static_cast<int64_t>(n);
    const T* mrow = mask == nullptr ? nullptr : mask + b * mask_stride;
    for (int col = threadIdx.x; col < n; col += blockDim.x) {
      T sq = T(0);
      for (int r0 = 0; r0 < m; r0 += kWctRows) {
        T acc[kWctRows];
        const T a0 = __ldg(A + col);
#pragma unroll
        for (int q = 0; q < kWctRows; ++q) acc[q] = (r0 + q == 0 ? X[0] : T(0)) * a0;
        int64_t p = 0;  // tri(k)
        for (int k = 1; k < m; ++k) {
          p += k;
          const T a = __ldg(A + static_cast<int64_t>(k) * n + col);
#pragma unroll
          for (int q = 0; q < kWctRows; ++q) {
            const int r = r0 + q;  // U[k][r], zero above the diagonal and past row m - 1
            acc[q] = acc[q] + (k >= r ? X[p + r] : T(0)) * a;
          }
        }
#pragma unroll
        for (int q = 0; q < kWctRows; ++q) {
          const int r = r0 + q;
          if (r < m) {
            const T v = round_bf16 ? round_to_bf16(acc[q]) : acc[q];
            out[static_cast<int64_t>(r) * n + col] = v;
            sq = r == 0 ? v * v : sq + v * v;
          }
        }
      }
      if (mrow != nullptr) sq = sq * __ldg(mrow + col);
      SQ[col] = sq;
    }
    __syncthreads();
    // gain: warp 0 walks the squares in the warp route's order (lane l adds
    // columns l, l + 32, ... in turn, zero past n), then the xor tree
    if (threadIdx.x < 32) {
      const int lane = static_cast<int>(threadIdx.x);
      T gsum = T(0);
      for (int c = 0, col = lane; col - lane < n; ++c, col += 32) {
        const T sq = col < n ? SQ[col] : T(0);
        gsum = c == 0 ? sq : gsum + sq;
      }
#pragma unroll
      for (int w = 16; w >= 1; w >>= 1) gsum = gsum + __shfl_xor_sync(kFullMask, gsum, w);
      if (lane == 0) gain[b] = gsum;
    }
    __syncthreads();
  }
}

// the CTA route's workspace limit in shared memory (bytes per CTA); past it
// the workspace is global memory.  Tests lower it to drive the global path.
int g_cta_shared_limit = kMaxSharedBytes;
constexpr int kWorkspaceCtas = 264;  // CTAs of a launch whose workspace is global memory

// threads of a CTA: one per row (a whole number of warps, at most 1024);
// edge_factor_gain takes at least 256, which share the columns of U^T A
inline int cta_threads(int m, bool edge) {
  int t = (m + 31) / 32 * 32;
  if (edge && t < 256) t = 256;
  return t < 1024 ? t : 1024;
}

// where the CTA route keeps a launch's workspace: `shared_bytes` > 0 for
// shared memory, else `global_bytes` of global memory for `ctas` CTAs
struct CtaPlan {
  int64_t ws_elems;
  unsigned ctas;
  size_t shared_bytes;
  int64_t global_bytes;
};

template <typename T>
CtaPlan cta_plan(int m, int squares, int64_t count) {
  CtaPlan p;
  p.ws_elems = cta_workspace_elems<T>(m, squares);
  const int64_t bytes = p.ws_elems * static_cast<int64_t>(sizeof(T));
  const bool shared = bytes <= g_cta_shared_limit;
  const int64_t cap = shared ? 0x7fffffff : kWorkspaceCtas;
  p.ctas = static_cast<unsigned>(count < cap ? count : cap);
  p.shared_bytes = shared ? static_cast<size_t>(bytes) : 0;
  p.global_bytes = shared ? 0 : bytes * p.ctas;
  return p;
}

// -2 when the caller's workspace is missing where the plan needs one
inline int check_workspace(const CtaPlan& p, const void* workspace) {
  return p.global_bytes > 0 && workspace == nullptr ? -2 : 0;
}

template <typename T>
T* plan_workspace(const CtaPlan& p, void* workspace) {
  return p.shared_bytes > 0 ? nullptr : static_cast<T*>(workspace);
}

template <typename T>
int launch_inverse_cta(const void* s, void* out, int64_t n, int m, void* workspace,
                       cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, 0, n);
  auto kernel = spd_inverse_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, cta_threads(m, false), p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n, m, plan_workspace<T>(p, workspace),
      p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse_factor_cta(const void* s, void* inv, void* chol, int64_t n, int m,
                              void* workspace, cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, 0, n);
  auto kernel = spd_inverse_factor_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, cta_threads(m, false), p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(inv), static_cast<T*>(chol), n, m,
      plan_workspace<T>(p, workspace), p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trace_cta(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                     int m, void* workspace, cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, 0, outer * inner);
  auto kernel = spd_trace_product_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, cta_threads(m, false), p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner, m,
      plan_workspace<T>(p, workspace), p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_cta(const void* s, const void* a_blk, const void* r, const void* action,
                    const void* mask, int64_t mask_stride, void* wct, void* gain,
                    int64_t n_missions, int n, int m, int round_bf16, void* workspace,
                    cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, n, n_missions);
  auto kernel = edge_factor_gain_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, cta_threads(m, true), p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(a_blk), static_cast<const T*>(r),
      static_cast<const int64_t*>(action), static_cast<const T*>(mask), mask_stride,
      static_cast<T*>(wct), static_cast<T*>(gain), n_missions, n, m, round_bf16,
      plan_workspace<T>(p, workspace), p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

// bytes of dynamic shared memory for kLargeWarps warps of `elems` each; a
// kernel that needs more than 48 KB is allowed it first.  cudaSuccess, or
// the error that refused the size (nothing launched)
template <typename K>
int large_smem_bytes(K kernel, int elems, int elem_size, size_t* bytes) {
  *bytes = static_cast<size_t>(kLargeWarps) * elems * elem_size;
  return allow_shared(kernel, *bytes);
}

inline unsigned large_blocks(int64_t n) {
  return static_cast<unsigned>((n + kLargeWarps - 1) / kLargeWarps);
}

template <typename T>
int launch_inverse_large(const void* s, void* out, int64_t n, int m, cudaStream_t stream) {
  size_t bytes;
  auto kernel = spd_inverse_large_kernel<T>;
  if (int err = large_smem_bytes(kernel, large_warp_elems(m), sizeof(T), &bytes)) return err;
  kernel<<<large_blocks(n), kLargeWarps * 32, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse_factor_large(const void* s, void* inv, void* chol, int64_t n, int m,
                                cudaStream_t stream) {
  size_t bytes;
  auto kernel = spd_inverse_factor_large_kernel<T>;
  if (int err = large_smem_bytes(kernel, large_warp_elems(m), sizeof(T), &bytes)) return err;
  kernel<<<large_blocks(n), kLargeWarps * 32, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(inv), static_cast<T*>(chol), n, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trace_large(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                       int m, cudaStream_t stream) {
  size_t bytes;
  auto kernel = spd_trace_product_large_kernel<T>;
  if (int err = large_smem_bytes(kernel, 2 * m * large_ld(m), sizeof(T), &bytes)) return err;
  kernel<<<large_blocks(outer * inner), kLargeWarps * 32, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner,
      m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_large(const void* s, const void* a_blk, const void* r, const void* action,
                      const void* mask, int64_t mask_stride, void* wct, void* gain,
                      int64_t n_missions, int n, int m, int round_bf16, cudaStream_t stream) {
  size_t bytes;
  auto kernel = edge_factor_gain_large_kernel<T>;
  if (int err = large_smem_bytes(kernel, large_warp_elems(m), sizeof(T), &bytes)) return err;
  kernel<<<large_blocks(n_missions), kLargeWarps * 32, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(a_blk), static_cast<const T*>(r),
      static_cast<const int64_t*>(action), static_cast<const T*>(mask), mask_stride,
      static_cast<T*>(wct), static_cast<T*>(gain), n_missions, n, m, round_bf16);
  return static_cast<int>(cudaGetLastError());
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

// cudaSuccess, a cudaError_t, or -1 when the shared slices of N columns do
// not fit a CTA (nothing launched)
template <int M, typename T>
int launch_edge(const void* s, const void* a_blk, const void* r, const void* action,
                const void* mask, int64_t mask_stride, void* wct, void* gain, int64_t n_missions,
                int n, int round_bf16, cudaStream_t stream) {
  const int64_t bytes = edge_register_bytes<T>(M, n);
  if (bytes > kMaxSharedBytes) return -1;
  auto kernel = edge_factor_gain_kernel<M, T>;
  if (int err = allow_shared(kernel, static_cast<size_t>(bytes))) return err;
  const unsigned blocks = static_cast<unsigned>((n_missions + kEdgeWarps - 1) / kEdgeWarps);
  kernel<<<blocks, kEdgeWarps * 32, static_cast<size_t>(bytes), stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(a_blk), static_cast<const T*>(r),
      static_cast<const int64_t*>(action), static_cast<const T*>(mask), mask_stride,
      static_cast<T*>(wct), static_cast<T*>(gain), n_missions, n, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

// calls F::run<M, T>() for M = 1..kMaxUnrolledM, F::run_large<T>(m) for
// the warp route (M = 13..32) and F::run_cta<T>(m) for M >= 33; -1 for
// M < 1 (nothing launched), else what the launcher returns (0, a
// cudaError_t, or -2 for a missing workspace)
template <typename T, typename F>
int dispatch_m(int m, F f) {
  switch (m) {
    case 1: return f.template run<1, T>();
    case 2: return f.template run<2, T>();
    case 3: return f.template run<3, T>();
    case 4: return f.template run<4, T>();
    case 5: return f.template run<5, T>();
    case 6: return f.template run<6, T>();
    case 7: return f.template run<7, T>();
    case 8: return f.template run<8, T>();
    case 9: return f.template run<9, T>();
    case 10: return f.template run<10, T>();
    case 11: return f.template run<11, T>();
    case 12: return f.template run<12, T>();
    default:
      if (m > kMaxUnrolledM && m <= kMaxWarpM) return f.template run_large<T>(m);
      if (m > kMaxWarpM) return f.template run_cta<T>(m);
      return -1;
  }
}

struct InverseLaunch {
  const void* s; void* out; int64_t n; void* workspace; cudaStream_t stream;
  template <int M, typename T> int run() const {
    launch_inverse<M, T>(s, out, n, stream);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T> int run_large(int m) const {
    return launch_inverse_large<T>(s, out, n, m, stream);
  }
  template <typename T> int run_cta(int m) const {
    return launch_inverse_cta<T>(s, out, n, m, workspace, stream);
  }
};

struct InverseFactorLaunch {
  const void* s; void* inv; void* chol; int64_t n; void* workspace; cudaStream_t stream;
  template <int M, typename T> int run() const {
    launch_inverse_factor<M, T>(s, inv, chol, n, stream);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T> int run_large(int m) const {
    return launch_inverse_factor_large<T>(s, inv, chol, n, m, stream);
  }
  template <typename T> int run_cta(int m) const {
    return launch_inverse_factor_cta<T>(s, inv, chol, n, m, workspace, stream);
  }
};

struct TraceLaunch {
  const void* s; const void* g; void* out; int64_t outer; int64_t inner; void* workspace;
  cudaStream_t stream;
  template <int M, typename T> int run() const {
    launch_trace<M, T>(s, g, out, outer, inner, stream);
    return static_cast<int>(cudaGetLastError());
  }
  template <typename T> int run_large(int m) const {
    return launch_trace_large<T>(s, g, out, outer, inner, m, stream);
  }
  template <typename T> int run_cta(int m) const {
    return launch_trace_cta<T>(s, g, out, outer, inner, m, workspace, stream);
  }
};

struct EdgeLaunch {
  const void* s; const void* a_blk; const void* r; const void* action; const void* mask;
  int64_t mask_stride; void* wct; void* gain; int64_t n_missions; int n; int round_bf16;
  void* workspace; cudaStream_t stream;
  // where the register route's shared slices of N columns do not fit a
  // CTA, the CTA route takes the launch (the same order of operations)
  template <int M, typename T> int run() const {
    const int err = launch_edge<M, T>(s, a_blk, r, action, mask, mask_stride, wct, gain,
                                      n_missions, n, round_bf16, stream);
    return err == -1 ? run_cta<T>(M) : err;
  }
  template <typename T> int run_large(int m) const {
    return launch_edge_large<T>(s, a_blk, r, action, mask, mask_stride, wct, gain, n_missions,
                                n, m, round_bf16, stream);
  }
  template <typename T> int run_cta(int m) const {
    return launch_edge_cta<T>(s, a_blk, r, action, mask, mask_stride, wct, gain, n_missions, n,
                              m, round_bf16, workspace, stream);
  }
};

// dtype codes: 0 = float32, 1 = float64
template <typename F>
int launch(int m, int dtype, F f) {
  if (dtype == 0) return dispatch_m<float>(m, f);
  if (dtype == 1) return dispatch_m<double>(m, f);
  return -1;
}

// bytes of global workspace the CTA route needs for a launch of `count`
// matrices (blocks, missions) of size m, with n_cells columns for
// edge_factor_gain: 0 where it runs in shared memory or another route
// takes the launch
template <typename T>
long long workspace_bytes(int kind, int m, int n_cells, long long count) {
  if (count <= 0 || m < 1) return 0;
  if (kind == 3) {  // edge_factor_gain: the register route unless its slices do not fit
    if (m <= kMaxUnrolledM) {
      if (edge_register_bytes<T>(m, n_cells) <= kMaxSharedBytes) return 0;
    } else if (m <= kMaxWarpM) {
      return 0;
    }
    return cta_plan<T>(m, n_cells, count).global_bytes;
  }
  if (m <= kMaxWarpM) return 0;
  return cta_plan<T>(m, 0, count).global_bytes;
}

}  // namespace

extern "C" {

// kind: 0 spd_inverse, 1 spd_inverse_factor, 2 spd_trace_product (count =
// outer * inner), 3 edge_factor_gain; -1 for an unknown dtype
long long smallchol_workspace_bytes(int kind, int m, int n_cells, long long count, int dtype) {
  if (dtype == 0) return workspace_bytes<float>(kind, m, n_cells, count);
  if (dtype == 1) return workspace_bytes<double>(kind, m, n_cells, count);
  return -1;
}

// sets the CTA route's shared-memory limit per CTA (bytes; past it the
// workspace is global memory) and returns the previous one
int smallchol_set_cta_shared_limit(int bytes) {
  const int previous = g_cta_shared_limit;
  g_cta_shared_limit = bytes < kMaxSharedBytes ? bytes : kMaxSharedBytes;
  return previous;
}

// `workspace`: smallchol_workspace_bytes(...) bytes of global memory, or
// nullptr where that is 0
int smallchol_spd_inverse(const void* s, void* out, long long n, int m, int dtype,
                          void* workspace, void* stream) {
  if (n <= 0) return 0;
  return launch(m, dtype,
                InverseLaunch{s, out, n, workspace, static_cast<cudaStream_t>(stream)});
}

int smallchol_spd_inverse_factor(const void* s, void* inv, void* chol, long long n, int m,
                                 int dtype, void* workspace, void* stream) {
  if (n <= 0) return 0;
  return launch(m, dtype, InverseFactorLaunch{s, inv, chol, n, workspace,
                                              static_cast<cudaStream_t>(stream)});
}

int smallchol_spd_trace_product(const void* s, const void* g, void* out, long long outer,
                                long long inner, int m, int dtype, void* workspace,
                                void* stream) {
  if (outer <= 0 || inner <= 0) return 0;
  return launch(m, dtype, TraceLaunch{s, g, out, outer, inner, workspace,
                                      static_cast<cudaStream_t>(stream)});
}

// s (n, M, M), a_blk (n, M, N), r (num_actions, M), action (n,) int64, mask
// (N,) with mask_stride 0, (n, N) with mask_stride N, or nullptr; writes
// wct (n, M, N) and gain (n,)
int smallchol_edge_factor_gain(const void* s, const void* a_blk, const void* r,
                               const void* action, const void* mask, long long mask_stride,
                               void* wct, void* gain, long long n, int m, int n_cells,
                               int round_bf16, int dtype, void* workspace, void* stream) {
  if (n <= 0) return 0;
  if (n_cells <= 0) return -1;
  return launch(m, dtype,
                EdgeLaunch{s, a_blk, r, action, mask, mask_stride, wct, gain, n, n_cells,
                           round_bf16, workspace, static_cast<cudaStream_t>(stream)});
}

const char* smallchol_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
