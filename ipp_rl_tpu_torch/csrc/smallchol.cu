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
// The warp route (13 <= M <= 32, the same four entry points): the
// register-resident design above needs M(M+1)/2 values per thread for L
// alone (325 at M = 25, past the 255 registers a thread may hold).  Each
// kernel here is unrolled for each M (a template parameter, so register
// arrays and shared offsets are compile-time):
//   spd_inverse_rows_kernel: one warp per matrix, lane i keeping row i of L
//     and lane c column c of L^-1 in registers, another lane's row or
//     column read by 16-byte broadcasts from a shared copy, S staged by
//     cp.async, S^-1 stored by 16-byte stores.  Bound at (4096, 25, 25),
//     f32: 20 MB moved, 6.1 us; it runs ~4x that, on its M-step chains.
//   spd_trace_product_lanes_kernel: one lane per block, a warp on 32
//     consecutive blocks, so every load of S and G is coalesced; the lane's
//     packed triangle in shared memory (41.6 KB a warp at M = 25 in f32, so
//     5 warps per SM), factored, inverted and multiplied in place two rows
//     or columns per step.  Bound on the 2 m sweep's 204,800 blocks, f32:
//     533 MB moved, 0.159 ms; it runs ~7x that, each lane's dependent chains
//     with too few warps to hide them.
//   spd_inverse_factor: factor_rows_kernel, spd_inverse_rows_kernel's steps,
//     then the same column-by-column Cholesky on S^-1's lower triangle (in
//     shared memory) with U's rows in registers; S^-1 and U stored.  Bound
//     at (1024, 25, 25), f32: 7.7 MB moved, 2.3 us; its ~4M dependent steps
//     bind, with about 8 warps per SM at B = 1024.
//   edge_factor_gain: two device kernels on one stream.  (1)
//     factor_rows_kernel again, S = 0.5 (S_raw + S_raw^T) + diag(R[a])
//     formed as the first Cholesky reads the staged S_raw; U^T stored dense
//     to the caller's global workspace, rows of kWarpLdu = 32 elements (3.3
//     MB at (1024, 25), L2-resident).  (2) edge_columns_kernel: a CTA per
//     mission, a thread per column of A with its column in registers, U^T's
//     rows by 16-byte broadcasts from shared memory, each column's squares
//     summed in registers, and the gain in the warp order by warp 0 (the
//     CTA route's tiled product and gain kernels, on the same U, took 1.9-
//     2.3x as long on an H100 at M = 25: a shared tile of squares, three
//     barriers and a (B, N) scratch per 64 columns, and 4 CTAs per SM;
//     scripts/probe_torch_edge_columns.cu).  Bound at (1024, 25, 400),
//     f32: 86 MB moved (A and WcT 41 MB each), 25.7 us; it runs ~2.8x that,
//     the factor's chains ~0.017 ms, then (2) ~0.043 ms.
// spd_inverse and spd_trace_product keep a second kind there, M a runtime
// argument, which the launch takes where it ran faster on the H100
// (kUnrolledMaxM: K2 at M = 32 in float64).  Each matrix or packed block is
// one warp's, its workspace in shared memory (L and L^-1 at a row stride
// of M | 1 elements, odd, so the lanes' rows fall in distinct banks), a CTA
// of kLargeWarps = 4 warps:
//   Cholesky, column by column (warp_cholesky_rt): lane i owns row i and
//     forms s(i,j) - sum_k L[i][k] L[j][k] (k in order) with L[j][k] read
//     from shared memory; lane j's sum gives the pivot by shuffle;
//   forward substitution (warp_invert_lower): lane j runs down column j;
//   the entries of S^-1 (each a sum over k in order) spread over the lanes.
// The one sum that the lanes cannot split without changing its order, the
// trace product's M(M+1)/2 terms, lane 0 adds up in order.  A simple
// design, not a fast one: at M = 25 a warp does ~M^2 dependent steps with
// most lanes idle.  Every kernel of the route keeps each sum in the plain
// versions' order, so it is bitwise equal to them too.
// The CTA route (M >= 33, up to kMaxCtaM; the same four entry points, and
// edge_factor_gain at M <= 12 where the register route's shared slices of
// N columns do not fit a CTA).  Each matrix (each mission, each of K1's and
// K3's matrices) is one CTA's, of cta_threads(M) threads; the trace
// product's CTA takes `slots` blocks at once, one group of cta_threads(M)
// threads and one named barrier each.  Its factorisations are right-looking
// wavefronts, each entry's operations in the plain versions' order:
//   Cholesky (cta_cholesky): before step k the columns 0..k of L are final
//     and column k is published in a shared buffer; step k scales column k,
//     subtracts term k, L[i][k] L[j][k], from every trailing entry and
//     publishes column k + 1 with its pivot (clamp, sqrt, 1/d); one barrier
//     per column;
//   forward substitution (cta_invert_lower), row by row: step k adds term
//     k to every entry (i, c), i > k >= c, and finishes and publishes row
//     k + 1; one barrier per row;
//   the entries of S^-1 (cta_inverse_entries), 4 x 4 tiles per thread,
//     sums in registers, 8 shared loads per 16 products.
// Up to M = kMaxRegisterM (176) the two wavefronts keep the matrix in
// registers, one 4 x 4 tile per thread (cta_threads(M): 256 at M = 81, 512
// at M = 121), and a step reads the published column (or row) as two
// 16-byte loads per tile; past it the same steps run on the packed triangle
// in shared memory (cta_cholesky_shared, cta_invert_lower_shared), one
// thread per row.  The dependent chain per factorisation is M barrier
// steps, not the ~M^2 / 2 steps of a left-looking column walk.
// The workspace is two column buffers and two packed triangles, X and Y
// ((2M + M(M + 1)) elements: 27 KB at M = 81 and 60 KB at M = 121 in
// float32, 118 KB at M = 121 in float64).  It lives in shared memory up to
// kMaxSharedBytes per CTA (every M <= 169 in float64), else in global
// memory (L2-resident): the same code through another pointer, a
// caller-allocated slice per CTA for kWorkspaceCtas CTAs that stride over
// the batch (smallchol_workspace_bytes says how much; one slot per CTA
// there).
//   spd_trace_product: slots = the largest power of two <= kTraceSlots (2)
//     whose workspaces fit: at M = 81 in float32 two groups of 256 threads
//     (54 KB), two CTAs resident per SM (64 registers a thread), four
//     blocks in flight.  The slots' blocks are consecutive in `inner`, so
//     staging reads entry e of both blocks from one 32-byte sector (S, then
//     G in L's place once the factors are done); a ragged tail of blocks is
//     masked by index.  Each slot writes its terms (2 - d_ij) S^-1[i,j]
//     G[i,j] in packed order over G, and thread s then adds slot s's terms
//     in packed order, the plain version's, so the slots' serial sums run
//     at once.  More slots (4, 8) read whole sectors but run slower: every
//     slot waits at the CTA's barriers for the slowest, and the register
//     tiles hold a CTA of 1024 threads to one per SM.
//   edge_factor_gain: three device kernels on one stream.  (1) One CTA per
//     mission factors S = 0.5 (S_raw + S_raw^T) + diag(R[a]) into U =
//     chol(S^-1) and writes it dense (rows padded to the product's pass,
//     zeros above the diagonal) to the caller's global workspace (11 MB at
//     (192, 121), L2-resident).  (2) WcT = U^T A (edge_product_kernel): a CTA
//     of 16 x 16 threads per (mission, 64 columns of A), TM x 4 outputs per
//     thread in registers (TM = 8 at M >= 33: passes of 128 rows; 2 below),
//     k-chunks of 16 rows of U and A staged by cp.async, double-buffered;
//     every output summed over k = 0..M-1 in order, U's zero terms kept, as
//     _small_mm;
//     then the bf16 round trip, coalesced stores along N, each column's
//     squares added over m in order by one thread from a shared tile, the
//     mask; the masked squares to a (B, N) scratch.  (3) One warp per
//     mission adds them in the warp route's lane order and xor tree.
//   No tensor cores: float32 runs in full float32 throughout the port (TF32
//   off), wgmma takes no full-float32 input, float64 mma fuses the multiply
//   and the add (which -fmad=false rules out), and every sum keeps the plain
//   versions' order.  So the products run on the FP32/FP64 pipes, one
//   multiply and one add per term: an operations bound taken at the 67
//   TFLOP/s that counts an FMA as two can be reached to about half at most.
//
// Numerics: the operations and their order are those of the plain PyTorch
// versions (ops/smallchol.py), and the library is built with -fmad=false
// (no multiply-add contraction) and IEEE division and square root, so on
// the same inputs kernel and plain version agree to the last bit.  Only
// the addressing differs between the layouts.
//
// Interface: plain C, loaded with ctypes by ops/kernels.py; pointers and
// the stream arrive as void*.  Each launcher returns 0, a cudaError_t from
// cudaGetLastError() after the launch, -1 for an unsupported M (below 1 or
// past kMaxCtaM), dtype or size, or -2 for a missing global workspace (nothing launched).

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

// ---------------------------------------------------------------- warp route, unrolled

// elements by which a staging buffer starts past a 16-byte boundary, so
// that it agrees with p modulo 16 bytes
template <typename T>
__device__ __forceinline__ int align_offset(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// count elements from global src to shared dst, which agree modulo 16 bytes,
// by the warp's lanes as asynchronous copies: 16-byte copies over the
// aligned middle, one element each before and after it
template <typename T>
__device__ __forceinline__ void warp_stage_async(T* dst, const T* src, int count, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  int head = (kVec - align_offset<T>(src)) % kVec;
  head = head < count ? head : count;
  const int vecs = (count - head) / kVec;
  const int rest = head + vecs * kVec;
  if (lane < head) cp_async_small<sizeof(T)>(dst + lane, src + lane);
  for (int k = lane; k < vecs; k += 32) cp_async_16(dst + head + k * kVec, src + head + k * kVec);
  for (int k = rest + lane; k < count; k += 32) cp_async_small<sizeof(T)>(dst + k, src + k);
}

// count elements from shared src to global dst by the warp's lanes: 16-byte
// stores over the aligned middle where the two agree modulo 16 bytes, else
// one element each
template <typename T>
__device__ __forceinline__ void warp_store(T* dst, const T* src, int count, int lane) {
  constexpr int kVec = 16 / sizeof(T);
  int head = count;
  if (align_offset<T>(dst) == align_offset<T>(src)) {
    head = (kVec - align_offset<T>(dst)) % kVec;
    head = head < count ? head : count;
  }
  const int vecs = (count - head) / kVec;
  const int rest = head + vecs * kVec;
  for (int k = lane; k < head; k += 32) dst[k] = src[k];
  for (int k = lane; k < vecs; k += 32) {
    reinterpret_cast<float4*>(dst + head)[k] = reinterpret_cast<const float4*>(src + head)[k];
  }
  for (int k = rest + lane; k < count; k += 32) dst[k] = src[k];
}

// the row stride of spd_inverse_rows_kernel's L and L^-1 in shared memory:
// M rounded up to 4, so every row starts 16-byte aligned
__host__ __device__ constexpr int rows_ld(int m) { return (m + 3) / 4 * 4; }

// v = p[0..3], p 16-byte aligned in shared memory (a broadcast when the
// warp's lanes read one address)
template <typename T>
__device__ __forceinline__ void load4(const T* p, T (&v)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  }
}

// -acc / d for a pivot d (positive, or NaN).  A zero dividend sends the
// division down its slow path, and most entries of L and L^-1 are zeros on
// sparse S (the 2 m sweep's); where acc is a zero the quotient is -acc
// itself, so a zero is divided as 1 and the result replaced, without a
// branch
template <typename T>
__device__ __forceinline__ T neg_quotient(T acc, T d) {
  const bool zero = acc == T(0);
  const T q = -(zero ? T(1) : acc) / d;
  return zero && d == d ? -acc : q;
}

// The warp route's row kernels (13 <= M <= 32, M unrolled): one warp per
// matrix, lane i keeping row i of a factor in registers (lanes past M - 1
// repeat row M - 1 and store nothing), another lane's row or column read
// from a shared copy (rows of rows_ld(M) elements) by 16-byte broadcast
// loads.  Each sum in the plain version's order.

// Cholesky, column by column: for column j, lane `row` forms s(j), its entry
// (row, j), minus L[row][k] L[j][k] for k < j in order (row j of the copy by
// broadcast), takes the pivot by shuffle from lane j, and writes L[row][j]
// to the copy once the column is done.  Lrow and the copy's rows get zeros
// above the diagonal.
template <int M, typename T, typename Entry>
__device__ __forceinline__ void rows_cholesky(const Entry& s, T* lsh, int row, int lane,
                                              T (&Lrow)[M]) {
  constexpr int kLd = rows_ld(M);
#pragma unroll
  for (int j = 0; j < M; ++j) {
    T acc = s(j);
#pragma unroll
    for (int k4 = 0; k4 < j; k4 += 4) {
      T v[4];
      load4(lsh + j * kLd + k4, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (k4 + u < j) acc = acc - Lrow[k4 + u] * v[u];
      }
    }
    const T d = sqrt(clamp_pivot(__shfl_sync(kFullMask, acc, j)));
    const T inv_d = T(1) / d;
    Lrow[j] = row == j ? d : (row > j ? acc * inv_d : T(0));
    if (lane < M) lsh[row * kLd + j] = Lrow[j];
    __syncwarp();
  }
}

// forward substitution on the copy of L: lane `row` keeps column `row` of
// L^-1 in registers (Lic[i] = L^-1[i][row] for i >= row) and runs down it,
// row i of L by broadcast loads; every sum starts at -0 (-0 + x = x), so
// the lanes' different first terms need no branch
template <int M, typename T>
__device__ __forceinline__ void rows_invert_lower(const T* lsh, int row, T (&Lic)[M]) {
  constexpr int kLd = rows_ld(M);
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = T(-0.0);
    T lii = T(0);
#pragma unroll
    for (int k4 = 0; k4 <= i; k4 += 4) {
      T v[4];
      load4(lsh + i * kLd + k4, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k4 + u;
        if (k < i && k >= row) acc = acc + v[u] * Lic[k];
        if (k == i) lii = v[u];
      }
    }
    Lic[i] = row == i ? T(1) / lii : neg_quotient(acc, lii);
  }
}

// S^-1 = L^-T L^-1 into buf (row-major M x M, both triangles): the lanes
// write their columns of L^-1 over the copy of L (column c at lsh[c * kLd]),
// then lane j forms column j of S^-1, column i of L^-1 by broadcast loads,
// and writes (i, j) and (j, i) for i >= j
template <int M, typename T>
__device__ __forceinline__ void rows_inverse_entries(T* lsh, int row, int lane, const T (&Lic)[M],
                                                     T* buf) {
  constexpr int kLd = rows_ld(M);
  __syncwarp();  // every lane has read L and buf
  if (lane < M) {
#pragma unroll
    for (int k = 0; k < M; ++k) {
      if (k >= row) lsh[row * kLd + k] = Lic[k];
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < M; ++i) {
    T acc = T(-0.0);
#pragma unroll
    for (int k4 = i / 4 * 4; k4 < M; k4 += 4) {
      T v[4];
      load4(lsh + i * kLd + k4, v);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = k4 + u;
        if (k >= i && k < M) acc = acc + v[u] * Lic[k];
      }
    }
    if (lane <= i) {
      buf[i * M + lane] = acc;
      buf[lane * M + i] = acc;
    }
  }
  __syncwarp();
}

// shared memory of a row kernel: the copy of a factor, then the staged
// matrix (M * M) at the staging source's offset modulo 16 bytes
template <int M, typename T>
struct RowsSmem {
  static constexpr int kLd = rows_ld(M);
  static constexpr int elems = M * kLd + M * M + 16 / static_cast<int>(sizeof(T));
};

// S^-1 of one M x M matrix per warp.  The matrix is staged by cp.async (one
// commit, one wait); the Cholesky factor, L^-1 and S^-1 as above; S^-1 is
// written over the staged matrix, which the warp then stores with 16-byte
// stores.  One warp per CTA, so a small batch (B = 256 on the 2 m grid's
// commit) spreads over the SMs.
template <int M, typename T>
__global__ void __launch_bounds__(32)
spd_inverse_rows_kernel(const T* __restrict__ s, T* __restrict__ out) {
  constexpr int kMM = M * M;
  __shared__ __align__(16) T smem[RowsSmem<M, T>::elems];
  T* lsh = smem;
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t off = static_cast<int64_t>(blockIdx.x) * kMM;
  T* buf = smem + M * rows_ld(M) + align_offset<T>(s + off);
  warp_stage_async(buf, s + off, kMM, lane);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();

  const int row = lane < M ? lane : M - 1;
  T Lrow[M];
  rows_cholesky<M>([&](int j) { return buf[row * M + j]; }, lsh, row, lane, Lrow);
  T Lic[M];
  rows_invert_lower<M>(lsh, row, Lic);
  rows_inverse_entries<M>(lsh, row, lane, Lic, buf);
  warp_store(out + off, buf, kMM, lane);
}

// the row stride of U^T in edge_factor_gain's global workspace at M = 13..32
constexpr int kWarpLdu = 32;

// S^-1 and U = chol(S^-1) of one M x M matrix per warp, for
// spd_inverse_factor's warp route and for edge_factor_gain's part 1 (one
// kernel for both, so the build compiles it once per M and dtype):
// spd_inverse_rows_kernel, then a second rows_cholesky on S^-1's lower
// triangle (the staged buffer) into the copy.
//   spd_inverse_factor (r_table == nullptr): S as staged; S^-1 stored to
//     inv, U to chol (row-major, zeros above the diagonal).
//   edge_factor_gain (r_table set): S = 0.5 (S_raw + S_raw^T) + diag(R[a]),
//     formed while the first Cholesky reads the staged S_raw; only U^T
//     stored, dense to ut (rows of kWarpLdu elements, ut[m][k] = U[k][m],
//     zeros below the diagonal and in the padding), one coalesced row at a
//     time.
template <int M, typename T>
__global__ void __launch_bounds__(32)
factor_rows_kernel(const T* __restrict__ s, const T* __restrict__ r_table,
                   const int64_t* __restrict__ action, T* __restrict__ inv,
                   T* __restrict__ chol, T* __restrict__ ut) {
  constexpr int kMM = M * M;
  constexpr int kLd = rows_ld(M);
  __shared__ __align__(16) T smem[RowsSmem<M, T>::elems];
  T* lsh = smem;
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t b = blockIdx.x;
  const int64_t off = b * kMM;
  T* buf = smem + M * kLd + align_offset<T>(s + off);
  warp_stage_async(buf, s + off, kMM, lane);
  cp_async_commit();
  const int row = lane < M ? lane : M - 1;
  const bool edge = r_table != nullptr;
  T r_row = T(0);
  if (edge) {
    const int64_t act = __ldg(reinterpret_cast<const long long*>(action) + b);
    r_row = __ldg(r_table + act * M + row);
  }
  cp_async_wait<0>();
  __syncwarp();

  T F[M];  // row `row` of L, then column `row` of L^-1, then row `row` of U
  rows_cholesky<M>(
      [&](int j) {
        return edge ? T(0.5) * (buf[row * M + j] + buf[j * M + row]) + (row == j ? r_row : T(0))
                    : buf[row * M + j];
      },
      lsh, row, lane, F);
  rows_invert_lower<M>(lsh, row, F);
  rows_inverse_entries<M>(lsh, row, lane, F, buf);
  if (!edge) warp_store(inv + off, buf, kMM, lane);
  rows_cholesky<M>([&](int j) { return buf[row * M + j]; }, lsh, row, lane, F);
  if (!edge) {
    for (int e = lane; e < kMM; e += 32) chol[off + e] = lsh[(e / M) * kLd + e % M];
    return;
  }
  T* ub = ut + b * (M * kWarpLdu);
#pragma unroll 4
  for (int m = 0; m < M; ++m) ub[m * kWarpLdu + lane] = lane < M ? lsh[lane * kLd + m] : T(0);
}

// threads of edge_columns_kernel: one column of A each, in passes over N
constexpr int kColumnsThreads = 256;

// edge_factor_gain's warp route, parts 2 and 3 in one kernel: per mission,
// WcT = U^T A, the squares, the mask and the gain.  One CTA per mission, a
// thread per column of A (passes of kColumnsThreads columns).  U^T is
// staged into shared memory (rows of rows_ld(M)), the thread keeps its
// column of A in registers (coalesced loads along N) and forms its column
// of WcT row by row, each sum over k = 0..M-1 in order from -0 with U's
// zeros kept (the _small_mm order; row m reads U^T's row m by 16-byte
// broadcast loads); then the bf16 round trip, the store (coalesced along
// N), and the square added to the column's sum in row order, in registers.
// The masked sums of a pass go to shared memory, and warp 0's lane l adds
// columns l, l + 32, ... in turn (the warp order; zero past N), then the
// xor tree, so the gain is the other routes' bit for bit.  Against the CTA
// route's tiled product and gain kernels, no tile of squares is staged, no
// sums cross threads but the gain's, and no (B, N) scratch is written.
template <int M, typename T>
__global__ void __launch_bounds__(kColumnsThreads)
edge_columns_kernel(const T* __restrict__ ut, const T* __restrict__ a_blk,
                    const T* __restrict__ mask, int64_t mask_stride, T* __restrict__ wct,
                    T* __restrict__ gain, int n, int round_bf16) {
  constexpr int kLd = rows_ld(M);
  __shared__ __align__(16) T us[M * kLd];  // us[m * kLd + k] = U[k][m]
  __shared__ T sqs[kColumnsThreads];
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int64_t b = blockIdx.x;
  const T* ub = ut + b * (M * kWarpLdu);
  for (int e = tid; e < M * kLd; e += kColumnsThreads) {
    us[e] = ub[(e / kLd) * kWarpLdu + e % kLd];  // kLd <= kWarpLdu: the padding's zeros
  }
  __syncthreads();
  const T* ab = a_blk + b * M * static_cast<int64_t>(n);
  T* ob = wct + b * M * static_cast<int64_t>(n);
  const T* mrow = mask == nullptr ? nullptr : mask + b * mask_stride;
  T g = T(0);  // warp 0: lane's running sum of the warp order
  for (int c0 = 0; c0 < n; c0 += kColumnsThreads) {
    const int col = c0 + tid;
    T sq = T(0);
    if (col < n) {
      T a[M];
#pragma unroll
      for (int k = 0; k < M; ++k) a[k] = __ldg(ab + static_cast<int64_t>(k) * n + col);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        T acc = T(-0.0);
#pragma unroll
        for (int k4 = 0; k4 < M; k4 += 4) {
          T v[4];
          load4(us + m * kLd + k4, v);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (k4 + u < M) acc = acc + v[u] * a[k4 + u];
          }
        }
        if (round_bf16) acc = round_to_bf16(acc);
        ob[static_cast<int64_t>(m) * n + col] = acc;
        sq = m == 0 ? acc * acc : sq + acc * acc;
      }
      if (mrow != nullptr) sq = sq * __ldg(mrow + col);
    }
    sqs[tid] = sq;
    __syncthreads();
    if (tid < 32) {
#pragma unroll
      for (int w = 0; w < kColumnsThreads / 32; ++w) {
        const int chunk = c0 / 32 + w;
        if (32 * chunk < n) g = chunk == 0 ? sqs[w * 32 + lane] : g + sqs[w * 32 + lane];
      }
    }
    __syncthreads();  // warp 0 has read the pass before the next overwrites it
  }
  if (tid < 32) {
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) g = g + __shfl_xor_sync(kFullMask, g, w);
    if (lane == 0) gain[b] = g;
  }
}

// The lane-per-block trace product's three passes over a lane's packed
// triangle x (entry e at x[e * 32]), each on R = 1 or 2 rows or columns at
// a time.

// rows i .. i + R - 1 of L in place over S, rows 0 .. i - 1 done, each
// entry as `cholesky` forms it: the rows in registers, L[j][k] from shared;
// inv_d[j] = 1 / L[j][j] for j < i on entry, for j < i + R on return
template <int M, int R, typename T>
__device__ __forceinline__ void lanes_cholesky_rows(T* x, int i, T (&inv_d)[M]) {
  T* xr[R];
  T r[R][M];
#pragma unroll
  for (int q = 0; q < R; ++q) xr[q] = x + ((i + q) * (i + q + 1) / 2) * 32;
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    if (j < i) {
      T a[R];
#pragma unroll
      for (int q = 0; q < R; ++q) a[q] = xr[q][j * 32];
#pragma unroll
      for (int k = 0; k < j; ++k) {
        const T l = x[(j * (j + 1) / 2 + k) * 32];
#pragma unroll
        for (int q = 0; q < R; ++q) a[q] = a[q] - r[q][k] * l;
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        r[q][j] = a[q] * inv_d[j];
        xr[q][j * 32] = r[q][j];
      }
    }
  }
  T acc = xr[0][i * 32];
#pragma unroll
  for (int k = 0; k < M - 1; ++k) {
    if (k < i) acc = acc - r[0][k] * r[0][k];
  }
  const T d0 = sqrt(clamp_pivot(acc));
  xr[0][i * 32] = d0;
  const T inv0 = T(1) / d0;
  if constexpr (R == 2) {  // L[i + 1][i], then row i + 1's pivot
    T a = xr[1][i * 32];
#pragma unroll
    for (int k = 0; k < M - 1; ++k) {
      if (k < i) a = a - r[1][k] * r[0][k];
    }
    const T l10 = a * inv0;
    xr[1][i * 32] = l10;
    T acc1 = xr[1][(i + 1) * 32];
#pragma unroll
    for (int k = 0; k < M - 1; ++k) {
      if (k < i) acc1 = acc1 - r[1][k] * r[1][k];
    }
    acc1 = acc1 - l10 * l10;
    const T d1 = sqrt(clamp_pivot(acc1));
    xr[1][(i + 1) * 32] = d1;
    const T inv1 = T(1) / d1;
#pragma unroll
    for (int q = 0; q < M; ++q) inv_d[q] = q == i ? inv0 : (q == i + 1 ? inv1 : inv_d[q]);
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) inv_d[q] = q == i ? inv0 : inv_d[q];
  }
}

// columns c .. c + R - 1 of L^-1 in place over L, columns 0 .. c - 1 done,
// as `inverse_factor`: column c of L^-1 reads only L[i][k] with k >= c, the
// diagonals below it and itself (in registers), so nothing is read after it
// is overwritten.  With R = 2, row i's entries of both columns are formed
// before either is written: column c reads L[i][c + 1], which column c + 1
// overwrites.
template <int M, int R, typename T>
__device__ __forceinline__ void lanes_invert_columns(T* x, int c) {
  T col[R][M];  // col[q][dd] = L^-1[c + q + dd][c + q]
  T* xc = x + (c * (c + 1) / 2 + c) * 32;
  col[0][0] = T(1) / xc[0];
  xc[0] = col[0][0];
#pragma unroll
  for (int dd = 1; dd < M; ++dd) {
    if (c + dd < M) {
      const int i = c + dd;
      T* xi = x + (i * (i + 1) / 2 + c) * 32;  // L[i][c + d] at xi[d * 32]
      T acc0 = xi[0] * col[0][0];
      T acc1 = T(0);
      if constexpr (R == 2) {
        if (dd >= 2) acc1 = xi[32] * col[1][0];
      }
#pragma unroll
      for (int d = 1; d < dd; ++d) {
        const T l = xi[d * 32];
        acc0 = acc0 + l * col[0][d];
        if constexpr (R == 2) {
          if (d >= 2) acc1 = acc1 + l * col[1][d - 1];
        }
      }
      const T lii = xi[dd * 32];
      col[0][dd] = neg_quotient(acc0, lii);
      xi[0] = col[0][dd];
      if constexpr (R == 2) {
        const int r = dd == 1 ? 0 : dd - 1;
        col[1][r] = dd == 1 ? T(1) / lii : neg_quotient(acc1, lii);
        xi[32] = col[1][r];
      }
    }
  }
}

// the terms (2 - d_ij) S^-1[i][j] G[i][j] of columns j .. j + R - 1, each
// written over L^-1[i][j]: entry (i, j) reads column j of L^-1 (in
// registers) and column i >= j (shared), which is overwritten only later
// or, for i = j + 1 with R = 2, after both entries of row i are formed
template <int M, int R, typename T>
__device__ __forceinline__ void lanes_term_columns(T* x, const T* gb, int64_t inner, int j) {
  T col[R][M];   // col[q][k] = L^-1[k][j + q], k >= j + q
  T gcol[R][M];  // gcol[q][i] = G[i][j + q], i >= j + q
#pragma unroll
  for (int k = 0; k < M; ++k) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (k >= j + q) {
        col[q][k] = x[(k * (k + 1) / 2 + j + q) * 32];
        gcol[q][k] = __ldg(gb + (k * (k + 1) / 2 + j + q) * inner);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i >= j) {
      const T dii = x[(i * (i + 1) / 2 + i) * 32];
      T acc[R];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = dii * col[q][i];
#pragma unroll
      for (int k = i + 1; k < M; ++k) {
        const T l = x[(k * (k + 1) / 2 + i) * 32];
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] = acc[q] + l * col[q][k];
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (i >= j + q) {
          T term = acc[q] * gcol[q][i];
          if (i != j + q) term = term + term;
          x[(i * (i + 1) / 2 + j + q) * 32] = term;
        }
      }
    }
  }
}

// tr(S^-1 G) of 32 consecutive blocks t per warp, one lane per block
// (13 <= M <= 32), M unrolled.  Entry e of a warp's blocks is one coalesced
// load from the entries-major layout.  Each lane runs its block's whole
// chain on its own packed triangle in shared memory, interleaved by lane
// (entry e of lane l at e * 32 + l: a warp's 32 accesses to one entry hit
// 32 banks), each sum in the plain version's order:
//   S's triangle is staged by cp.async, one element each;
//   Cholesky two rows at a time in place: the rows in registers, L[j][k]
//     from shared, two chains per step (lanes_cholesky_rows);
//   L^-1 two columns at a time in place (lanes_invert_columns);
//   S^-1 two columns at a time, each entry's term written over L^-1[i][j]
//     (lanes_term_columns);
//   the terms added in packed order.
// The outer loops (rows, columns) run at run time with one uniform guard
// per entry; every inner loop unrolls to register indices and immediate
// shared offsets.  Two rows or columns per step give each step two
// independent chains that share their shared-memory loads.
template <int M, typename T>
__global__ void __launch_bounds__(32)
spd_trace_product_lanes_kernel(const T* __restrict__ s, const T* __restrict__ g,
                               T* __restrict__ out, int64_t outer, int64_t inner) {
  constexpr int kT = M * (M + 1) / 2;
  extern __shared__ __align__(16) unsigned char lanes_smem[];
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t n = outer * inner;
  const int64_t mine = static_cast<int64_t>(blockIdx.x) * 32 + lane;
  const int64_t t = mine < n ? mine : n - 1;  // lanes past the end repeat the last block
  const int64_t o = t / inner;
  const int64_t base = o * (kT - 1) * inner + t;  // (o*T)*inner + (t - o*inner)
  T* x = reinterpret_cast<T*>(lanes_smem) + lane;  // entry e at x[e * 32]
  {
    const T* src = s + base;
#pragma unroll 8
    for (int e = 0; e < kT; ++e, src += inner) cp_async_small<sizeof(T)>(x + e * 32, src);
  }
  cp_async_commit();
  cp_async_wait<0>();  // each lane reads only what it copied

  T inv_d[M] = {};
#pragma unroll 1
  for (int i = 0; i + 1 < M; i += 2) lanes_cholesky_rows<M, 2>(x, i, inv_d);
  if (M % 2 == 1) lanes_cholesky_rows<M, 1>(x, M - 1, inv_d);
#pragma unroll 1
  for (int c = 0; c + 1 < M; c += 2) lanes_invert_columns<M, 2>(x, c);
  if (M % 2 == 1) lanes_invert_columns<M, 1>(x, M - 1);
  const T* gb = g + base;
#pragma unroll 1
  for (int j = 0; j + 1 < M; j += 2) lanes_term_columns<M, 2>(x, gb, inner, j);
  if (M % 2 == 1) lanes_term_columns<M, 1>(x, gb, inner, M - 1);

  T total = x[0];
#pragma unroll 8
  for (int e = 1; e < kT; ++e) total = total + x[e * 32];
  if (mine < n) out[mine] = total;
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

// the CTA route takes M up to this, so that tri(M) and every packed index
// fit a 32-bit int (a matrix there is already 8.6 GB in float64)
constexpr int kMaxCtaM = 46340;

// position of row i of a packed lower triangle: entry (i, j) lies at tri(i) + j
__host__ __device__ __forceinline__ int64_t tri(int i) {
  return static_cast<int64_t>(i) * (i + 1) / 2;
}

__device__ __forceinline__ int tri32(int i) { return i * (i + 1) / 2; }

// the row i of packed entry q, tri(i) <= q < tri(i + 1): a float estimate,
// then corrected
__device__ __forceinline__ int packed_row(int q) {
  int i = __float2int_rz((__fsqrt_rn(8.0f * static_cast<float>(q) + 1.0f) - 1.0f) * 0.5f);
  while (tri(i + 1) <= q) ++i;
  while (tri(i) > q) --i;
  return i;
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

// The threads that factor one matrix: `size` of them (a whole number of
// warps), this thread's rank `tid` among them, and the barrier they share
// (0: the whole CTA; 1 + slot for one slot of the trace product's CTA).
struct Group {
  int tid;
  int size;
  int bar;
  __device__ __forceinline__ void sync() const {
    if (bar == 0) {
      __syncthreads();
    } else {
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(size) : "memory");
    }
  }
};

// In place, across the group: on entry X holds the lower triangle of the
// SPD matrix (packed), on exit its Cholesky factor.  C holds two columns
// (2m elements).  Right-looking: before step k the columns 0..k of L are
// final and column k is also in C[k & 1].  In step k the group's first warp
// subtracts term k from column k + 1, takes its pivot (clamp, sqrt, 1/d)
// and scales the column (into X and C[(k + 1) & 1]), while every thread
// subtracts term k, L[i][k] L[j][k], from the trailing entries (i, j),
// k + 2 <= j <= i, spread over the group in packed order.  So each entry
// sees s(i, j) - term 0 - term 1 - ... in the order of `cholesky`, then its
// `* inv_d` (or the clamp and square root): one barrier per column, and a
// dependent chain of ~m steps instead of the left-looking ~m^2 / 2.
template <typename T>
__device__ void cta_cholesky_shared(T* X, T* C, int m, const Group& g) {
  if (g.tid < 32) {
    const T d = sqrt(clamp_pivot(X[0]));
    const T inv_d = T(1) / d;
    for (int i = 1 + g.tid; i < m; i += 32) {
      T* x = X + tri32(i);
      const T v = *x * inv_d;
      *x = v;
      C[i] = v;
    }
    __syncwarp();  // every lane has read X[0]
    if (g.tid == 0) {
      X[0] = d;
      C[0] = d;
    }
  }
  g.sync();
  for (int k = 0; k + 1 < m; ++k) {
    const T* c = C + (k & 1) * m;  // L[.][k]
    const int j1 = k + 1;
    if (g.tid < 32) {  // column k + 1: its last term, its pivot and its scaling
      T* next = C + (j1 & 1) * m;
      const T lk = c[j1];
      T* xd = X + tri32(j1) + j1;
      const T d = sqrt(clamp_pivot(*xd - lk * lk));
      const T inv_d = T(1) / d;
      for (int i = j1 + 1 + g.tid; i < m; i += 32) {
        T* x = X + tri32(i) + j1;
        const T v = (*x - c[i] * lk) * inv_d;
        *x = v;
        next[i] = v;
      }
      __syncwarp();  // every lane has read the pivot's entry
      if (g.tid == 0) {
        *xd = d;
        next[j1] = d;
      }
    }
    // term k of the trailing triangle, rows and columns k + 2 .. m - 1
    const int base = k + 2;
    const int cnt = base < m ? tri32(m - base) : 0;
    if (g.tid < cnt) {
      int r = packed_row(g.tid);
      int rs = tri32(r);
      for (int q = g.tid; q < cnt; q += g.size) {
        while (q >= rs + r + 1) {
          rs += r + 1;
          ++r;
        }
        const int i = base + r, j = base + (q - rs);
        T* x = X + tri32(i) + j;
        *x = *x - c[i] * c[j];
      }
    }
    g.sync();
  }
}

// Li = L^-1 into Y (both packed; L in X), row by row: before step k row k
// of Li is final; step k adds term k, L[i][k] Li[k][c], to every entry
// (i, c), i > k >= c, the term c starting its sum (no 0 +), and finishes
// row k + 1 (-acc / L[k+1][k+1], and 1 / L[k+1][k+1] on the diagonal).  So
// each entry's sum runs over k = c, c + 1, ... in the order of
// `inverse_factor`: one barrier per row.
template <typename T>
__device__ void cta_invert_lower_shared(const T* X, T* Y, int m, const Group& g) {
  if (g.tid == 0) Y[0] = T(1) / X[0];
  g.sync();
  for (int k = 0; k + 1 < m; ++k) {
    const int w = k + 1;          // the columns c = 0..k of rows k + 1 .. m - 1
    const int cnt = (m - w) * w;  // entries (i, c), flat, row-major
    const T* Yk = Y + tri32(k);
    const T dn = X[tri32(w) + w];  // L[k + 1][k + 1]
    if (g.tid == 0) Y[tri32(w) + w] = T(1) / dn;
    if (g.tid < cnt) {
      const int dr = g.size / w, dc = g.size - dr * w;
      int r = g.tid / w, c = g.tid - r * w;
      for (int q = g.tid; q < cnt; q += g.size) {
        const int row = tri32(w + r);
        const T t = X[row + k] * Yk[c];
        T* y = Y + row + c;
        T v = c == k ? t : *y + t;
        if (r == 0) v = -v / dn;
        *y = v;
        r += dr;
        c += dc;
        if (c >= w) {
          c -= w;
          ++r;
        }
      }
    }
    g.sync();
  }
}

// N consecutive elements from shared memory: 16-byte loads where the run's
// bytes allow (its start is then 16-byte aligned), else one by one
template <typename T, int N>
__device__ __forceinline__ void load_run(const T* p, T (&v)[N]) {
  constexpr int bytes = N * static_cast<int>(sizeof(T));
  if constexpr (bytes % 16 == 0) {
#pragma unroll
    for (int q = 0; q < bytes / 16; ++q) {
      const float4 w = reinterpret_cast<const float4*>(p)[q];
      memcpy(reinterpret_cast<char*>(v) + 16 * q, &w, 16);
    }
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = p[q];
  }
}

// The register-tile forms (M <= kMaxRegisterM): the same wavefronts, each
// thread keeping one kTile x kTile tile of the lower triangle in registers
// for the whole factorisation, so that a step reads one published column
// of L (or row of L^-1) per tile, as two 16-byte loads, and writes only the
// next column or row.  A tile wholly inside a step's region takes a path
// without per-entry tests, and the tiles are numbered so that those a
// wavefront works on at step k lie in few runs of threads (fewer warps with
// work).  The column and row buffers have a stride of M rounded up to 4, so
// each tile's run of 4 values is one aligned vector.
constexpr int kTile = 4;
constexpr int kMaxRegisterM = 176;  // 44 tile rows: 990 tiles, one for each of <= 1024 threads
constexpr int kCtaThreads = 1024;   // the CTA route's kernels' launch bound (64 registers a thread)

__host__ __device__ constexpr int padded4(int m) { return (m + 3) / 4 * 4; }

// this thread's tile: `valid`, and (i0, j0) its first entry
struct Tile {
  bool valid;
  int i0;
  int j0;
};

// the Cholesky's numbering: q = tid in the packed order of the reversed
// triangle (q -> (r, c), tile (nt - 1 - c, nt - 1 - r)), so the tiles of
// columns >= K, those it still works on at step 4K, are the first tri(nt - K)
__device__ __forceinline__ Tile tile_by_trailing(int m, const Group& g) {
  const int nt = (m + kTile - 1) / kTile;
  Tile t;
  t.valid = g.tid < nt * (nt + 1) / 2;
  const int r = t.valid ? packed_row(g.tid) : 0;
  t.i0 = (nt - 1 - (t.valid ? g.tid - tri32(r) : 0)) * kTile;
  t.j0 = (nt - 1 - r) * kTile;
  return t;
}

// the forward substitution's numbering: by tile columns from the left, each
// column from the bottom up, so that the tiles it works on at step k (rows
// below k, columns up to k + 1) lie in few runs
__device__ __forceinline__ Tile tile_by_columns(int m, const Group& g) {
  const int nt = (m + kTile - 1) / kTile;
  Tile t;
  t.valid = g.tid < nt * (nt + 1) / 2;
  int q = t.valid ? g.tid : 0;
  int tj = 0;
  while (q >= nt - tj) {  // column tj holds nt - tj tiles
    q -= nt - tj;
    ++tj;
  }
  t.i0 = (nt - 1 - q) * kTile;
  t.j0 = tj * kTile;
  return t;
}

// Right-looking Cholesky in place on X (packed), the entries in registers.
// C holds two column buffers (stride padded4(m)) and two pivot
// reciprocals.  Step k: each thread scales its entries of column k (final
// L, `* inv_d`), subtracts term k, L[i][k] L[j][k], from its entries with j
// > k (L[.][k] read from the published column and scaled there as its owner
// scales it, so the same bits), then publishes its entries of column k + 1
// unscaled; the owner of (k + 1, k + 1) takes the pivot (clamp, sqrt) and
// publishes 1 / d.  One barrier per column; each entry sees the terms in
// the order of `cholesky`.
template <typename T>
__device__ void cta_cholesky_tiles(T* X, T* C, int m, const Group& g) {
  const int mp = padded4(m);
  T* inv = C + 2 * mp;
  const Tile tl = tile_by_trailing(m, g);
  const int i0 = tl.i0, j0 = tl.j0;
  T acc[kTile][kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      const int i = i0 + r, j = j0 + c;
      acc[r][c] = tl.valid && i < m && j <= i ? X[tri32(i) + j] : T(0);
    }
  }
  if (tl.valid && j0 == 0) {  // column 0, unscaled, and pivot 0
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
      const int i = i0 + r;
      if (i == 0) {
        const T d = sqrt(clamp_pivot(acc[r][0]));
        inv[0] = T(1) / d;
        acc[r][0] = d;
      } else if (i < m) {
        C[i] = acc[r][0];
      }
    }
  }
  g.sync();
  for (int k = 0; k + 1 < m; ++k) {
    // work while the tile holds column k or a later one, below row k
    if (tl.valid && j0 + kTile - 1 >= k && i0 + kTile - 1 > k) {
      const T* ck = C + (k & 1) * mp;
      T* cn = C + ((k + 1) & 1) * mp;
      const T inv_k = inv[k & 1];
      T a[kTile], b[kTile];
      load_run(ck + i0, a);
      load_run(ck + j0, b);
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        a[r] = a[r] * inv_k;
        b[r] = b[r] * inv_k;
      }
      if (j0 > k) {  // every column trailing
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int c = 0; c < kTile; ++c) acc[r][c] = acc[r][c] - a[r] * b[c];
        }
      } else {  // the tile holds column k
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int c = 0; c < kTile; ++c) {
            if (j0 + c == k) {
              if (i0 + r > k) acc[r][c] = acc[r][c] * inv_k;  // L[i][k]
            } else if (j0 + c > k) {
              acc[r][c] = acc[r][c] - a[r] * b[c];
            }
          }
        }
      }
      if (j0 <= k + 1) {  // the tile holds column k + 1: publish it
#pragma unroll
        for (int c = 0; c < kTile; ++c) {
          if (j0 + c != k + 1) continue;
#pragma unroll
          for (int r = 0; r < kTile; ++r) {
            const int i = i0 + r;
            if (i == k + 1) {
              const T d = sqrt(clamp_pivot(acc[r][c]));
              inv[(k + 1) & 1] = T(1) / d;
              acc[r][c] = d;
            } else if (i > k + 1 && i < m) {
              cn[i] = acc[r][c];
            }
          }
        }
      }
    }
    g.sync();
  }
  if (tl.valid) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (i < m && j <= i) X[tri32(i) + j] = acc[r][c];
      }
    }
  }
  g.sync();
}

// Li = L^-1 (into Y, packed) by rows, the entries in registers: step k adds
// term k, L[i][k] Li[k][c], to each entry (i, c), i > k >= c (sums start at
// -0, and -0 + x = x, so the first term c starts each sum as in
// `inverse_factor`), and the owners of row k + 1 finish it (-acc /
// L[k+1][k+1], 1 / L[k+1][k+1] on the diagonal) and publish it to C (two
// row buffers, stride padded4(m)).  One barrier per row.
template <typename T>
__device__ void cta_invert_lower_tiles(const T* X, T* Y, T* C, int m, const Group& g) {
  const int mp = padded4(m);
  const Tile tl = tile_by_columns(m, g);
  const int i0 = tl.i0, j0 = tl.j0;
  T acc[kTile][kTile];
#pragma unroll
  for (int r = 0; r < kTile; ++r) {
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[r][c] = T(-0.0);
  }
  if (tl.valid && i0 == 0) {  // tile (0, 0): row 0
    acc[0][0] = T(1) / X[0];
    C[0] = acc[0][0];
  }
  g.sync();
  for (int k = 0; k + 1 < m; ++k) {
    // work while the tile holds rows below k and columns up to k + 1
    if (tl.valid && i0 + kTile - 1 > k && j0 <= k + 1) {
      const T* rk = C + (k & 1) * mp;  // row k of Li, columns 0..k
      T* rn = C + ((k + 1) & 1) * mp;
      T a[kTile], b[kTile];
#pragma unroll
      for (int r = 0; r < kTile; ++r) a[r] = X[tri32(min(i0 + r, m - 1)) + k];
      load_run(rk + j0, b);
      if (i0 > k + 1 && j0 + kTile - 1 <= k) {  // every entry takes term k, none finishes
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
#pragma unroll
          for (int c = 0; c < kTile; ++c) acc[r][c] = acc[r][c] + a[r] * b[c];
        }
      } else {
        const T dn = X[tri32(k + 1) + k + 1];  // L[k + 1][k + 1]
#pragma unroll
        for (int r = 0; r < kTile; ++r) {
          const int i = i0 + r;
#pragma unroll
          for (int c = 0; c < kTile; ++c) {
            const int j = j0 + c;
            if (i > k && j <= k) acc[r][c] = acc[r][c] + a[r] * b[c];
            if (i == k + 1 && j <= k + 1) {
              acc[r][c] = j <= k ? -acc[r][c] / dn : T(1) / dn;
              rn[j] = acc[r][c];
            }
          }
        }
      }
    }
    g.sync();
  }
  if (tl.valid) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) {
#pragma unroll
      for (int c = 0; c < kTile; ++c) {
        const int i = i0 + r, j = j0 + c;
        if (i < m && j <= i) Y[tri32(i) + j] = acc[r][c];
      }
    }
  }
  g.sync();
}

// the two forms by M: register tiles up to kMaxRegisterM (the group holds
// at least half a thread per tile), the shared-memory wavefront past it
template <typename T>
__device__ __forceinline__ void cta_cholesky(T* X, T* C, int m, const Group& g) {
  if (m <= kMaxRegisterM) {
    cta_cholesky_tiles(X, C, m, g);
  } else {
    cta_cholesky_shared(X, C, m, g);
  }
}

template <typename T>
__device__ __forceinline__ void cta_invert_lower(const T* X, T* Y, T* C, int m, const Group& g) {
  if (m <= kMaxRegisterM) {
    cta_invert_lower_tiles(X, Y, C, m, g);
  } else {
    cta_invert_lower_shared(X, Y, m, g);
  }
}

constexpr int kEntryTile = 4;  // S^-1 entries per thread: kEntryTile x kEntryTile

// f(i, j, v) for every entry v = S^-1[i][j], i >= j, of S^-1 = Li^T Li (Li
// packed in Y), spread over the group in kEntryTile x kEntryTile tiles of
// the triangle, each thread holding its tile's sums in registers: per k it
// reads kEntryTile values of row k for the tile's rows and as many for its
// columns.  Each entry's sum runs over k = i, i + 1, ... in the order of
// `inverse_entry`; it starts at -0, and -0 + x = x for every x, so the
// first term is the sum's start as in the plain version.
template <typename T, typename F>
__device__ void cta_inverse_entries(const T* Y, int m, const Group& g, F f) {
  constexpr int R = kEntryTile;
  const int nt = (m + R - 1) / R;
  const int tiles = nt * (nt + 1) / 2;
  for (int q = g.tid; q < tiles; q += g.size) {
    const int ti = packed_row(q), tj = q - tri32(ti);
    const int i0 = ti * R, j0 = tj * R;
    int ci[R];  // the tile's rows, those past m - 1 read row m - 1's column
#pragma unroll
    for (int r = 0; r < R; ++r) ci[r] = min(i0 + r, m - 1);
    T acc[R][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < R; ++c) acc[r][c] = T(-0.0);
    }
    int k = i0;
    // the first R values of k: entry (r, c) takes its terms from k = i0 + r
    for (const int end = min(i0 + R, m); k < end; ++k) {
      const T* Yk = Y + tri32(k);
      T a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = Yk[min(ci[r], k)];
#pragma unroll
      for (int c = 0; c < R; ++c) b[c] = Yk[min(j0 + c, k)];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (k >= i0 + r) {
#pragma unroll
          for (int c = 0; c < R; ++c) acc[r][c] = acc[r][c] + a[r] * b[c];
        }
      }
    }
    for (; k < m; ++k) {
      const T* Yk = Y + tri32(k);
      T a[R], b[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a[r] = Yk[ci[r]];
#pragma unroll
      for (int c = 0; c < R; ++c) b[c] = Yk[j0 + c];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = acc[r][c] + a[r] * b[c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < R; ++c) {
        if (i0 + r < m && j0 + c <= i0 + r) f(i0 + r, j0 + c, acc[r][c]);
      }
    }
  }
}

// Cholesky (X in place), L^-1 into Y, then the lower triangle of S^-1 into
// X: on entry X holds the SPD matrix's lower triangle, packed
template <typename T>
__device__ __forceinline__ void cta_inverse(T* X, T* Y, T* C, int m, const Group& g) {
  cta_cholesky(X, C, m, g);
  cta_invert_lower(X, Y, C, m, g);
  cta_inverse_entries(Y, m, g, [&](int i, int j, T v) { X[tri32(i) + j] = v; });
  g.sync();
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

// elements of one matrix's workspace: two columns (C), then X and Y (two
// packed triangles), a multiple of 128 bytes so each slice stays aligned
template <typename T>
__host__ __device__ constexpr int64_t cta_columns_elems(int m) {
  return (2 * static_cast<int64_t>(padded4(m)) + 2 + 31) / 32 * 32;
}

template <typename T>
int64_t cta_workspace_elems(int m) {
  return (cta_columns_elems<T>(m) + 2 * tri(m) + 31) / 32 * 32;
}

// the workspace of CTA blockIdx.x: shared memory, or its slice of `global`
template <typename T>
__device__ __forceinline__ T* cta_workspace(T* global, int64_t elems) {
  extern __shared__ __align__(16) unsigned char cta_smem[];
  return global == nullptr ? reinterpret_cast<T*>(cta_smem) : global + blockIdx.x * elems;
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
spd_inverse_cta_kernel(const T* __restrict__ s, T* __restrict__ out, int64_t n, int m,
                       T* workspace, int64_t ws_elems) {
  const Group grp{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), 0};
  T* C = cta_workspace(workspace, ws_elems);
  T* X = C + cta_columns_elems<T>(m);
  T* Y = X + tri(m);
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    const T* sb = s + b * mm;
    for_packed_entries(m, [&](int64_t e, int i, int j) { X[e] = sb[static_cast<int64_t>(i) * m + j]; });
    __syncthreads();
    cta_inverse(X, Y, C, m, grp);
    cta_store(out + b * mm, X, m, true);
    __syncthreads();  // the next matrix overwrites X
  }
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
spd_inverse_factor_cta_kernel(const T* __restrict__ s, T* __restrict__ inv,
                              T* __restrict__ chol, int64_t n, int m, T* workspace,
                              int64_t ws_elems) {
  const Group grp{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), 0};
  T* C = cta_workspace(workspace, ws_elems);
  T* X = C + cta_columns_elems<T>(m);
  T* Y = X + tri(m);
  const int64_t mm = static_cast<int64_t>(m) * m;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    const T* sb = s + b * mm;
    for_packed_entries(m, [&](int64_t e, int i, int j) { X[e] = sb[static_cast<int64_t>(i) * m + j]; });
    __syncthreads();
    cta_inverse(X, Y, C, m, grp);
    cta_store(inv + b * mm, X, m, true);
    __syncthreads();  // the store reads X before the factorisation overwrites it
    cta_cholesky(X, C, m, grp);  // U = chol(S^-1)
    cta_store(chol + b * mm, X, m, false);
    __syncthreads();
  }
}

// The trace product's CTA: `slots` blocks at once (consecutive blocks t0,
// t0 + 1, ... of the flat (outer, inner) index, so consecutive in `inner`
// within one o), each factored by its own group of blockDim.x / slots
// threads and its own slice of the workspace.  Staging reads entry e of the
// slots' blocks side by side (one 32-byte sector per entry for 8 float32
// blocks); where inner < slots each group reads its own block, e fastest.
// Block t0 + s's base: (o T) inner + c for (o, c) = divmod(t0 + s, inner).
template <typename T>
__device__ __forceinline__ void stage_blocks(const T* __restrict__ src, T* ws, int64_t slot_elems,
                                             int64_t x_off, int slots, int live, int64_t t0,
                                             int64_t inner, int m, int slot, const Group& g) {
  const int kT = tri32(m);
  int s, e, de;
  if (inner >= slots) {
    s = static_cast<int>(threadIdx.x) & (slots - 1);
    e = static_cast<int>(threadIdx.x) / slots;
    de = static_cast<int>(blockDim.x) / slots;
  } else {
    s = slot;
    e = g.tid;
    de = g.size;
  }
  if (s >= live) return;
  const int64_t t = t0 + s;
  const int64_t o = t / inner;
  const T* p = src + (o * kT) * inner + (t - o * inner);
  T* x = ws + s * slot_elems + x_off;
  for (; e < kT; e += de) x[e] = __ldg(p + static_cast<int64_t>(e) * inner);
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
spd_trace_product_cta_kernel(const T* __restrict__ s, const T* __restrict__ g,
                             T* __restrict__ out, int64_t outer, int64_t inner, int m,
                             int slots, T* workspace, int64_t ws_elems) {
  const int tps = static_cast<int>(blockDim.x) / slots;
  const int slot = static_cast<int>(threadIdx.x) / tps;
  const Group grp{static_cast<int>(threadIdx.x) - slot * tps, tps, slots == 1 ? 0 : 1 + slot};
  T* ws = cta_workspace(workspace, slots * ws_elems);
  const int64_t x_off = cta_columns_elems<T>(m);
  T* C = ws + slot * ws_elems;
  T* X = C + x_off;
  T* Y = X + tri(m);
  const int kT = tri32(m);
  const int64_t total = outer * inner;
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * slots; t0 < total;
       t0 += static_cast<int64_t>(gridDim.x) * slots) {
    const int live = total - t0 < slots ? static_cast<int>(total - t0) : slots;
    stage_blocks(s, ws, ws_elems, x_off, slots, live, t0, inner, m, slot, grp);
    __syncthreads();
    if (slot < live) {
      cta_cholesky(X, C, m, grp);
      cta_invert_lower(X, Y, C, m, grp);
    }
    __syncthreads();  // X (L) is spent in every slot: G's entries take its place
    stage_blocks(g, ws, ws_elems, x_off, slots, live, t0, inner, m, slot, grp);
    __syncthreads();
    if (slot < live) {  // the terms, in packed order, over G's entries
      cta_inverse_entries(Y, m, grp, [&](int i, int j, T v) {
        const int e = tri32(i) + j;
        T term = v * X[e];
        if (i != j) term = term + term;
        X[e] = term;
      });
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < live) {  // block t0 + threadIdx.x's sum, in packed order
      const T* terms = ws + threadIdx.x * ws_elems + x_off;
      T sum = terms[0];
      for (int e = 1; e < kT; ++e) sum = sum + terms[e];
      out[t0 + threadIdx.x] = sum;
    }
    __syncthreads();  // the next blocks overwrite every slot
  }
}

// edge_factor_gain's CTA route, part 1: per mission, U = chol(S^-1) of
// S = 0.5 (S_raw + S_raw^T) + diag(R[a]), written dense to u (rows of ldu
// elements, zeros above the diagonal and in the padding)
template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
edge_factor_cta_kernel(const T* __restrict__ s_raw, const T* __restrict__ r_table,
                       const int64_t* __restrict__ action, T* __restrict__ u, int ldu,
                       int64_t n_missions, int m, T* workspace, int64_t ws_elems) {
  const Group grp{static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x), 0};
  T* C = cta_workspace(workspace, ws_elems);
  T* X = C + cta_columns_elems<T>(m);  // S, L, S^-1, then U
  T* Y = X + tri(m);                   // L^-1
  const int64_t mm = static_cast<int64_t>(m) * m;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  for (int64_t b = blockIdx.x; b < n_missions; b += gridDim.x) {
    const T* S = s_raw + b * mm;
    const T* R = r_table + __ldg(reinterpret_cast<const long long*>(action) + b) * m;
    // the lower triangle of S = 0.5 (S_raw + S_raw^T) + diag(R)
    for_packed_entries(m, [&](int64_t e, int i, int j) {
      X[e] = T(0.5) * (S[static_cast<int64_t>(i) * m + j] + S[static_cast<int64_t>(j) * m + i]) +
             (i == j ? R[i] : T(0));
    });
    __syncthreads();
    cta_inverse(X, Y, C, m, grp);
    cta_cholesky(X, C, m, grp);  // U = chol(S^-1)
    T* ub = u + b * m * static_cast<int64_t>(ldu);
    for (int k = static_cast<int>(threadIdx.x) >> 5; k < m; k += static_cast<int>(blockDim.x) >> 5) {
      const T* row = X + tri32(k);
      for (int col = lane; col < ldu; col += 32) ub[static_cast<int64_t>(k) * ldu + col] = col <= k ? row[col] : T(0);
    }
    __syncthreads();  // the next mission overwrites X
  }
}

// Part 2, WcT = U^T A.  A CTA of kProdThreads (16 x 16) threads owns a
// column tile of kProdCols columns of one mission's A and every row of WcT
// (in passes of 16 TM rows); each thread keeps a TM x 4 register tile.  Per
// k-chunk of kProdK rows, U's rows (a contiguous run of 16 TM elements) and
// A's rows (kProdCols columns) are copied into shared memory with cp.async,
// double-buffered, the next chunk in flight while this one is multiplied.
// Every output is summed over k = 0..m-1 in ascending order from -0, one
// product and one add at a time, U's zeros above its diagonal kept: the
// _small_mm order.  Then the bf16 round trip, WcT's rows stored coalesced
// along N, the tile staged once more in shared memory so that thread c adds
// its column's squares over the rows in order, and the mask: the masked
// squares go to sq (n_missions, n).
constexpr int kProdThreads = 256;
constexpr int kProdCols = 64;
constexpr int kProdK = 16;

template <typename T, int TM>
struct ProdShape {
  static constexpr int rows = 16 * TM;                         // rows of WcT per pass
  static constexpr int stage = kProdK * (rows + kProdCols);    // elements of one stage
  static constexpr int elems = 2 * stage > rows * kProdCols ? 2 * stage : rows * kProdCols;
};

template <typename T, int TM>
__global__ void __launch_bounds__(kProdThreads)
edge_product_kernel(const T* __restrict__ u, int ldu, const T* __restrict__ a_blk,
                    const T* __restrict__ mask, int64_t mask_stride, T* __restrict__ wct,
                    T* __restrict__ sq_out, int64_t n_missions, int n, int m, int round_bf16) {
  using Shape = ProdShape<T, TM>;
  constexpr int kRows = Shape::rows;
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char prod_smem[];
  T* sm = reinterpret_cast<T*>(prod_smem);
  const int tx = static_cast<int>(threadIdx.x) & 15, ty = static_cast<int>(threadIdx.x) >> 4;
  const int n0 = static_cast<int>(blockIdx.x) * kProdCols;
  const bool vec_a = (reinterpret_cast<uintptr_t>(a_blk) & 15) == 0 &&
                     (static_cast<int64_t>(n) * sizeof(T)) % 16 == 0;
  for (int64_t b = blockIdx.y; b < n_missions; b += gridDim.y) {
    const T* ub = u + b * m * static_cast<int64_t>(ldu);
    const T* ab = a_blk + b * m * static_cast<int64_t>(n);
    T* ob = wct + b * m * static_cast<int64_t>(n);
    T sq = T(-0.0);  // column n0 + threadIdx.x's sum of squares (threads < kProdCols)
    for (int r0 = 0; r0 < m; r0 += kRows) {
      // rows kc .. kc + kProdK - 1 (those below m) of U (columns r0 ..) and A
      // (columns n0 ..) into stage buf, as one cp.async group
      auto stage = [&](int kc, int buf) {
        T* us = sm + buf * Shape::stage;
        T* as = us + kProdK * kRows;
        const int kr = m - kc < kProdK ? m - kc : kProdK;
        for (int v = threadIdx.x; v < kr * (kRows / kVec); v += kProdThreads) {
          const int kk = v / (kRows / kVec), c = (v % (kRows / kVec)) * kVec;
          cp_async_16(us + kk * kRows + c, ub + static_cast<int64_t>(kc + kk) * ldu + r0 + c);
        }
        if (vec_a) {
          for (int v = threadIdx.x; v < kr * (kProdCols / kVec); v += kProdThreads) {
            const int kk = v / (kProdCols / kVec), c = (v % (kProdCols / kVec)) * kVec;
            if (n0 + c < n) {
              cp_async_16(as + kk * kProdCols + c, ab + static_cast<int64_t>(kc + kk) * n + n0 + c);
            }
          }
        } else {
          for (int v = threadIdx.x; v < kr * kProdCols; v += kProdThreads) {
            const int kk = v / kProdCols, c = v % kProdCols;
            if (n0 + c < n) {
              cp_async_small<sizeof(T)>(as + kk * kProdCols + c,
                                        ab + static_cast<int64_t>(kc + kk) * n + n0 + c);
            }
          }
        }
        cp_async_commit();
      };

      T acc[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = T(-0.0);
      }
      stage(0, 0);
      int buf = 0;
      for (int kc = 0; kc < m; kc += kProdK, buf ^= 1) {
        if (kc + kProdK < m) {
          stage(kc + kProdK, buf ^ 1);
          cp_async_wait<1>();  // this chunk has landed; the next may be in flight
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        const T* us = sm + buf * Shape::stage;
        const T* as = us + kProdK * kRows;
        const int kr = m - kc < kProdK ? m - kc : kProdK;
#pragma unroll
        for (int kk = 0; kk < kProdK; ++kk) {
          if (kk < kr) {
            T uv[TM], av[4];
            load_run(us + kk * kRows + ty * TM, uv);
            load_run(as + kk * kProdCols + tx * 4, av);
#pragma unroll
            for (int i = 0; i < TM; ++i) {
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + uv[i] * av[j];
            }
          }
        }
        __syncthreads();  // every thread is done with buf before a stage refills it
      }

      // the bf16 round trip and the stores of rows r0 + ty TM + i
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = r0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (round_bf16) acc[i][j] = round_to_bf16(acc[i][j]);
          const int col = n0 + tx * 4 + j;
          if (row < m && col < n) ob[static_cast<int64_t>(row) * n + col] = acc[i][j];
        }
      }
      T* tile = sm;  // (kRows, kProdCols): the stages are spent
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) tile[(ty * TM + i) * kProdCols + tx * 4 + j] = acc[i][j];
      }
      __syncthreads();
      if (threadIdx.x < kProdCols) {
        const int rend = m - r0 < kRows ? m - r0 : kRows;
        for (int r = 0; r < rend; ++r) {
          const T v = tile[r * kProdCols + threadIdx.x];
          sq = sq + v * v;
        }
      }
      __syncthreads();  // the next pass's stages overwrite the tile
    }
    const int col = n0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < kProdCols && col < n) {
      if (mask != nullptr) sq = sq * __ldg(mask + b * mask_stride + col);
      sq_out[b * n + col] = sq;
    }
  }
}

// Part 3, the gain: one warp per mission walks its masked squares in the
// warp route's order (lane l adds columns l, l + 32, ... in turn, zero past
// n), then the xor tree, so the gain is the warp route's bit for bit.
constexpr int kGainWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kGainWarps * 32)
edge_gain_kernel(const T* __restrict__ sq, T* __restrict__ gain, int64_t n_missions, int n) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kGainWarps + (threadIdx.x >> 5);
  if (b >= n_missions) return;  // whole warps only
  const T* row = sq + b * n;
  T g = T(0);
  for (int c = 0, col = lane; col - lane < n; ++c, col += 32) {
    const T v = col < n ? row[col] : T(0);
    g = c == 0 ? v : g + v;
  }
#pragma unroll
  for (int w = 16; w >= 1; w >>= 1) g = g + __shfl_xor_sync(kFullMask, g, w);
  if (lane == 0) gain[b] = g;
}

// the CTA route's workspace limit in shared memory (bytes per CTA); past it
// the workspace is global memory.  Tests lower it to drive the global path.
int g_cta_shared_limit = kMaxSharedBytes;
constexpr int kWorkspaceCtas = 264;  // CTAs of a launch whose workspace is global memory
constexpr int kTraceSlots = 2;       // blocks per CTA of the trace product, at most

// threads that factor one matrix (a whole number of warps, at most
// kCtaThreads): one per register tile up to kMaxRegisterM, else one per row
inline int cta_threads(int m) {
  const int nt = (m + kTile - 1) / kTile;
  const int need = m <= kMaxRegisterM ? nt * (nt + 1) / 2 : m;
  const int t = (need + 31) / 32 * 32;
  return t < kCtaThreads ? t : kCtaThreads;
}

// Where the CTA route keeps a launch's workspace: `slots` matrices per CTA
// (a power of two; more than one only in shared memory), `shared_bytes` > 0
// for shared memory, else `global_bytes` of global memory for `ctas` CTAs.
struct CtaPlan {
  int64_t ws_elems;  // one matrix's
  int slots;
  unsigned ctas;
  unsigned threads;
  size_t shared_bytes;
  int64_t global_bytes;
};

template <typename T>
CtaPlan cta_plan(int m, int64_t count, int max_slots) {
  CtaPlan p;
  p.ws_elems = cta_workspace_elems<T>(m);
  const int64_t bytes = p.ws_elems * static_cast<int64_t>(sizeof(T));
  const bool shared = bytes <= g_cta_shared_limit;
  p.slots = 1;
  while (shared && p.slots < max_slots && p.slots < count &&
         2 * p.slots * bytes <= g_cta_shared_limit && 2 * p.slots * cta_threads(m) <= kCtaThreads) {
    p.slots *= 2;
  }
  p.threads = static_cast<unsigned>(p.slots * cta_threads(m));
  const int64_t groups = (count + p.slots - 1) / p.slots;
  const int64_t cap = shared ? 0x7fffffff : kWorkspaceCtas;
  p.ctas = static_cast<unsigned>(groups < cap ? groups : cap);
  p.shared_bytes = shared ? static_cast<size_t>(p.slots * bytes) : 0;
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
  const CtaPlan p = cta_plan<T>(m, n, 1);
  auto kernel = spd_inverse_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, p.threads, p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n, m, plan_workspace<T>(p, workspace),
      p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_inverse_factor_cta(const void* s, void* inv, void* chol, int64_t n, int m,
                              void* workspace, cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, n, 1);
  auto kernel = spd_inverse_factor_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, p.threads, p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(inv), static_cast<T*>(chol), n, m,
      plan_workspace<T>(p, workspace), p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_trace_cta(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                     int m, void* workspace, cudaStream_t stream) {
  const CtaPlan p = cta_plan<T>(m, outer * inner, kTraceSlots);
  auto kernel = spd_trace_product_cta_kernel<T>;
  if (int err = check_workspace(p, workspace)) return err;
  if (int err = allow_shared(kernel, p.shared_bytes)) return err;
  kernel<<<p.ctas, p.threads, p.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner, m,
      p.slots, plan_workspace<T>(p, workspace), p.ws_elems);
  return static_cast<int>(cudaGetLastError());
}

// edge_factor_gain's CTA route needs, besides the factor's plan, U for
// every mission (rows of ldu elements, padded to the product's pass of
// 16 TM rows) and the masked squares (n_missions, n), both in the caller's
// global workspace: U, then the squares, then the factor's global
// workspace where it has one, each at a multiple of 256 bytes.
inline int prod_tm(int m) { return m <= 32 ? 2 : 8; }

struct EdgePlan {
  CtaPlan factor;
  int tm;
  int ldu;
  int64_t u_bytes;
  int64_t sq_bytes;
  int64_t bytes;  // of global workspace in all
};

inline int64_t round256(int64_t bytes) { return (bytes + 255) / 256 * 256; }

template <typename T>
EdgePlan edge_plan(int m, int n, int64_t n_missions) {
  EdgePlan p;
  p.factor = cta_plan<T>(m, n_missions, 1);
  p.tm = prod_tm(m);
  const int rows = 16 * p.tm;
  p.ldu = (m + rows - 1) / rows * rows;
  p.u_bytes = round256(n_missions * m * static_cast<int64_t>(p.ldu) * sizeof(T));
  p.sq_bytes = round256(n_missions * static_cast<int64_t>(n) * sizeof(T));
  p.bytes = p.u_bytes + p.sq_bytes + p.factor.global_bytes;
  return p;
}

template <typename T, int TM>
int launch_edge_product(const T* u, int ldu, const void* a_blk, const void* mask,
                        int64_t mask_stride, void* wct, T* sq, int64_t n_missions, int n, int m,
                        int round_bf16, cudaStream_t stream) {
  auto kernel = edge_product_kernel<T, TM>;
  const size_t bytes = ProdShape<T, TM>::elems * sizeof(T);
  if (int err = allow_shared(kernel, bytes)) return err;
  const dim3 grid(static_cast<unsigned>((n + kProdCols - 1) / kProdCols),
                  static_cast<unsigned>(n_missions < 65535 ? n_missions : 65535));
  kernel<<<grid, kProdThreads, bytes, stream>>>(
      u, ldu, static_cast<const T*>(a_blk), static_cast<const T*>(mask), mask_stride,
      static_cast<T*>(wct), sq, n_missions, n, m, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_edge_cta(const void* s, const void* a_blk, const void* r, const void* action,
                    const void* mask, int64_t mask_stride, void* wct, void* gain,
                    int64_t n_missions, int n, int m, int round_bf16, void* workspace,
                    cudaStream_t stream) {
  const EdgePlan p = edge_plan<T>(m, n, n_missions);
  if (workspace == nullptr) return -2;
  char* ws = static_cast<char*>(workspace);
  T* u = reinterpret_cast<T*>(ws);
  T* sq = reinterpret_cast<T*>(ws + p.u_bytes);
  void* factor_ws = p.factor.global_bytes > 0 ? ws + p.u_bytes + p.sq_bytes : nullptr;
  auto factor = edge_factor_cta_kernel<T>;
  if (int err = allow_shared(factor, p.factor.shared_bytes)) return err;
  factor<<<p.factor.ctas, p.factor.threads, p.factor.shared_bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(r), static_cast<const int64_t*>(action), u,
      p.ldu, n_missions, m, plan_workspace<T>(p.factor, factor_ws), p.factor.ws_elems);
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  int err;
  switch (p.tm) {
    case 2: err = launch_edge_product<T, 2>(u, p.ldu, a_blk, mask, mask_stride, wct, sq, n_missions, n, m, round_bf16, stream); break;
    default: err = launch_edge_product<T, 8>(u, p.ldu, a_blk, mask, mask_stride, wct, sq, n_missions, n, m, round_bf16, stream); break;
  }
  if (err) return err;
  edge_gain_kernel<T><<<static_cast<unsigned>((n_missions + kGainWarps - 1) / kGainWarps),
                        kGainWarps * 32, 0, stream>>>(sq, static_cast<T*>(gain), n_missions, n);
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

}  // namespace

// The kernels unrolled for each M (the register route's and the warp
// route's), compiled in one source, would take minutes: the compiler works
// through one source's kernels one after another.  So ops/kernels.py
// compiles this source in parts, all at once: SMALLCHOL_PART = 0 holds
// every other kernel and the C interface and takes these launchers from
// the other parts, part p >= 1 instantiates some of them for its range of M
// (below).  Compiled without SMALLCHOL_PART, the source holds everything.
namespace smallchol_unrolled {

// the register route (M = 1..kMaxUnrolledM)
template <int M, typename T>
int launch_inverse(const void* s, void* out, int64_t n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kInverseTile - 1) / kInverseTile);
  spd_inverse_kernel<M, T><<<blocks, kInverseTile, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename T>
int launch_inverse_factor(const void* s, void* inv, void* chol, int64_t n,
                          cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + kInverseTile - 1) / kInverseTile);
  spd_inverse_factor_kernel<M, T><<<blocks, kInverseTile, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(inv), static_cast<T*>(chol), n);
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename T>
int launch_trace(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                 cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((outer * inner + kTraceThreads - 1) / kTraceThreads);
  spd_trace_product_kernel<M, T><<<blocks, kTraceThreads, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner);
  return static_cast<int>(cudaGetLastError());
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

// the warp route (M = 13..32)
template <int M, typename T>
int launch_inverse_rows(const void* s, void* out, int64_t n, cudaStream_t stream) {
  spd_inverse_rows_kernel<M, T><<<static_cast<unsigned>(n), 32, 0, stream>>>(
      static_cast<const T*>(s), static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename T>
int launch_inverse_factor_rows(const void* s, void* inv, void* chol, int64_t n,
                               cudaStream_t stream) {
  factor_rows_kernel<M, T><<<static_cast<unsigned>(n), 32, 0, stream>>>(
      static_cast<const T*>(s), nullptr, nullptr, static_cast<T*>(inv), static_cast<T*>(chol),
      nullptr);
  return static_cast<int>(cudaGetLastError());
}

// edge_factor_gain's warp route with the unrolled kernels: U^T into the
// caller's workspace `ut` (n_missions x M x kWarpLdu), then WcT and the gain
template <int M, typename T>
int launch_edge_rows(const void* s, const void* a_blk, const void* r, const void* action,
                     const void* mask, int64_t mask_stride, void* wct, void* gain,
                     int64_t n_missions, int n, int round_bf16, void* ut, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(n_missions);
  factor_rows_kernel<M, T><<<blocks, 32, 0, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(r), static_cast<const int64_t*>(action),
      nullptr, nullptr, static_cast<T*>(ut));
  if (int err = static_cast<int>(cudaGetLastError())) return err;
  edge_columns_kernel<M, T><<<blocks, kColumnsThreads, 0, stream>>>(
      static_cast<const T*>(ut), static_cast<const T*>(a_blk), static_cast<const T*>(mask),
      mask_stride, static_cast<T*>(wct), static_cast<T*>(gain), n, round_bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int M, typename T>
int launch_trace_lanes(const void* s, const void* g, void* out, int64_t outer, int64_t inner,
                       cudaStream_t stream) {
  const size_t bytes = static_cast<size_t>(M * (M + 1) / 2) * 32 * sizeof(T);
  auto kernel = spd_trace_product_lanes_kernel<M, T>;
  if (int err = allow_shared(kernel, bytes)) return err;
  kernel<<<static_cast<unsigned>((outer * inner + 31) / 32), 32, bytes, stream>>>(
      static_cast<const T*>(s), static_cast<const T*>(g), static_cast<T*>(out), outer, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace smallchol_unrolled

// the launchers of K1's and K2's unrolled kernels for one M, and those of
// K3's and edge_factor_gain's
#define SMALLCHOL_UNROLLED_PAIR(KEYWORD, M)                                                   \
  KEYWORD int smallchol_unrolled::launch_inverse_rows<M, float>(const void*, void*, int64_t,  \
                                                                cudaStream_t);                \
  KEYWORD int smallchol_unrolled::launch_inverse_rows<M, double>(const void*, void*, int64_t, \
                                                                 cudaStream_t);               \
  KEYWORD int smallchol_unrolled::launch_trace_lanes<M, float>(                               \
      const void*, const void*, void*, int64_t, int64_t, cudaStream_t);                       \
  KEYWORD int smallchol_unrolled::launch_trace_lanes<M, double>(                              \
      const void*, const void*, void*, int64_t, int64_t, cudaStream_t);
#define SMALLCHOL_UNROLLED_FACTOR(KEYWORD, M)                                                 \
  KEYWORD int smallchol_unrolled::launch_inverse_factor_rows<M, float>(                       \
      const void*, void*, void*, int64_t, cudaStream_t);                                      \
  KEYWORD int smallchol_unrolled::launch_inverse_factor_rows<M, double>(                      \
      const void*, void*, void*, int64_t, cudaStream_t);                                      \
  KEYWORD int smallchol_unrolled::launch_edge_rows<M, float>(                                 \
      const void*, const void*, const void*, const void*, const void*, int64_t, void*, void*, \
      int64_t, int, int, void*, cudaStream_t);                                                \
  KEYWORD int smallchol_unrolled::launch_edge_rows<M, double>(                                \
      const void*, const void*, const void*, const void*, const void*, int64_t, void*, void*, \
      int64_t, int, int, void*, cudaStream_t);
#define SMALLCHOL_UNROLLED(KEYWORD, M) \
  SMALLCHOL_UNROLLED_PAIR(KEYWORD, M) SMALLCHOL_UNROLLED_FACTOR(KEYWORD, M)
// the launchers of the register route's four kernels for one M
#define SMALLCHOL_REGISTER(KEYWORD, M)                                                        \
  KEYWORD int smallchol_unrolled::launch_inverse<M, float>(const void*, void*, int64_t,       \
                                                           cudaStream_t);                     \
  KEYWORD int smallchol_unrolled::launch_inverse<M, double>(const void*, void*, int64_t,      \
                                                            cudaStream_t);                    \
  KEYWORD int smallchol_unrolled::launch_inverse_factor<M, float>(const void*, void*, void*,  \
                                                                  int64_t, cudaStream_t);     \
  KEYWORD int smallchol_unrolled::launch_inverse_factor<M, double>(const void*, void*, void*, \
                                                                   int64_t, cudaStream_t);    \
  KEYWORD int smallchol_unrolled::launch_trace<M, float>(const void*, const void*, void*,     \
                                                         int64_t, int64_t, cudaStream_t);     \
  KEYWORD int smallchol_unrolled::launch_trace<M, double>(const void*, const void*, void*,    \
                                                          int64_t, int64_t, cudaStream_t);    \
  KEYWORD int smallchol_unrolled::launch_edge<M, float>(                                      \
      const void*, const void*, const void*, const void*, const void*, int64_t, void*, void*, \
      int64_t, int, int, cudaStream_t);                                                       \
  KEYWORD int smallchol_unrolled::launch_edge<M, double>(                                     \
      const void*, const void*, const void*, const void*, const void*, int64_t, void*, void*, \
      int64_t, int, int, cudaStream_t);

// Part p = 1..6 instantiates K1's and K2's launchers for its range of M,
// part p + 6 K3's and the edge update's for the same range; the ranges are
// about equal in compile time (the code grows with M).  Parts 13 and 14
// hold the register route's (M = 1..10, 11..12: its code grows as M^3).
// Part 0 declares them all.
#if !defined(SMALLCHOL_PART)
#define SMALLCHOL_PART_HAS(P) 1
#else
#define SMALLCHOL_PART_HAS(P) (SMALLCHOL_PART == (P))
#endif
#if SMALLCHOL_PART_HAS(1)
SMALLCHOL_UNROLLED_PAIR(template, 13) SMALLCHOL_UNROLLED_PAIR(template, 14)
SMALLCHOL_UNROLLED_PAIR(template, 15) SMALLCHOL_UNROLLED_PAIR(template, 16)
SMALLCHOL_UNROLLED_PAIR(template, 17)
#endif
#if SMALLCHOL_PART_HAS(2)
SMALLCHOL_UNROLLED_PAIR(template, 18) SMALLCHOL_UNROLLED_PAIR(template, 19)
SMALLCHOL_UNROLLED_PAIR(template, 20) SMALLCHOL_UNROLLED_PAIR(template, 21)
#endif
#if SMALLCHOL_PART_HAS(3)
SMALLCHOL_UNROLLED_PAIR(template, 22) SMALLCHOL_UNROLLED_PAIR(template, 23)
SMALLCHOL_UNROLLED_PAIR(template, 24)
#endif
#if SMALLCHOL_PART_HAS(4)
SMALLCHOL_UNROLLED_PAIR(template, 25) SMALLCHOL_UNROLLED_PAIR(template, 26)
SMALLCHOL_UNROLLED_PAIR(template, 27)
#endif
#if SMALLCHOL_PART_HAS(5)
SMALLCHOL_UNROLLED_PAIR(template, 28) SMALLCHOL_UNROLLED_PAIR(template, 29)
SMALLCHOL_UNROLLED_PAIR(template, 30)
#endif
#if SMALLCHOL_PART_HAS(6)
SMALLCHOL_UNROLLED_PAIR(template, 31) SMALLCHOL_UNROLLED_PAIR(template, 32)
#endif
#if SMALLCHOL_PART_HAS(7)
SMALLCHOL_UNROLLED_FACTOR(template, 13) SMALLCHOL_UNROLLED_FACTOR(template, 14)
SMALLCHOL_UNROLLED_FACTOR(template, 15) SMALLCHOL_UNROLLED_FACTOR(template, 16)
SMALLCHOL_UNROLLED_FACTOR(template, 17)
#endif
#if SMALLCHOL_PART_HAS(8)
SMALLCHOL_UNROLLED_FACTOR(template, 18) SMALLCHOL_UNROLLED_FACTOR(template, 19)
SMALLCHOL_UNROLLED_FACTOR(template, 20) SMALLCHOL_UNROLLED_FACTOR(template, 21)
#endif
#if SMALLCHOL_PART_HAS(9)
SMALLCHOL_UNROLLED_FACTOR(template, 22) SMALLCHOL_UNROLLED_FACTOR(template, 23)
SMALLCHOL_UNROLLED_FACTOR(template, 24)
#endif
#if SMALLCHOL_PART_HAS(10)
SMALLCHOL_UNROLLED_FACTOR(template, 25) SMALLCHOL_UNROLLED_FACTOR(template, 26)
SMALLCHOL_UNROLLED_FACTOR(template, 27)
#endif
#if SMALLCHOL_PART_HAS(11)
SMALLCHOL_UNROLLED_FACTOR(template, 28) SMALLCHOL_UNROLLED_FACTOR(template, 29)
SMALLCHOL_UNROLLED_FACTOR(template, 30)
#endif
#if SMALLCHOL_PART_HAS(12)
SMALLCHOL_UNROLLED_FACTOR(template, 31) SMALLCHOL_UNROLLED_FACTOR(template, 32)
#endif
#if SMALLCHOL_PART_HAS(13)
SMALLCHOL_REGISTER(template, 1) SMALLCHOL_REGISTER(template, 2) SMALLCHOL_REGISTER(template, 3)
SMALLCHOL_REGISTER(template, 4) SMALLCHOL_REGISTER(template, 5) SMALLCHOL_REGISTER(template, 6)
SMALLCHOL_REGISTER(template, 7) SMALLCHOL_REGISTER(template, 8) SMALLCHOL_REGISTER(template, 9)
SMALLCHOL_REGISTER(template, 10)
#endif
#if SMALLCHOL_PART_HAS(14)
SMALLCHOL_REGISTER(template, 11) SMALLCHOL_REGISTER(template, 12)
#endif

#if !defined(SMALLCHOL_PART) || SMALLCHOL_PART == 0
#if defined(SMALLCHOL_PART)
SMALLCHOL_UNROLLED(extern template, 13) SMALLCHOL_UNROLLED(extern template, 14)
SMALLCHOL_UNROLLED(extern template, 15) SMALLCHOL_UNROLLED(extern template, 16)
SMALLCHOL_UNROLLED(extern template, 17) SMALLCHOL_UNROLLED(extern template, 18)
SMALLCHOL_UNROLLED(extern template, 19) SMALLCHOL_UNROLLED(extern template, 20)
SMALLCHOL_UNROLLED(extern template, 21) SMALLCHOL_UNROLLED(extern template, 22)
SMALLCHOL_UNROLLED(extern template, 23) SMALLCHOL_UNROLLED(extern template, 24)
SMALLCHOL_UNROLLED(extern template, 25) SMALLCHOL_UNROLLED(extern template, 26)
SMALLCHOL_UNROLLED(extern template, 27) SMALLCHOL_UNROLLED(extern template, 28)
SMALLCHOL_UNROLLED(extern template, 29) SMALLCHOL_UNROLLED(extern template, 30)
SMALLCHOL_UNROLLED(extern template, 31) SMALLCHOL_UNROLLED(extern template, 32)
SMALLCHOL_REGISTER(extern template, 1) SMALLCHOL_REGISTER(extern template, 2)
SMALLCHOL_REGISTER(extern template, 3) SMALLCHOL_REGISTER(extern template, 4)
SMALLCHOL_REGISTER(extern template, 5) SMALLCHOL_REGISTER(extern template, 6)
SMALLCHOL_REGISTER(extern template, 7) SMALLCHOL_REGISTER(extern template, 8)
SMALLCHOL_REGISTER(extern template, 9) SMALLCHOL_REGISTER(extern template, 10)
SMALLCHOL_REGISTER(extern template, 11) SMALLCHOL_REGISTER(extern template, 12)
#endif

namespace {

// Which kernels take spd_inverse's and spd_trace_product's launches at the
// warp route's M (13..32): by default the unrolled kernels
// (spd_inverse_rows_kernel, spd_trace_product_lanes_kernel) where the H100
// ran them faster than the runtime-M kernels (spd_inverse_large_kernel,
// spd_trace_product_large_kernel), the runtime-M kernels elsewhere
// (kUnrolledMaxM); kWarpRouteRuntimeM and kWarpRouteUnrolled force one kind
// at every M, so that the tests hold both against the plain versions and
// the chip check times one against the other.  spd_inverse_factor and
// edge_factor_gain have the unrolled kind only (factor_rows_kernel, and
// edge_columns_kernel after it).
enum { kWarpRouteDefault = 0, kWarpRouteRuntimeM = 1, kWarpRouteUnrolled = 2 };
int g_warp_route = kWarpRouteDefault;

// the `kind` codes of smallchol_workspace_bytes
enum { kInverseKernel = 0, kInverseFactorKernel = 1, kTraceKernel = 2, kEdgeKernel = 3 };

// the largest M at which the default takes the unrolled kernel, for
// spd_inverse and spd_trace_product (rows) and float32, float64 (columns).
// Timed on an H100 by scripts/time_torch_warp_route.py, every M = 13..32:
// the unrolled K1 ran faster everywhere, the lane K2 everywhere but at
// M = 32 in float64, where a lane's triangle (135 KB a warp) leaves one
// warp per SM.
constexpr int kUnrolledMaxM[2][2] = {{kMaxWarpM, kMaxWarpM}, {kMaxWarpM, kMaxWarpM - 1}};

// kernel: kInverseKernel or kTraceKernel
template <typename T>
bool takes_unrolled(int kernel, int m) {
  if (g_warp_route != kWarpRouteDefault) return g_warp_route == kWarpRouteUnrolled;
  return m <= kUnrolledMaxM[kernel == kTraceKernel ? 1 : 0][sizeof(T) == 8 ? 1 : 0];
}

// calls f.template run<M, T>() for the warp route's M = 13..32
template <typename T, typename F>
int dispatch_warp_m(int m, F f) {
  switch (m) {
    case 13: return f.template run<13, T>();
    case 14: return f.template run<14, T>();
    case 15: return f.template run<15, T>();
    case 16: return f.template run<16, T>();
    case 17: return f.template run<17, T>();
    case 18: return f.template run<18, T>();
    case 19: return f.template run<19, T>();
    case 20: return f.template run<20, T>();
    case 21: return f.template run<21, T>();
    case 22: return f.template run<22, T>();
    case 23: return f.template run<23, T>();
    case 24: return f.template run<24, T>();
    case 25: return f.template run<25, T>();
    case 26: return f.template run<26, T>();
    case 27: return f.template run<27, T>();
    case 28: return f.template run<28, T>();
    case 29: return f.template run<29, T>();
    case 30: return f.template run<30, T>();
    case 31: return f.template run<31, T>();
    case 32: return f.template run<32, T>();
    default: return -1;
  }
}

struct InverseRows {
  const void* s; void* out; int64_t n; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_inverse_rows<M, T>(s, out, n, stream);
  }
};

struct InverseFactorRows {
  const void* s; void* inv; void* chol; int64_t n; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_inverse_factor_rows<M, T>(s, inv, chol, n, stream);
  }
};

struct EdgeRows {
  const void* s; const void* a_blk; const void* r; const void* action; const void* mask;
  int64_t mask_stride; void* wct; void* gain; int64_t n_missions; int n; int round_bf16;
  void* ut; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_edge_rows<M, T>(s, a_blk, r, action, mask, mask_stride,
                                                      wct, gain, n_missions, n, round_bf16, ut,
                                                      stream);
  }
};

struct TraceLanes {
  const void* s; const void* g; void* out; int64_t outer; int64_t inner; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_trace_lanes<M, T>(s, g, out, outer, inner, stream);
  }
};

// bytes of edge_factor_gain's global workspace on the warp route: U^T of
// every mission, rows of kWarpLdu elements
template <typename T>
int64_t edge_rows_bytes(int m, int64_t n_missions) {
  return round256(n_missions * m * static_cast<int64_t>(kWarpLdu) * sizeof(T));
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
      if (m > kMaxWarpM && m <= kMaxCtaM) return f.template run_cta<T>(m);
      return -1;
  }
}

struct InverseLaunch {
  const void* s; void* out; int64_t n; void* workspace; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_inverse<M, T>(s, out, n, stream);
  }
  template <typename T> int run_large(int m) const {
    if (takes_unrolled<T>(kInverseKernel, m)) {
      return dispatch_warp_m<T>(m, InverseRows{s, out, n, stream});
    }
    return launch_inverse_large<T>(s, out, n, m, stream);
  }
  template <typename T> int run_cta(int m) const {
    return launch_inverse_cta<T>(s, out, n, m, workspace, stream);
  }
};

struct InverseFactorLaunch {
  const void* s; void* inv; void* chol; int64_t n; void* workspace; cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_inverse_factor<M, T>(s, inv, chol, n, stream);
  }
  template <typename T> int run_large(int m) const {
    return dispatch_warp_m<T>(m, InverseFactorRows{s, inv, chol, n, stream});
  }
  template <typename T> int run_cta(int m) const {
    return launch_inverse_factor_cta<T>(s, inv, chol, n, m, workspace, stream);
  }
};

struct TraceLaunch {
  const void* s; const void* g; void* out; int64_t outer; int64_t inner; void* workspace;
  cudaStream_t stream;
  template <int M, typename T> int run() const {
    return smallchol_unrolled::launch_trace<M, T>(s, g, out, outer, inner, stream);
  }
  template <typename T> int run_large(int m) const {
    if (takes_unrolled<T>(kTraceKernel, m)) {
      return dispatch_warp_m<T>(m, TraceLanes{s, g, out, outer, inner, stream});
    }
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
    const int err = smallchol_unrolled::launch_edge<M, T>(s, a_blk, r, action, mask, mask_stride,
                                                          wct, gain, n_missions, n, round_bf16,
                                                          stream);
    return err == -1 ? run_cta<T>(M) : err;
  }
  template <typename T> int run_large(int m) const {
    if (workspace == nullptr) return -2;
    return dispatch_warp_m<T>(m, EdgeRows{s, a_blk, r, action, mask, mask_stride, wct, gain,
                                          n_missions, n, round_bf16, workspace, stream});
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
  if (count <= 0 || m < 1 || m > kMaxCtaM) return 0;
  if (kind == kEdgeKernel) {
    // the register route unless its slices do not fit; the warp route's U^T
    if (m <= kMaxUnrolledM) {
      if (edge_register_bytes<T>(m, n_cells) <= kMaxSharedBytes) return 0;
    } else if (m <= kMaxWarpM) {
      return edge_rows_bytes<T>(m, count);
    }
    return edge_plan<T>(m, n_cells, count).bytes;
  }
  if (m <= kMaxWarpM) return 0;
  return cta_plan<T>(m, count, kind == kTraceKernel ? kTraceSlots : 1).global_bytes;
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

// sets which kernels take the warp route's M for spd_inverse and
// spd_trace_product (0 by M and dtype, 1 runtime-M, 2 unrolled) and returns
// the previous setting; -1 (nothing set) for another value
int smallchol_set_warp_route(int route) {
  if (route < kWarpRouteDefault || route > kWarpRouteUnrolled) return -1;
  const int previous = g_warp_route;
  g_warp_route = route;
  return previous;
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

#endif  // !defined(SMALLCHOL_PART) || SMALLCHOL_PART == 0
