// The all-action sweep's dense group from H's taps, for Hopper (sm_90a).
//
// A dense group holds the actions whose measurement rows are not one-hot:
// on every configuration of the repository (rf > 1) each row (a, i) of H
// (Ag, Mg, N) has at most 4 nonzero weights over the N cells.  Its packed,
// symmetrised innovation and gain blocks are
//
//   S[b, t, a] = sum_k w[a,i,k] (sum_l w[a,j,l] Ps[b, c[a,i,k], c[a,j,l]])
//                + R[a, t] (+ jitter where i == j)
//   G[b, t, a] = the same sums over Qs, without R and jitter
//
// for each packed entry t = i(i+1)/2 + j, i >= j, with Xs = 0.5 (X + X^T)
// and (c, w) the row's taps: its cell indices and weights, padded with
// (0, 0.0) to the plan's largest count of nonzeros in a row, KT.  Each sum
// starts from 0 and adds its terms in the order written; the kernel is
// built without FMA contraction (-fmad=false), so it rounds as the plain
// version, ops/smallchol.sweep_tap_blocks, term by term.
//
// Precision: P and Q are read in their stored dtype.  With `round_p` (the
// bf16-streamed sweep) P's entries are rounded to bfloat16 as they are
// read, as Q already is; every sum runs in the accumulation dtype (f32 or
// f64), which is P's.
//
// What it replaces: the dense group's two-stage contraction, the JAX
// package's `_dense_group_gains` (ipp_rl_tpu/ops/kalman.py:429, its
// `stage` at :458): T = H_flat X over the whole batch (a (Ag Mg, N) x
// (N, B N) GEMM after a strided copy of X), then Ag batched (Mg, N) x
// (N, Mg B) GEMMs, the casts between them, and the gathers of the lower
// and upper triangles averaged into the packed layout.  On the port's
// paths it runs once per all-action sweep: every greedy step, every
// lockstep step of the classic search, CMA-ES's greedy init.
//
// Bound on an H100 (3.35 TB/s) at the greedy cell's B = 4096, N = 100,
// Ag = 100, T = 45, f32 P and bf16 Q: P 40 KB and Q 20 KB read and S and G
// 2 x 18 KB written per mission, 393 MB (0.117 ms); ~0.4 GFLOP.
// Bytes-bound by that count; on an H100 it runs ~0.39 ms there, paced by
// the shared-memory pipe: an entry's KT^2 = 16 reads of Xs (about two bank
// wavefronts each, the warp's lanes being 32 actions' cells) and its
// tap-table loads.
//
// Design: one CTA per (mission, block): blockIdx.y = 0 forms S from P,
// 1 forms G from Q.  The CTA stages the mission's X into shared memory in
// the accumulation dtype (N^2 values: 40 KB at N = 100 in f32, so five
// CTAs per SM) with 16-byte loads and stores where the rows are aligned,
// symmetrises it in place (a warp on a row at a time, from the diagonal),
// then its threads take the Mg x Ag columns (j, a) of the packed
// triangles, a innermost: a thread keeps row j's taps in registers and
// forms its column's entries i = j .. Mg - 1, each from row i's taps and
// the KT x KT terms of Xs in shared memory.  The warp's lanes are 32
// actions, so its stores and its loads of the tap tables, laid out
// (Mg, KT, Ag), run along a.  The wrapper routes a plan here only where
// N^2 values fit a CTA's shared memory (ops/kalman.prepare_batched_sweep);
// larger grids keep the two-stage contraction.  No workspace, no
// allocation, no synchronisation with the host: the launch can be
// captured in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace sweep_taps {

constexpr int kThreads = 256;
constexpr int kMaxTaps = 8;

// bfloat16 round trip of an accumulation-dtype value, as torch's
// `x.to(torch.bfloat16).to(x.dtype)`: a double goes through float first
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ double round_bf16(double x) {
  return static_cast<double>(__bfloat162float(__float2bfloat16_rn(static_cast<float>(x))));
}

// one staged value in the accumulation dtype: a bfloat16 widened, an
// accumulation-dtype value rounded to bfloat16 and back where asked
template <typename Acc, typename Src>
__device__ __forceinline__ Acc widen(Src x, bool round) {
  if constexpr (std::is_same_v<Src, __nv_bfloat16>) {
    return static_cast<Acc>(__bfloat162float(x));
  } else {
    return round ? round_bf16(x) : x;
  }
}

// copy nn values of src into xs (the accumulation dtype), rounding to
// bfloat16 where asked; 16-byte loads (streamed past L1) and 16-byte shared
// stores where src is aligned and nn fills whole vectors, else one value
// per thread
template <typename Acc, typename Src>
__device__ __forceinline__ void stage(Acc* xs, const Src* __restrict__ src, int nn, bool round) {
  constexpr int kPer = 16 / sizeof(Src);                // values a 16-byte load brings
  constexpr int kOut = kPer * sizeof(Acc) / 16;         // 16-byte stores they fill
  const bool vec = (reinterpret_cast<uintptr_t>(src) % 16 == 0) && (nn % kPer == 0);
  if (vec) {
    const uint4* v = reinterpret_cast<const uint4*>(src);
    uint4* out = reinterpret_cast<uint4*>(xs);
    for (int k = threadIdx.x; k < nn / kPer; k += blockDim.x) {
      uint4 u = __ldcs(v + k);
      const Src* e = reinterpret_cast<const Src*>(&u);
      union {
        Acc vals[kPer];
        uint4 chunks[kOut];
      } w;
#pragma unroll
      for (int q = 0; q < kPer; ++q) w.vals[q] = widen<Acc, Src>(e[q], round);
#pragma unroll
      for (int q = 0; q < kOut; ++q) out[k * kOut + q] = w.chunks[q];
    }
  } else {
    for (int k = threadIdx.x; k < nn; k += blockDim.x) xs[k] = widen<Acc, Src>(src[k], round);
  }
}

// Xs = 0.5 (X + X^T) in place, warp w on rows w, w + 8, ..., its lanes along
// the row from the diagonal: the lane of (c, d), c <= d, writes both
// entries, which no other lane reads or writes
template <typename Acc>
__device__ __forceinline__ void symmetrise(Acc* xs, int n) {
  const int warps = blockDim.x >> 5, lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c < n; c += warps) {
    for (int d = c + lane; d < n; d += 32) {
      const Acc s = Acc(0.5) * (xs[c * n + d] + xs[d * n + c]);
      xs[c * n + d] = s;
      xs[d * n + c] = s;
    }
  }
}

// S (blockIdx.y = 0) or G (1) of mission blockIdx.x, (T, Ag) at out + b T Ag.
// cells, weights: (Mg, KT, Ag); r: (T, Ag).  A thread takes column j of
// action a's packed triangle, entries t = i(i+1)/2 + j for i = j .. Mg - 1,
// with row j's taps in registers.
template <typename Acc, int KT>
__global__ void __launch_bounds__(kThreads)
sweep_tap_blocks_kernel(const Acc* __restrict__ p, const void* __restrict__ q, int q_bf16,
                        int round_p, const int* __restrict__ cells,
                        const Acc* __restrict__ weights, const Acc* __restrict__ r, Acc jitter,
                        Acc* __restrict__ s_out, Acc* __restrict__ g_out, int n, int ag, int mg) {
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* xs = reinterpret_cast<Acc*>(smem);
  const long long b = blockIdx.x;
  const bool is_s = blockIdx.y == 0;
  const int nn = n * n;
  if (is_s) {
    stage(xs, p + b * nn, nn, round_p != 0);
  } else if (q_bf16) {
    stage(xs, static_cast<const __nv_bfloat16*>(q) + b * nn, nn, false);
  } else {
    stage(xs, static_cast<const Acc*>(q) + b * nn, nn, false);
  }
  __syncthreads();
  symmetrise(xs, n);
  __syncthreads();

  Acc* out = (is_s ? s_out : g_out) + b * (mg * (mg + 1) / 2) * ag;
  const int stride = KT * ag;  // from one row's taps to the next row's
  int j = threadIdx.x / ag, a = threadIdx.x - j * ag;  // column w = j * ag + a
  for (int w = threadIdx.x; w < mg * ag; w += blockDim.x) {
    int cj[KT];
    Acc wj[KT];
#pragma unroll
    for (int l = 0; l < KT; ++l) {
      cj[l] = __ldg(cells + j * stride + l * ag + a);
      wj[l] = __ldg(weights + j * stride + l * ag + a);
    }
    for (int i = j; i < mg; ++i) {
      const int e = (i * (i + 1) / 2 + j) * ag + a;
      Acc acc = Acc(0);
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const Acc* row = xs + __ldg(cells + i * stride + k * ag + a) * n;
        Acc inner = Acc(0);
#pragma unroll
        for (int l = 0; l < KT; ++l) inner = inner + wj[l] * row[cj[l]];
        acc = acc + __ldg(weights + i * stride + k * ag + a) * inner;
      }
      if (is_s) {
        acc = acc + __ldg(r + e);
        if (jitter != Acc(0)) acc = acc + jitter * (i == j ? Acc(1) : Acc(0));
      }
      out[e] = acc;
    }
    for (a += blockDim.x; a >= ag; a -= ag) ++j;
  }
}

template <typename Acc, int KT>
int launch(const void* p, const void* q, int q_bf16, int round_p, const int* cells,
           const void* weights, const void* r, double jitter, void* s_out, void* g_out,
           long long batch, int n, int ag, int mg, cudaStream_t stream) {
  const size_t shared = sizeof(Acc) * static_cast<size_t>(n) * n;
  auto kernel = sweep_tap_blocks_kernel<Acc, KT>;
  if (shared > 48 * 1024) {  // past what a launch may take without opting in
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(batch), 2);
  kernel<<<grid, kThreads, shared, stream>>>(
      static_cast<const Acc*>(p), q, q_bf16, round_p, cells, static_cast<const Acc*>(weights),
      static_cast<const Acc*>(r), static_cast<Acc>(jitter), static_cast<Acc*>(s_out),
      static_cast<Acc*>(g_out), n, ag, mg);
  return static_cast<int>(cudaGetLastError());
}

template <typename Acc>
int dispatch(int kt, const void* p, const void* q, int q_bf16, int round_p, const int* cells,
             const void* weights, const void* r, double jitter, void* s_out, void* g_out,
             long long batch, int n, int ag, int mg, cudaStream_t stream) {
#define SWEEP_TAPS_CASE(K)                                                                  \
  case K:                                                                                   \
    return launch<Acc, K>(p, q, q_bf16, round_p, cells, weights, r, jitter, s_out, g_out, \
                          batch, n, ag, mg, stream);
  switch (kt) {
    SWEEP_TAPS_CASE(1)
    SWEEP_TAPS_CASE(2)
    SWEEP_TAPS_CASE(3)
    SWEEP_TAPS_CASE(4)
    SWEEP_TAPS_CASE(5)
    SWEEP_TAPS_CASE(6)
    SWEEP_TAPS_CASE(7)
    SWEEP_TAPS_CASE(8)
    default:
      return -1;
  }
#undef SWEEP_TAPS_CASE
}

// the bytes of shared memory one CTA may take on the current device
long long shared_limit() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace sweep_taps

extern "C" {

// S and G (batch, T, Ag) of the dense group from P (batch, N, N) in the
// accumulation dtype (0 f32, 1 f64) and Q in it or, with q_bf16, in
// bfloat16.  Returns 0, a cudaError_t, or -1 for what it does not take.
int sweep_taps_blocks(const void* p, const void* q, int q_bf16, int round_p, const void* cells,
                      const void* weights, const void* r, double jitter, void* s_out,
                      void* g_out, long long batch, int n, int ag, int mg, int kt, int dtype,
                      void* stream) {
  const long long t = static_cast<long long>(mg) * (mg + 1) / 2;
  if (batch <= 0 || batch > 0x7fffffffLL || n <= 0 || ag <= 0 || mg <= 0 ||
      kt < 1 || kt > sweep_taps::kMaxTaps || t * ag > 0x7fffffffLL ||
      static_cast<long long>(n) * n > 0x7fffffffLL / 8)
    return -1;
  const size_t bytes = (dtype == 0 ? 4 : 8) * static_cast<size_t>(n) * n;
  if (static_cast<long long>(bytes) > sweep_taps::shared_limit()) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto c = static_cast<const int*>(cells);
  if (dtype == 0)
    return sweep_taps::dispatch<float>(kt, p, q, q_bf16, round_p, c, weights, r, jitter, s_out,
                                       g_out, batch, n, ag, mg, s);
  if (dtype == 1)
    return sweep_taps::dispatch<double>(kt, p, q, q_bf16, round_p, c, weights, r, jitter, s_out,
                                        g_out, batch, n, ag, mg, s);
  return -1;
}

}  // extern "C"
