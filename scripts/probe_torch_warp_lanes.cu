// Probes of the lane-per-block trace product (spd_trace_product_lanes_kernel
// in ipp_rl_tpu_torch/csrc/smallchol.cu) at M = 25, float32, on one
// (256, 325, 400) launch of the 2 m grid's sweep: its passes timed as
// prefixes, and the variants tried while designing it, each its own kernel
// here.  Built and run by `python3 scripts/time_torch_warp_route.py
// --lanes-probe` with -DSMALLCHOL_PART=4 (the part of the library source that
// holds M = 25..27).  Variants marked "timing only" do not round like the
// plain version; the others are checked equal to the committed kernel.
#include "../ipp_rl_tpu_torch/csrc/smallchol.cu"

#include <cstdio>
#include <vector>

namespace probe {

constexpr int kM = 25;
constexpr int kT = kM * (kM + 1) / 2;

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// L^-1 by columns with the divisions replaced by products with a reciprocal
// (timing only)
template <int M, int R, typename T>
__device__ __forceinline__ void invert_columns_fast(T* x, int c) {
  T col[R][M];
  T* xc = x + (c * (c + 1) / 2 + c) * 32;
  col[0][0] = T(1) / xc[0];
  xc[0] = col[0][0];
#pragma unroll
  for (int dd = 1; dd < M; ++dd) {
    if (c + dd < M) {
      const int i = c + dd;
      T* xi = x + (i * (i + 1) / 2 + c) * 32;
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
      const T r = __frcp_rn(xi[dd * 32]);
      col[0][dd] = -acc0 * r;
      xi[0] = col[0][dd];
      if constexpr (R == 2) {
        const int q = dd == 1 ? 0 : dd - 1;
        col[1][q] = (dd == 1 ? T(1) : -acc1) * r;
        xi[32] = col[1][q];
      }
    }
  }
}

// the terms with a constant in place of G (timing only)
template <int M, int R, typename T>
__device__ __forceinline__ void term_columns_without_g(T* x, int j) {
  T col[R][M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (k >= j + q) col[q][k] = x[(k * (k + 1) / 2 + j + q) * 32];
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
          T term = acc[q] * T(1.5);
          if (i != j + q) term = term + term;
          x[(i * (i + 1) / 2 + j + q) * 32] = term;
        }
      }
    }
  }
}

// L^-1 row by row, right-looking within the row: term k to every entry j <= k
template <int M, typename T>
__device__ __forceinline__ void invert_row(T* x, int i) {
  T* xi = x + (i * (i + 1) / 2) * 32;
  T acc[M - 1];
#pragma unroll
  for (int j = 0; j < M - 1; ++j) acc[j] = T(-0.0);
#pragma unroll
  for (int k = 0; k < M - 1; ++k) {
    if (k < i) {
      const T lik = xi[k * 32];
#pragma unroll
      for (int j = 0; j <= k; ++j) acc[j] = acc[j] + lik * x[(k * (k + 1) / 2 + j) * 32];
    }
  }
  const T lii = xi[i * 32];
#pragma unroll
  for (int j = 0; j < M - 1; ++j) {
    if (j < i) xi[j * 32] = -acc[j] / lii;
  }
  xi[i * 32] = T(1) / lii;
}

// S^-1 by right-looking steps over k, each entry's sum in its own slot
template <int M, typename T>
__device__ __forceinline__ void inverse_step(T* x, int k) {
  T* xk = x + (k * (k + 1) / 2) * 32;
  T rk[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i <= k) rk[i] = xk[i * 32];
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i <= k) {
      const bool first = i == k;
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T* e = x + (i * (i + 1) / 2 + j) * 32;
        *e = (first ? T(-0.0) : *e) + rk[i] * rk[j];
      }
    }
  }
}

enum Variant {
  kCommitted,     // the library's kernel, restated
  kStaging,       // the staging of S only
  kCholesky,      // + the Cholesky
  kInverse,       // + L^-1
  kFastDivision,  // + L^-1 by reciprocals (timing only)
  kWithoutG,      // the whole kernel with a constant for G (timing only)
  kOneChain,      // one row or column per step (R = 1) in every pass
  kRightLooking,  // L^-1 by rows, S^-1 by right-looking steps, the trace last
  kPrefetchG,     // G's lines prefetched into L2 after the staging
  kStage16,       // S staged by 16-byte copies, four blocks' entry each
};

template <int V>
__global__ void __launch_bounds__(32)
variant_kernel(const float* __restrict__ s, const float* __restrict__ g, float* __restrict__ out,
               int64_t outer, int64_t inner) {
  constexpr int M = kM;
  extern __shared__ __align__(16) unsigned char probe_smem[];
  const int lane = static_cast<int>(threadIdx.x);
  const int64_t n = outer * inner;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * 32;
  const int64_t mine = t0 + lane;
  const int64_t t = mine < n ? mine : n - 1;
  const int64_t o = t / inner;
  const int64_t base = o * (kT - 1) * inner + t;
  float* x = reinterpret_cast<float*>(probe_smem) + lane;
  if (V == kStage16 && inner % 4 == 0 && t0 + 32 <= n) {
    const int q = lane & 7;  // blocks t0 + 4q .. t0 + 4q + 3
    const int64_t tq = t0 + 4 * q;
    const float* src = s + tq / inner * (kT - 1) * inner + tq;
    float* dst = reinterpret_cast<float*>(probe_smem) + 4 * q;
    for (int e = lane >> 3; e < kT; e += 4) cp_async_16(dst + e * 32, src + e * inner);
  } else {
    const float* src = s + base;
#pragma unroll 8
    for (int e = 0; e < kT; ++e, src += inner) cp_async_small<4>(x + e * 32, src);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const float* gb = g + base;
  if (V == kPrefetchG) {
#pragma unroll 8
    for (int e = 0; e < kT; ++e) prefetch_l2(gb + e * inner);
  }
  float inv_d[M] = {};
  float extra = 0.0f;
  if (V != kStaging) {
    if (V == kOneChain) {
#pragma unroll 1
      for (int i = 0; i < M; ++i) lanes_cholesky_rows<M, 1>(x, i, inv_d);
    } else {
#pragma unroll 1
      for (int i = 0; i + 1 < M; i += 2) lanes_cholesky_rows<M, 2>(x, i, inv_d);
      lanes_cholesky_rows<M, 1>(x, M - 1, inv_d);
    }
  }
  if (V == kOneChain) {
#pragma unroll 1
    for (int c = 0; c < M; ++c) lanes_invert_columns<M, 1>(x, c);
  } else if (V == kFastDivision) {
#pragma unroll 1
    for (int c = 0; c + 1 < M; c += 2) invert_columns_fast<M, 2>(x, c);
    invert_columns_fast<M, 1>(x, M - 1);
  } else if (V == kRightLooking) {
#pragma unroll 1
    for (int i = 0; i < M; ++i) invert_row<M>(x, i);
  } else if (V != kStaging && V != kCholesky) {
#pragma unroll 1
    for (int c = 0; c + 1 < M; c += 2) lanes_invert_columns<M, 2>(x, c);
    lanes_invert_columns<M, 1>(x, M - 1);
  }
  float total = x[0];
  if (V == kRightLooking) {  // the steps, then the terms and the trace in packed order
#pragma unroll 1
    for (int k = 0; k < M; ++k) inverse_step<M>(x, k);
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int e = i * (i + 1) / 2 + j;
        float term = x[e * 32] * __ldg(gb + e * inner);
        if (i != j) term = term + term;
        total = e == 0 ? term : total + term;
      }
    }
  } else {
    if (V == kOneChain) {
#pragma unroll 1
      for (int j = 0; j < M; ++j) lanes_term_columns<M, 1>(x, gb, inner, j);
    } else if (V == kWithoutG) {
#pragma unroll 1
      for (int j = 0; j + 1 < M; j += 2) term_columns_without_g<M, 2>(x, j);
      term_columns_without_g<M, 1>(x, M - 1);
    } else if (V != kStaging && V != kCholesky && V != kInverse && V != kFastDivision) {
#pragma unroll 1
      for (int j = 0; j + 1 < M; j += 2) lanes_term_columns<M, 2>(x, gb, inner, j);
      lanes_term_columns<M, 1>(x, gb, inner, M - 1);
    }
    total = x[0];
#pragma unroll 8
    for (int e = 1; e < kT; ++e) total = total + x[e * 32];
    extra = inv_d[M - 1];  // keeps the passes of the prefixes alive
  }
  const bool keeps_order = V == kCommitted || V == kOneChain || V == kRightLooking ||
                           V == kPrefetchG || V == kStage16;
  if (mine < n) out[mine] = keeps_order ? total : total + extra;
}

template <int V>
float time_variant(const float* s, const float* g, float* out, int64_t outer, int64_t inner,
                   std::vector<float>* result, int carveout = -1) {
  const size_t bytes = static_cast<size_t>(kT) * 32 * 4;
  const int64_t n = outer * inner;
  auto k = variant_kernel<V>;
  if (carveout >= 0) cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout, carveout);
  for (int w = 0; w < 2; ++w) k<<<(n + 31) / 32, 32, bytes>>>(s, g, out, outer, inner);
  result->resize(n);
  cudaMemcpy(result->data(), out, n * 4, cudaMemcpyDeviceToHost);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 10; ++r) k<<<(n + 31) / 32, 32, bytes>>>(s, g, out, outer, inner);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms / 10;
}

}  // namespace probe

int main() {
  using namespace probe;
  const int64_t outer = 256, inner = 400, n = outer * inner;
  // diagonally dominant blocks, so every pivot is positive
  std::vector<float> h(static_cast<size_t>(outer) * kT * inner);
  for (int64_t o = 0; o < outer; ++o)
    for (int i = 0; i < kM; ++i)
      for (int j = 0; j <= i; ++j)
        for (int64_t c = 0; c < inner; ++c)
          h[((o * kT) + i * (i + 1) / 2 + j) * inner + c] =
              i == j ? float(kM + 1) : 0.5f / float(1 + ((i * 7 + j * 3 + c) % 5));
  float *s, *g, *out;
  cudaMalloc(&s, h.size() * 4);
  cudaMalloc(&g, h.size() * 4);
  cudaMalloc(&out, n * 4);
  cudaMemcpy(s, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(g, h.data(), h.size() * 4, cudaMemcpyHostToDevice);

  std::vector<float> lib(n), r;
  const size_t bytes = static_cast<size_t>(kT) * 32 * 4;
  smallchol_unrolled::launch_trace_lanes<kM, float>(s, g, out, outer, inner, nullptr);
  cudaMemcpy(lib.data(), out, n * 4, cudaMemcpyDeviceToHost);
  int ctas = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, variant_kernel<kCommitted>, 32, bytes);
  printf("M = 25 float32, (256, 325, 400), %d warps per SM\n", ctas);
  struct Row { const char* name; float ms; bool equal; };
  std::vector<Row> rows;
  auto add = [&](const char* name, float ms, bool check) {
    rows.push_back({name, ms, !check || r == lib});
  };
  add("committed kernel", time_variant<kCommitted>(s, g, out, outer, inner, &r), true);
  add("prefix: staging of S", time_variant<kStaging>(s, g, out, outer, inner, &r), false);
  add("prefix: + Cholesky", time_variant<kCholesky>(s, g, out, outer, inner, &r), false);
  add("prefix: + L^-1", time_variant<kInverse>(s, g, out, outer, inner, &r), false);
  add("prefix: + L^-1 by reciprocals (timing only)",
      time_variant<kFastDivision>(s, g, out, outer, inner, &r), false);
  add("whole, a constant for G (timing only)", time_variant<kWithoutG>(s, g, out, outer, inner, &r), false);
  add("one chain per step (R = 1)", time_variant<kOneChain>(s, g, out, outer, inner, &r), true);
  add("right-looking L^-1 rows and S^-1 steps", time_variant<kRightLooking>(s, g, out, outer, inner, &r), true);
  add("G prefetched into L2", time_variant<kPrefetchG>(s, g, out, outer, inner, &r), true);
  add("S staged by 16-byte copies", time_variant<kStage16>(s, g, out, outer, inner, &r), true);
  add("committed, carveout 50% (fewer warps per SM)",
      time_variant<kCommitted>(s, g, out, outer, inner, &r, 50), true);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, variant_kernel<kCommitted>, 32, bytes);
  for (const Row& row : rows) {
    printf("  %-48s %.4f ms%s\n", row.name, row.ms, row.equal ? "" : "  (output differs)");
  }
  printf("  (the 50%% carveout held %d warps per SM)\nerror: %s\n", ctas,
         cudaGetErrorString(cudaGetLastError()));
  return 0;
}
