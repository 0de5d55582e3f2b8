// Probe of edge_factor_gain's warp route (ipp_rl_tpu_torch/csrc/smallchol.cu)
// at M = 25, N = 400, per-mission mask: its factor kernel alone
// (factor_rows_kernel), and the two designs tried for Wc^T = U^T A and
// the gain on the same U: the CTA route's tiled product (edge_product_kernel
// <T, 2>, one pass of 32 rows) with its gain kernel (edge_gain_kernel), and
// the column kernel that the route takes (edge_columns_kernel: a CTA per
// mission, a thread per column).  Both designs' outputs must be equal bit
// for bit.  Built and run by `python3 scripts/time_torch_warp_route.py
// --edge-probe` with -DSMALLCHOL_PART=99 (no part's instantiations: the
// probe instantiates what it launches).
#include "../ipp_rl_tpu_torch/csrc/smallchol.cu"

#include <cstdio>
#include <cstring>
#include <vector>

namespace probe {

constexpr int kM = 25;
constexpr int kN = 400;

template <typename K>
int ctas_per_sm(K kernel, int threads, size_t smem) {
  int ctas = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  return ctas;
}

template <typename F>
float time_ms(F launch, int reps = 50) {
  for (int i = 0; i < 3; ++i) launch();
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  cudaEventRecord(start);
  for (int i = 0; i < reps; ++i) launch();
  cudaEventRecord(end);
  cudaEventSynchronize(end);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, end);
  cudaEventDestroy(start);
  cudaEventDestroy(end);
  return ms / reps;
}

// a deterministic value in [-1, 1)
inline double hashed(uint64_t i) {
  i = (i ^ (i >> 31)) * 0x7fb5d329728ea185ULL;
  i = (i ^ (i >> 27)) * 0x81dadef4bc2dd44dULL;
  return static_cast<double>((i ^ (i >> 33)) >> 11) / 4503599627370496.0 - 1.0;
}

template <typename T>
void run(const char* dtype, int64_t B) {
  const int64_t uu = B * kM * kWarpLdu, an = B * kM * kN, mm = B * kM * kM;
  std::vector<T> h_u(uu, T(0)), h_ut(uu, T(0)), h_a(an), h_mask(B * kN), h_s(mm), h_r(kM);
  std::vector<int64_t> h_act(B, 0);
  for (int64_t b = 0; b < B; ++b) {
    for (int i = 0; i < kM; ++i) {
      for (int j = 0; j <= i; ++j) {  // U lower, positive diagonal
        const T v = i == j ? T(1.0 + 0.5 * hashed(b * 1000 + i)) : T(0.3 * hashed(b * 7919 + i * 31 + j));
        h_u[(b * kM + i) * kWarpLdu + j] = v;   // rows of U: u[i][j] = U[i][j]
        h_ut[(b * kM + j) * kWarpLdu + i] = v;  // rows of U^T: ut[j][i] = U[i][j]
      }
      for (int j = 0; j < kM; ++j)  // S_raw diagonally dominant, symmetric
        h_s[(b * kM + i) * kM + j] = i == j ? T(kM) : T(0.5 / (1 + ((i + j) % 5)));
    }
  }
  for (int64_t e = 0; e < an; ++e) h_a[e] = T(hashed(e + 12345));
  for (int64_t e = 0; e < B * kN; ++e) h_mask[e] = hashed(e + 777) > -0.2 ? T(1) : T(0);
  for (int i = 0; i < kM; ++i) h_r[i] = T(1);
  T *u, *ut, *a, *mask, *s, *r, *wct_tile, *wct_cols, *gain_tile, *gain_cols, *sq, *u_fac;
  int64_t* act;
  cudaMalloc(&u, uu * sizeof(T));
  cudaMalloc(&ut, uu * sizeof(T));
  cudaMalloc(&u_fac, uu * sizeof(T));
  cudaMalloc(&a, an * sizeof(T));
  cudaMalloc(&mask, B * kN * sizeof(T));
  cudaMalloc(&s, mm * sizeof(T));
  cudaMalloc(&r, kM * sizeof(T));
  cudaMalloc(&act, B * sizeof(int64_t));
  cudaMalloc(&wct_tile, an * sizeof(T));
  cudaMalloc(&wct_cols, an * sizeof(T));
  cudaMalloc(&gain_tile, B * sizeof(T));
  cudaMalloc(&gain_cols, B * sizeof(T));
  cudaMalloc(&sq, B * kN * sizeof(T));
  cudaMemcpy(u, h_u.data(), uu * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(ut, h_ut.data(), uu * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(a, h_a.data(), an * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(mask, h_mask.data(), B * kN * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(s, h_s.data(), mm * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(r, h_r.data(), kM * sizeof(T), cudaMemcpyHostToDevice);
  cudaMemcpy(act, h_act.data(), B * sizeof(int64_t), cudaMemcpyHostToDevice);

  const unsigned blocks = static_cast<unsigned>(B);
  auto factor = [&] {
    factor_rows_kernel<kM, T><<<blocks, 32>>>(s, r, act, nullptr, nullptr, u_fac);
  };
  auto tile = [&] {
    launch_edge_product<T, 2>(u, kWarpLdu, a, mask, kN, wct_tile, sq, B, kN, kM, 0, nullptr);
    edge_gain_kernel<T><<<static_cast<unsigned>((B + kGainWarps - 1) / kGainWarps),
                          kGainWarps * 32>>>(sq, gain_tile, B, kN);
  };
  auto tile_product = [&] {
    launch_edge_product<T, 2>(u, kWarpLdu, a, mask, kN, wct_tile, sq, B, kN, kM, 0, nullptr);
  };
  auto columns = [&] {
    edge_columns_kernel<kM, T><<<blocks, kColumnsThreads>>>(ut, a, mask, kN, wct_cols, gain_cols,
                                                           kN, 0);
  };
  const float f1 = time_ms(factor), t1 = time_ms(tile), c1 = time_ms(columns);
  const float t2 = time_ms(tile), c2 = time_ms(columns), f2 = time_ms(factor);
  const float p1 = time_ms(tile_product);
  std::vector<T> w1(an), w2(an), g1(B), g2(B);
  cudaMemcpy(w1.data(), wct_tile, an * sizeof(T), cudaMemcpyDeviceToHost);
  cudaMemcpy(w2.data(), wct_cols, an * sizeof(T), cudaMemcpyDeviceToHost);
  cudaMemcpy(g1.data(), gain_tile, B * sizeof(T), cudaMemcpyDeviceToHost);
  cudaMemcpy(g2.data(), gain_cols, B * sizeof(T), cudaMemcpyDeviceToHost);
  const bool equal = std::memcmp(w1.data(), w2.data(), an * sizeof(T)) == 0 &&
                     std::memcmp(g1.data(), g2.data(), B * sizeof(T)) == 0;
  using Shape = ProdShape<T, 2>;
  printf("%s (%lld, %d, %d): factor %.4f / %.4f ms; tiled product + gain %.4f / %.4f ms "
         "(product alone %.4f); column kernel %.4f / %.4f ms; outputs equal: %s; CTAs per SM: "
         "factor %d (32 threads), product %d (%d threads), column kernel %d (%d threads)\n",
         dtype, static_cast<long long>(B), kM, kN, f1, f2, t1, t2, p1, c1, c2,
         equal ? "yes" : "NO",
         ctas_per_sm(factor_rows_kernel<kM, T>, 32, 0),
         ctas_per_sm(edge_product_kernel<T, 2>, kProdThreads, Shape::elems * sizeof(T)),
         kProdThreads, ctas_per_sm(edge_columns_kernel<kM, T>, kColumnsThreads, 0),
         kColumnsThreads);
  for (void* p : {static_cast<void*>(u), static_cast<void*>(ut), static_cast<void*>(u_fac),
                  static_cast<void*>(a), static_cast<void*>(mask), static_cast<void*>(s),
                  static_cast<void*>(r), static_cast<void*>(act), static_cast<void*>(wct_tile),
                  static_cast<void*>(wct_cols), static_cast<void*>(gain_tile),
                  static_cast<void*>(gain_cols), static_cast<void*>(sq)})
    cudaFree(p);
}

}  // namespace probe

int main() {
  probe::run<float>("float32", 256);
  probe::run<float>("float32", 1024);
  probe::run<float>("float32", 3072);
  probe::run<double>("float64", 1024);
  printf("error: %s\n", cudaGetErrorString(cudaGetLastError()));
  return 0;
}
