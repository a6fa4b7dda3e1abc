// Streaming sieve gains on Hopper (SIMT, sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/marginal_gain.py:
//   * sieve_gain_eval (`_sieve_gain_kernel`): for every row r of an (r, n)
//     cache table T against one stream element's distance row dvec,
//       out[r] = n_total^-1 sum_i relu(T[r,i] - dvec_i)               (min)
//       out[r] = n_total^-1 sum_i relu((alpha + beta dvec_i) - T[r,i])  (max)
//     Row 0 of the streaming engine's table is the function's seed (its gain
//     is the singleton gain), the other rows are the sieves' caches.
//   * sieve_gain_eval_batched (`_sieve_gain_kernel_batched`): the same for P
//     stream partitions in one launch, a (P, r, n) table against (P, n) rows.
//     The TPU grid (P, s_tiles, n_tiles) becomes blockIdx.y = partition,
//     blockIdx.x = row; each block moves its pointers to its partition's
//     slice (in 64 bits) and runs the unbatched body, so a partition's gains
//     are bit for bit those of its own unbatched launch.
//
// What bounds it: device memory. Each row is read once and dvec once per
// row (from L2 after the first), 3 (min) or 5 (max) fp32 operations per
// element: at n = 50 000 and the sieve table's 34 slots plus the seed row,
// 7.2 MB, 2.15 us at 3.35 TB/s. The stream launches it once per element, so
// at that size the launch, not the kernel, sets the pace.
//
// Design: one block of NT threads per (row, partition). Threads stride over
// n in a fixed order (thread t sums elements t, t + NT, ... into one fp32
// register, four loads in flight), then a fixed-order tree in shared memory
// joins the NT partial sums: no atomics, so a row's gain does not depend on
// which rows or partitions share the launch. Columns past n never exist:
// the loop stops at n, in place of the reference's padding sentinels (0
// under min, +inf under max). The affine is rounded as the plain version
// rounds it (a product, then a sum; no FMA). The (r, n) intermediate never
// reaches device memory.
#include "tile.cuh"

namespace {

constexpr int SIEVE_NT = 256;

template <bool FOLD_MAX, bool BATCHED>
__global__ void __launch_bounds__(SIEVE_NT)
sieve_gain_kernel(const float* __restrict__ T, const float* __restrict__ dvec,
                  float* __restrict__ out, int r, int n, float n_total, float alpha,
                  float beta) {
  const long long row = blockIdx.x;
  if (BATCHED) {  // partition blockIdx.y of a (rows, P) grid
    const long long p = blockIdx.y;
    T += p * r * n;
    dvec += p * n;
    out += p * r;
  }
  const float* t = T + row * n;
  const int tid = threadIdx.x;
  float acc = 0.f;
  int i = tid;
  // four independent loads in flight per thread; the sum stays in index order
  for (; i + 3 * SIEVE_NT < n; i += 4 * SIEVE_NT) {
    float tv[4], dv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      tv[u] = __ldg(t + i + u * SIEVE_NT);
      dv[u] = __ldg(dvec + i + u * SIEVE_NT);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float g = FOLD_MAX ? __fadd_rn(alpha, __fmul_rn(beta, dv[u])) - tv[u] : tv[u] - dv[u];
      acc += fmaxf(g, 0.f);
    }
  }
  for (; i < n; i += SIEVE_NT) {
    const float d = __ldg(dvec + i), tv = __ldg(t + i);
    const float g = FOLD_MAX ? __fadd_rn(alpha, __fmul_rn(beta, d)) - tv : tv - d;
    acc += fmaxf(g, 0.f);
  }
  __shared__ float red[SIEVE_NT];
  red[tid] = acc;
  __syncthreads();
#pragma unroll
  for (int s = SIEVE_NT / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) out[row] = red[0] / n_total;
}

template <bool BATCHED>
int launch(const float* T, const float* dvec, float* out, int P, int r, int n, float n_total,
           int fold_max, float alpha, float beta, cudaStream_t stream) {
  if (P < 1 || P > 65535 || r < 1 || n < 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(r, P);
  if (fold_max)
    sieve_gain_kernel<true, BATCHED><<<grid, SIEVE_NT, 0, stream>>>(T, dvec, out, r, n, n_total,
                                                                    alpha, beta);
  else
    sieve_gain_kernel<false, BATCHED><<<grid, SIEVE_NT, 0, stream>>>(T, dvec, out, r, n, n_total,
                                                                     alpha, beta);
  return (int)cudaGetLastError();
}

}  // namespace

// T (r, n), dvec (n,), out (r,), all float32 and contiguous.
extern "C" int repro_sieve_gain_eval(const float* T, const float* dvec, float* out, int r, int n,
                                     float n_total, int fold_max, float alpha, float beta,
                                     void* stream) {
  return launch<false>(T, dvec, out, 1, r, n, n_total, fold_max, alpha, beta,
                       static_cast<cudaStream_t>(stream));
}

// T (P, r, n), dvec (P, n), out (P, r), all float32 and contiguous.
extern "C" int repro_sieve_gain_eval_batched(const float* T, const float* dvec, float* out, int P,
                                             int r, int n, float n_total, int fold_max,
                                             float alpha, float beta, void* stream) {
  return launch<true>(T, dvec, out, P, r, n, n_total, fold_max, alpha, beta,
                      static_cast<cudaStream_t>(stream));
}
