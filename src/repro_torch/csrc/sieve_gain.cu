// Streaming sieve gains on Hopper (SIMT, sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/marginal_gain.py:
//   * sieve_gain_eval (`_sieve_gain_kernel`): for every row r of an (r, n)
//     cache table T against one stream element's distance row dvec,
//       out[r] = n_total^-1 sum_i relu(T[r,i] - dvec_i)               (min)
//       out[r] = n_total^-1 sum_i relu((alpha + beta dvec_i) - T[r,i])  (max)
//     The streaming engine's rows are the function's seed (its gain is the
//     singleton gain) and the sieves' caches. The seed comes in through its
//     own pointer and scores as row 0 of the output, so the caller never
//     copies the table to put the seed in front of it.
//   * sieve_gain_eval_batched (`_sieve_gain_kernel_batched`): the same for P
//     stream partitions in one launch, a (P, r, n) table against (P, n)
//     rows and one seed row shared by every partition (partition stride 0).
//
// What bounds it: device memory. Each row is read once and dvec once per
// row (from L2 after the first), 3 (min) or 5 (max) fp32 operations per
// element: at n = 50 000 and the sieve table's 34 slots plus the seed row,
// 7.2 MB, 2.15 us at 3.35 TB/s. A row is 200 KB, so one block per row (35
// busy SMs of 132, four 4-byte loads in flight a thread) is latency-bound.
// So is this split, at that size: a launch of 280 blocks that loads nothing
// takes 2.1 us of device time on the H100 (tools/sieve_variants.py).
//
// Design: each (partition, row) is one thread-block cluster of
// SIEVE_CLUSTER = 8 blocks along n (grid (8, rows, P)). Block c of a
// cluster takes the columns [c * span, (c + 1) * span) of n, where span =
// ceil(n / 8) rounded up to a whole step of 256 threads x 4 columns: a
// function of n alone, so a block whose span lies past n adds nothing and
// contributes an exact 0. Thread t of a block takes 4 consecutive columns
// per step (one 128-bit load of T and one of dvec where the row and dvec
// start on 16 bytes, else four scalar loads) with SIEVE_U steps in flight,
// and adds its terms into one fp32 register in column order: both load
// paths make the same adds in the same order, so a partition slice that
// starts off 16 bytes (n % 4 != 0) gets the bits of an aligned copy. A
// fixed shuffle tree and a fixed sum over the 8 warps reduce the block,
// whose partial goes into block rank 0's shared memory through distributed
// shared memory; after one cluster barrier rank 0 adds the 8 partials in
// rank order and divides by n_total. No workspace, no second launch, no
// atomics: a row's gain depends on n and its own inputs only, never on r,
// P, its place in the table or its alignment. Columns past n never exist:
// in place of the reference's padding sentinels (0 under min, +inf under
// max) the loads and adds stop at n. The affine is rounded as the plain
// version rounds it (a product, then a sum; no FMA). The (r, n)
// intermediate never reaches device memory.
#include <cooperative_groups.h>

#include <algorithm>
#include <cstdint>

#include "tile.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SIEVE_NT = 256;       // threads per block
constexpr int SIEVE_CLUSTER = 8;    // blocks per row: one thread-block cluster
constexpr int SIEVE_VEC = 4;        // consecutive columns a thread takes per step
constexpr int SIEVE_STEP = SIEVE_NT * SIEVE_VEC;  // columns a block takes per step
constexpr int SIEVE_U = 4;          // steps in flight per thread
constexpr int SIEVE_QUANTUM = SIEVE_STEP;  // a block's span is whole steps
constexpr int SIEVE_MAX_ROWS = 65535;  // gridDim.y; longer tables launch in chunks
constexpr int SIEVE_MAX_N = 1 << 30;   // keeps every column index in an int

// Columns one block of a row's cluster takes: a function of n alone
// (marginal_gain.sieve_span mirrors it).
__host__ __device__ constexpr int sieve_span(int n) {
  return ((n + SIEVE_CLUSTER - 1) / SIEVE_CLUSTER + SIEVE_QUANTUM - 1) / SIEVE_QUANTUM *
         SIEVE_QUANTUM;
}

template <bool FOLD_MAX>
__device__ __forceinline__ float relu_term(float t, float d, float alpha, float beta) {
  const float g = FOLD_MAX ? __fadd_rn(alpha, __fmul_rn(beta, d)) - t : t - d;
  return fmaxf(g, 0.f);
}

// Output row `row0 + blockIdx.y` of partition blockIdx.z: the seed row when
// `seed` is given and the row is 0, else cache row (row - has_seed) of T.
template <bool FOLD_MAX>
__global__ void __cluster_dims__(SIEVE_CLUSTER, 1, 1) __launch_bounds__(SIEVE_NT)
sieve_gain_kernel(const float* __restrict__ T, const float* __restrict__ seed,
                  const float* __restrict__ dvec, float* __restrict__ out, int r, int rows,
                  int row0, int n, float n_total, float alpha, float beta) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long p = blockIdx.z;
  const int row = row0 + static_cast<int>(blockIdx.y);
  dvec += p * n;
  out += p * rows;
  const int has_seed = seed != nullptr;
  const float* t = has_seed && row == 0 ? seed : T + (p * r + (row - has_seed)) * (long long)n;

  const int tid = static_cast<int>(threadIdx.x);
  const int span = sieve_span(n);
  const int lo = min(n, rank * span);
  const int hi = min(n, lo + span);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(t) | reinterpret_cast<uintptr_t>(dvec)) & 15) == 0;
  float acc = 0.f;
  for (int c0 = lo + tid * SIEVE_VEC; c0 < hi; c0 += SIEVE_U * SIEVE_STEP) {
    float4 tv[SIEVE_U], dv[SIEVE_U];
#pragma unroll
    for (int u = 0; u < SIEVE_U; ++u) {
      const int c = c0 + u * SIEVE_STEP;
      if (vec && c + 3 < hi) {
        tv[u] = __ldg(reinterpret_cast<const float4*>(t + c));
        dv[u] = __ldg(reinterpret_cast<const float4*>(dvec + c));
      } else {
        tv[u].x = c < hi ? __ldg(t + c) : 0.f;
        tv[u].y = c + 1 < hi ? __ldg(t + c + 1) : 0.f;
        tv[u].z = c + 2 < hi ? __ldg(t + c + 2) : 0.f;
        tv[u].w = c + 3 < hi ? __ldg(t + c + 3) : 0.f;
        dv[u].x = c < hi ? __ldg(dvec + c) : 0.f;
        dv[u].y = c + 1 < hi ? __ldg(dvec + c + 1) : 0.f;
        dv[u].z = c + 2 < hi ? __ldg(dvec + c + 2) : 0.f;
        dv[u].w = c + 3 < hi ? __ldg(dvec + c + 3) : 0.f;
      }
    }
    // the adds in column order, whichever way the columns were loaded
#pragma unroll
    for (int u = 0; u < SIEVE_U; ++u) {
      const int c = c0 + u * SIEVE_STEP;
      if (c < hi) acc += relu_term<FOLD_MAX>(tv[u].x, dv[u].x, alpha, beta);
      if (c + 1 < hi) acc += relu_term<FOLD_MAX>(tv[u].y, dv[u].y, alpha, beta);
      if (c + 2 < hi) acc += relu_term<FOLD_MAX>(tv[u].z, dv[u].z, alpha, beta);
      if (c + 3 < hi) acc += relu_term<FOLD_MAX>(tv[u].w, dv[u].w, alpha, beta);
    }
  }

  // the block: a fixed shuffle tree per warp, then the warps in order; the
  // block's partial goes into rank 0's shared memory, at its rank
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ float warp_sum[SIEVE_NT / 32];
  __shared__ float partial[SIEVE_CLUSTER];
  if ((tid & 31) == 0) warp_sum[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    float s = warp_sum[0];
#pragma unroll
    for (int w = 1; w < SIEVE_NT / 32; ++w) s += warp_sum[w];
    cluster.map_shared_rank(partial, 0)[rank] = s;
  }
  // the cluster: one barrier (every partial written and visible), then
  // rank 0 adds the partials in rank order; no block reads another's
  // shared memory after it, so every block may exit
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float s = partial[0];
#pragma unroll
    for (int q = 1; q < SIEVE_CLUSTER; ++q) s += partial[q];
    out[row] = s / n_total;
  }
}

int launch(const float* T, const float* seed, const float* dvec, float* out, int P, int r, int n,
           float n_total, int fold_max, float alpha, float beta, cudaStream_t stream) {
  const int rows = r + (seed != nullptr);
  if (P < 1 || P > 65535 || r < 0 || rows < 1 || n < 0 || n > SIEVE_MAX_N)
    return (int)cudaErrorInvalidValue;
  for (int row0 = 0; row0 < rows; row0 += SIEVE_MAX_ROWS) {
    const dim3 grid(SIEVE_CLUSTER, std::min(SIEVE_MAX_ROWS, rows - row0), P);
    if (fold_max)
      sieve_gain_kernel<true><<<grid, SIEVE_NT, 0, stream>>>(T, seed, dvec, out, r, rows, row0,
                                                             n, n_total, alpha, beta);
    else
      sieve_gain_kernel<false><<<grid, SIEVE_NT, 0, stream>>>(T, seed, dvec, out, r, rows, row0,
                                                              n, n_total, alpha, beta);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// T (r, n), seed (n,) or null, dvec (n,), out (r + [seed given],), all
// float32 and contiguous.
extern "C" int repro_sieve_gain_eval(const float* T, const float* seed, const float* dvec,
                                     float* out, int r, int n, float n_total, int fold_max,
                                     float alpha, float beta, void* stream) {
  return launch(T, seed, dvec, out, 1, r, n, n_total, fold_max, alpha, beta,
                static_cast<cudaStream_t>(stream));
}

// T (P, r, n), seed (n,) or null (shared by every partition), dvec (P, n),
// out (P, r + [seed given]), all float32 and contiguous.
extern "C" int repro_sieve_gain_eval_batched(const float* T, const float* seed, const float* dvec,
                                             float* out, int P, int r, int n, float n_total,
                                             int fold_max, float alpha, float beta,
                                             void* stream) {
  return launch(T, seed, dvec, out, P, r, n, n_total, fold_max, alpha, beta,
                static_cast<cudaStream_t>(stream));
}
