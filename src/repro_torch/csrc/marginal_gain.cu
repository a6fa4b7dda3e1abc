// Optimizer-aware greedy marginal gains on Hopper (SIMT, sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/marginal_gain.py:
//   * gain_eval (`_gain_kernel`): gains[j] = n_total^-1 sum_i
//       relu(cache_i - d_ij)                 (fold = min, exemplar)
//       relu((alpha + beta d_ij) - cache_i)  (fold = max, similarity caches)
//   * gain_update_eval (`_gain_update_kernel`): first folds the previous
//     winner w into the cache, gated by *w_valid (min: c <- min(c, d_iw);
//     max: c <- max(c, relu(alpha + beta d_iw))), writes the new cache, then
//     scores every candidate against the folded cache. Every block
//     recomputes d(v_i, w) for its own scoring; only the blocks of
//     candidate tile 0 write the new cache, into a buffer distinct from the
//     input (the Pallas kernel's "idempotent" write from every m tile is not
//     safe across parallel blocks sharing one buffer). The gate is read from
//     device memory, so the engine's round loop never syncs with the host.
//   * gain_eval_batched / gain_update_eval_batched (`_gain_kernel_batched`,
//     `_gain_update_kernel_batched`): the same two functions for B
//     independent requests in one launch. The TPU grid (B, m_tiles,
//     n_tiles) becomes blockIdx.y = request, blockIdx.x = candidate tile;
//     each block moves every operand to its request's slice (offsets in 64
//     bits: b*n*d passes 2^31 at B = 64, n = 50 000, d = 1 024) and then runs
//     the unbatched body unchanged, so a request's gains and cache are bit
//     for bit those of its own unbatched launch. Each request reads its own
//     winner and its own w_valid, and only its candidate tile 0 writes its
//     folded cache. The offsets are a template switch (BATCHED), so the
//     unbatched kernels compile as they did without a batch axis.
//
// What bounds it: 2*n*m*d FMA operations against (n + m)*d inputs —
// compute-bound (a dense round at the paper's n = m = 50 000, d = 100 is
// 5e11 FLOP; a batched round is B such products, 8.6e11 FLOP at B = 64,
// n = m = 8 192), on this SIMT path by the fp32 FMA rate. Each block keeps its
// 32 candidate vectors staged in shared memory for its whole life, streams
// V through a 64 x 32 staged chunk, and holds a 4 x 2 register tile; the
// (n, m) distance matrix never exists. Rows past n are masked in place of
// the reference's padding sentinels (0 under min, +inf under max). The
// reduction over n is one fixed order per column (no atomics), so a
// candidate's gain does not depend on which candidates share its block.
#include "tile.cuh"

using namespace repro;

__device__ __forceinline__ float relu_diff(float c, float d2) { return fmaxf(c - d2, 0.f); }
__device__ __forceinline__ float relu_diff(float c, __half d2) {
  // the relu runs in the distance dtype (the reference's _score_tile)
  return __half2float(__hmax(__hsub(__float2half_rn(c), d2), __float2half_rn(0.f)));
}
__device__ __forceinline__ float affine(float alpha, float beta, float d2) {
  return __fadd_rn(alpha, __fmul_rn(beta, d2));
}
__device__ __forceinline__ float affine(float alpha, float beta, __half d2) {
  return __half2float(__hadd(__float2half_rn(alpha), __hmul(__float2half_rn(beta), d2)));
}

template <typename TIn, int P, bool UPDATE, bool BATCHED>
__global__ void __launch_bounds__(NT)
gain_kernel(const TIn* __restrict__ V, const TIn* __restrict__ C, const float* __restrict__ cache,
            const TIn* __restrict__ w, const float* __restrict__ w_valid,
            float* __restrict__ gains, float* __restrict__ new_cache, int n, int m, int d,
            float n_total, float gamma, int fold_max, float alpha, float beta) {
  using St = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  if (BATCHED) {  // request blockIdx.y of a (m tiles, B) grid
    const long long b = blockIdx.y;
    V += b * n * d;
    C += b * m * d;
    cache += b * n;
    gains += b * m;
    if (UPDATE) {
      w += b * d;
      w_valid += b;
      new_cache += b * n;
    }
  }
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<St, A> sm(smem_raw, UPDATE ? 2 : 1, d);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int j0 = blockIdx.x * BC;
  const int sd = d | 1;

  stage_cols<P>(sm, C, j0, m, 0, 1, d, (long long)d, 0LL);
  // the winner sits in slot 1 of the staged columns, its norm beside it
  St* ws = sm.cols + BC * sd;
  A wn = zero_(A());
  bool fold = false;
  if (UPDATE) {
    for (int f = tid; f < d; f += NT) ws[f] = Pol<P>::stage(to_f(w[f]));
    __syncthreads();
    if (tid == 0) {
      A acc = zero_(A());
      for (int f = 0; f < d; ++f) acc = fma_(ws[f], ws[f], acc);
      sm.cnorm[BC] = acc;
    }
    __syncthreads();
    wn = sm.cnorm[BC];
    fold = *w_valid > 0.f;
  }
  const bool writer = UPDATE && blockIdx.x == 0 && tx == 0;

  float colsum[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) colsum[c] = 0.f;

  for (int i0 = 0; i0 < n; i0 += BN) {
    A acc[RN][RC], vn[RN], vw[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      vn[r] = zero_(A());
      vw[r] = zero_(A());
#pragma unroll
      for (int c = 0; c < RC; ++c) acc[r][c] = zero_(A());
    }
    for (int e0 = 0; e0 < d; e0 += DC) {
      __syncthreads();  // earlier readers of the V chunk are done
      stage_v<P>(sm.vchunk, V, i0, e0, n, d);
      __syncthreads();
      const int ne = min(DC, d - e0);
      // row norms (and the winner's Gram column) split over the TX lanes
      for (int ee = tx; ee < ne; ee += TX) {
#pragma unroll
        for (int r = 0; r < RN; ++r) {
          const St v = sm.vchunk[(ty + TY * r) * VS + ee];
          vn[r] = fma_(v, v, vn[r]);
          if (UPDATE) vw[r] = fma_(v, ws[e0 + ee], vw[r]);
        }
      }
      const St* cbase = sm.cols + tx * sd + e0;
      for (int ee = 0; ee < ne; ++ee) {
        St a[RN], b[RC];
#pragma unroll
        for (int r = 0; r < RN; ++r) a[r] = sm.vchunk[(ty + TY * r) * VS + ee];
#pragma unroll
        for (int c = 0; c < RC; ++c) b[c] = cbase[TX * c * sd + ee];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < RC; ++c) acc[r][c] = fma_(a[r], b[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      vn[r] = lane_sum(vn[r]);
      if (UPDATE) vw[r] = lane_sum(vw[r]);
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = i0 + ty + TY * r;
      if (row >= n) continue;
      float cv = cache[row];
      if (UPDATE) {
        if (fold) {
          const float dw = to_f(dist_(vn[r], wn, vw[r], gamma));
          cv = fold_max ? fmaxf(cv, fmaxf(affine(alpha, beta, dw), 0.f)) : fminf(cv, dw);
        }
        if (writer) new_cache[row] = cv;
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const A d2 = dist_(vn[r], sm.cnorm[tx + TX * c], acc[r][c], gamma);
        colsum[c] += fold_max ? fmaxf(affine(alpha, beta, d2) - cv, 0.f) : relu_diff(cv, d2);
      }
    }
  }
  float total[RC];
  column_tree(sm.red, colsum, tx, ty, total);
  if (ty == 0) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int j = j0 + tx + TX * c;
      if (j < m) gains[j] = total[c] / n_total;
    }
  }
}

template <typename TIn, int P, bool UPDATE, bool BATCHED>
static int launch(const void* V, const void* C, const float* cache, const void* w,
                  const float* w_valid, float* gains, float* new_cache, int B, int n, int m,
                  int d, float n_total, float gamma, int fold_max, float alpha, float beta,
                  cudaStream_t stream) {
  const int smem = smem_bytes<P>(UPDATE ? 2 : 1, d);
  if (smem > SMEM_LIMIT || B < 1 || B > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = gain_kernel<TIn, P, UPDATE, BATCHED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // at m = 0 the fused kernel still runs candidate tile 0, which folds
  const dim3 grid(m > 0 ? (m + BC - 1) / BC : 1, B);
  kern<<<grid, NT, smem, stream>>>(static_cast<const TIn*>(V), static_cast<const TIn*>(C), cache,
                                   static_cast<const TIn*>(w), w_valid, gains, new_cache, n, m, d,
                                   n_total, gamma, fold_max, alpha, beta);
  return (int)cudaGetLastError();
}

template <bool UPDATE, bool BATCHED>
static int dispatch(const void* V, const void* C, const float* cache, const void* w,
                    const float* w_valid, float* gains, float* new_cache, int B, int n, int m,
                    int d, float n_total, float gamma, int fold_max, float alpha, float beta,
                    int policy, int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(POL, IN, T)                                                               \
  if (policy == POL && in_dtype == IN)                                                       \
    return launch<T, POL, UPDATE, BATCHED>(V, C, cache, w, w_valid, gains, new_cache, B, n, m, \
                                           d, n_total, gamma, fold_max, alpha, beta, st);
  REPRO_CASE(0, IN_F32, float)
  REPRO_CASE(1, IN_F32, float)
  REPRO_CASE(1, IN_BF16, __nv_bfloat16)
  REPRO_CASE(2, IN_F32, float)
  REPRO_CASE(2, IN_F16, __half)
  REPRO_CASE(3, IN_F32, float)
  REPRO_CASE(3, IN_F16, __half)
#undef REPRO_CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_gain_eval(const void* V, const void* C, const float* cache, float* gains,
                               int n, int m, int d, float n_total, float gamma, int fold_max,
                               float alpha, float beta, int policy, int in_dtype, void* stream) {
  return dispatch<false, false>(V, C, cache, nullptr, nullptr, gains, nullptr, 1, n, m, d,
                                n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

extern "C" int repro_gain_update_eval(const void* V, const void* C, const float* cache,
                                      const void* w, const float* w_valid, float* gains,
                                      float* new_cache, int n, int m, int d, float n_total,
                                      float gamma, int fold_max, float alpha, float beta,
                                      int policy, int in_dtype, void* stream) {
  return dispatch<true, false>(V, C, cache, w, w_valid, gains, new_cache, 1, n, m, d, n_total,
                               gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

// V (B, n, d), C (B, m, d), cache (B, n), gains (B, m), all contiguous.
extern "C" int repro_gain_eval_batched(const void* V, const void* C, const float* cache,
                                       float* gains, int B, int n, int m, int d, float n_total,
                                       float gamma, int fold_max, float alpha, float beta,
                                       int policy, int in_dtype, void* stream) {
  return dispatch<false, true>(V, C, cache, nullptr, nullptr, gains, nullptr, B, n, m, d,
                               n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

// + w (B, d), w_valid (B,), new_cache (B, n) distinct from cache.
extern "C" int repro_gain_update_eval_batched(const void* V, const void* C, const float* cache,
                                              const void* w, const float* w_valid, float* gains,
                                              float* new_cache, int B, int n, int m, int d,
                                              float n_total, float gamma, int fold_max,
                                              float alpha, float beta, int policy,
                                              int in_dtype, void* stream) {
  return dispatch<true, true>(V, C, cache, w, w_valid, gains, new_cache, B, n, m, d, n_total,
                              gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}
