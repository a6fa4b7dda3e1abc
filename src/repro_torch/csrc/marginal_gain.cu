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
//     safe across parallel blocks sharing one buffer): the (candidate tile
//     0, segment s) block writes the rows of segment s. The gate is read
//     from device memory, so the engine's round loop never syncs with the
//     host.
//   * gain_eval_batched / gain_update_eval_batched (`_gain_kernel_batched`,
//     `_gain_update_kernel_batched`): the same two functions for B
//     independent requests in one launch. The TPU grid (B, m_tiles,
//     n_tiles) becomes blockIdx.z = request, blockIdx.y = segment of n,
//     blockIdx.x = candidate tile;
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
// n = m = 8 192), on this SIMT path by the fp32 FMA rate. The design (see
// tile.cuh): a block owns BC candidates and spb consecutive SEG = 256-row
// segments of n (grid: candidate tiles x ceil(n_segs / spb) x B), keeps its
// candidates staged feature-major for its whole life, streams V past them
// in double-buffered 128 x 16 chunks, and holds an 8 x RC register tile fed
// by 128-bit shared loads; the (n, m) distance matrix never exists. It
// writes one partial sum per segment; seg_sum_kernel adds them in segment
// order and divides by n_total, in the same C call (one launch in
// ops.LAUNCHES).
//
// Sizing. RC = 8 (BC = 128 candidates a block) where the staged candidates
// fit the 227 KB budget (d <= ~400 at fp32), else RC = 2 (BC = 32, d up to
// ~1 700); both give every column the same bits (the reduction over n does
// not depend on the tile width). SEG = 256 is the largest multiple of the
// 128-row tile that gives CELF's m = 256 re-score at n = 50 000 at least two
// blocks per SM: 2 candidate tiles x ceil(50 000 / 256) = 196 segments =
// 392 blocks on 132 SMs (2.97 per SM; SEG = 384 would give 131 segments, 262
// blocks, 1.98 per SM); that launch keeps one segment a block. A dense round
// at m = 50 000 walks 8 segments a block (391 x 25 = 9 775 blocks), paying
// for staging its 128 candidates, their norms and the final tree once per
// 16 row tiles: one segment a block ran 23 % longer on the H100
// (tools/kernel_variants.py). Its workspace is 196 x 50 000 fp32 (39 MB), against
// the 20 MB V.
//
// Rows past n are masked in place of the reference's padding sentinels (0
// under min, +inf under max). The reduction over n is one fixed order per
// column (no atomics), so a candidate's gain does not depend on m, on which
// candidates share its block, or on B.
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

// Up to 232 registers (the fp32 8 x 8 tile takes about 200): with ptxas's
// default some fp16_strict instances spill.
template <typename TIn, int P, int RC, bool UPDATE, bool BATCHED>
__global__ void __maxnreg__(232)
gain_kernel(const TIn* __restrict__ V, const TIn* __restrict__ C, const float* __restrict__ cache,
            const TIn* __restrict__ w, const float* __restrict__ w_valid,
            float* __restrict__ part, float* __restrict__ new_cache, int n, int m, int d,
            int n_segs, int spb, float gamma, int fold_max, float alpha, float beta) {
  using St = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  constexpr int BC = TX * RC;
  constexpr int BCP = BC + 4;
  if (BATCHED) {  // request blockIdx.z of a (m tiles, n_segs, B) grid
    const long long b = blockIdx.z;
    V += b * n * d;
    C += b * m * d;
    cache += b * n;
    if (UPDATE) {
      w += b * d;
      w_valid += b;
      new_cache += b * n;
    }
  }
  part += (long long)blockIdx.z * n_segs * m;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<St, A, BC> sm(smem_raw, 1, d, UPDATE);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int j0 = blockIdx.x * BC;
  // segments seg0 .. seg0 + spb - 1: rows [row0, row_end)
  const int seg0 = blockIdx.y * spb;
  const int row0 = seg0 * SEG, row_end = min(n, min(n_segs, seg0 + spb) * SEG);

  stage_cols<P, BC>(sm.cols, sm.cnorm, C, j0, m, 0, 1, d, (long long)d, 0LL);
  A wn = zero_(A());
  bool fold = false;
  if (UPDATE) {
    for (int f = tid; f < d; f += NT) sm.ws[f] = Pol<P>::stage(to_f(w[f]));
    __syncthreads();
    if (tid == 0) {
      A acc = zero_(A());
      for (int f = 0; f < d; ++f) acc = fma_(sm.ws[f], sm.ws[f], acc);
      sm.cnorm[BC] = acc;
    }
    __syncthreads();
    wn = sm.cnorm[BC];
    fold = *w_valid > 0.f;
  }
  const bool writer = UPDATE && blockIdx.x == 0 && tx == 0;
  A cn[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) cn[c] = sm.cnorm[col_of<RC>(tx, c)];

  float colsum[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) colsum[c] = 0.f;

  // steps: (row tile t, feature chunk c), c fastest; the V chunk of step
  // s + 1 is in flight in registers while step s runs its FMAs
  const int n_ch = max(1, (d + DC - 1) / DC);  // d = 0: one empty chunk
  const int steps = (row_end > row0 ? (row_end - row0 + BN - 1) / BN : 0) * n_ch;
  float pre[PRE];
  if (steps > 0) {
    load_chunk(pre, V, row0, row_end, 0, d);
    store_chunk<P>(sm.vbuf, pre);
  }
  __syncthreads();
  A acc[RN][RC], vn[RN], vw[RN];
  float cv[RN];
  for (int s = 0; s < steps; ++s) {
    const int t = s / n_ch, c = s - t * n_ch;
    const int i0 = row0 + t * BN, e0 = c * DC;
    const St* vb = sm.vbuf + (s & 1) * DC * VS;
    if (s + 1 < steps) {
      const int t1 = (s + 1) / n_ch;
      load_chunk(pre, V, row0 + t1 * BN, row_end, (s + 1 - t1 * n_ch) * DC, d);
    }
    if (c == 0) {
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        // the cache rows of this tile, in flight until the epilogue
        const int row = i0 + row_of(ty, r);
        cv[r] = row < row_end ? cache[row] : 0.f;
        vn[r] = zero_(A());
        vw[r] = zero_(A());
#pragma unroll
        for (int q = 0; q < RC; ++q) acc[r][q] = zero_(A());
      }
    }
    const int ne = min(DC, d - e0);
    // row norms (and the winner's Gram column): lane tx takes feature
    // e0 + tx, and lane_sum joins the 16 lanes below
    if (tx < ne) {
      St a[RN];
      load8(a, vb + tx * VS + ty * 4);
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        vn[r] = fma_(a[r], a[r], vn[r]);
        if (UPDATE) vw[r] = fma_(a[r], sm.ws[e0 + tx], vw[r]);
      }
    }
    const St* cb = sm.cols + e0 * BCP;
    if (ne == DC)  // a whole chunk: a compile-time trip count
      gram<DC, RC>(acc, vb + ty * 4, cb, BCP, tx, DC);
    else
      gram<4, RC>(acc, vb + ty * 4, cb, BCP, tx, ne);
    if (c == n_ch - 1) {
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        vn[r] = lane_sum(vn[r]);
        if (UPDATE) vw[r] = lane_sum(vw[r]);
      }
#pragma unroll
      for (int r = 0; r < RN; ++r) {
        const int row = i0 + row_of(ty, r);
        if (row >= row_end) continue;
        float cr = cv[r];
        if (UPDATE) {
          if (fold) {
            const float dw = to_f(dist_(vn[r], wn, vw[r], gamma));
            cr = fold_max ? fmaxf(cr, fmaxf(affine(alpha, beta, dw), 0.f)) : fminf(cr, dw);
          }
          if (writer) new_cache[row] = cr;
        }
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const A d2 = dist_(vn[r], cn[q], acc[r][q], gamma);
          colsum[q] += fold_max ? fmaxf(affine(alpha, beta, d2) - cr, 0.f) : relu_diff(cr, d2);
        }
      }
      if ((i0 + BN) % SEG == 0 || i0 + BN >= row_end)  // the tile ends a segment
        write_partial<RC, BC>(sm.red, colsum, part + (long long)(i0 / SEG) * m, j0, m, tx, ty);
    }
    if (s + 1 < steps) store_chunk<P>(sm.vbuf + ((s + 1) & 1) * DC * VS, pre);
    __syncthreads();
  }
  if (steps == 0)  // n = 0: one empty segment
    write_partial<RC, BC>(sm.red, colsum, part + (long long)seg0 * m, j0, m, tx, ty);
}

// RC = 8 where a block's 128 staged candidates fit, else RC = 2.
template <int P>
static int gain_rc(int d, bool update) {
  return smem_bytes<P, TX * 8>(1, d, update) <= SMEM_LIMIT ? 8 : 2;
}

template <typename TIn, int P, int RC, bool UPDATE, bool BATCHED>
static int launch_rc(const void* V, const void* C, const float* cache, const void* w,
                     const float* w_valid, float* part, float* gains, float* new_cache, int B,
                     int n, int m, int d, float n_total, float gamma, int fold_max, float alpha,
                     float beta, cudaStream_t stream) {
  constexpr int BC = TX * RC;
  const int smem = smem_bytes<P, BC>(1, d, UPDATE);
  const int n_segs = n_segments(n);
  const int m_blocks = m > 0 ? (m + BC - 1) / BC : 1;
  const int spb = segs_per_block((long long)m_blocks * B, n_segs);
  if (smem > SMEM_LIMIT || B < 1 || B > 65535 || n_segs > 65535)
    return (int)cudaErrorInvalidConfiguration;
  auto kern = gain_kernel<TIn, P, RC, UPDATE, BATCHED>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // at m = 0 the fused kernel still runs candidate tile 0, which folds
  const dim3 grid(m_blocks, (n_segs + spb - 1) / spb, B);
  kern<<<grid, NT, smem, stream>>>(static_cast<const TIn*>(V), static_cast<const TIn*>(C), cache,
                                   static_cast<const TIn*>(w), w_valid, part, new_cache, n, m, d,
                                   n_segs, spb, gamma, fold_max, alpha, beta);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_seg_sum(part, gains, B, m, n_segs, n_total, stream);
}

template <typename TIn, int P, bool UPDATE, bool BATCHED>
static int launch(const void* V, const void* C, const float* cache, const void* w,
                  const float* w_valid, float* part, float* gains, float* new_cache, int B, int n,
                  int m, int d, float n_total, float gamma, int fold_max, float alpha, float beta,
                  cudaStream_t stream) {
  if (gain_rc<P>(d, UPDATE) == 8)
    return launch_rc<TIn, P, 8, UPDATE, BATCHED>(V, C, cache, w, w_valid, part, gains, new_cache,
                                                 B, n, m, d, n_total, gamma, fold_max, alpha,
                                                 beta, stream);
  return launch_rc<TIn, P, 2, UPDATE, BATCHED>(V, C, cache, w, w_valid, part, gains, new_cache, B,
                                               n, m, d, n_total, gamma, fold_max, alpha, beta,
                                               stream);
}

template <bool UPDATE, bool BATCHED>
static int dispatch(const void* V, const void* C, const float* cache, const void* w,
                    const float* w_valid, float* part, float* gains, float* new_cache, int B,
                    int n, int m, int d, float n_total, float gamma, int fold_max, float alpha,
                    float beta, int policy, int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(POL, IN, T)                                                                  \
  if (policy == POL && in_dtype == IN)                                                          \
    return launch<T, POL, UPDATE, BATCHED>(V, C, cache, w, w_valid, part, gains, new_cache, B, n, \
                                           m, d, n_total, gamma, fold_max, alpha, beta, st);
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

// Every entry takes `part`, a device workspace of n_segments(n) * m floats
// per request (the per-segment partial sums), and launches the gain kernel
// and its second pass on `stream`.
extern "C" int repro_gain_eval(const void* V, const void* C, const float* cache, float* part,
                               float* gains, int n, int m, int d, float n_total, float gamma,
                               int fold_max, float alpha, float beta, int policy, int in_dtype,
                               void* stream) {
  return dispatch<false, false>(V, C, cache, nullptr, nullptr, part, gains, nullptr, 1, n, m, d,
                                n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

extern "C" int repro_gain_update_eval(const void* V, const void* C, const float* cache,
                                      const void* w, const float* w_valid, float* part,
                                      float* gains, float* new_cache, int n, int m, int d,
                                      float n_total, float gamma, int fold_max, float alpha,
                                      float beta, int policy, int in_dtype, void* stream) {
  return dispatch<true, false>(V, C, cache, w, w_valid, part, gains, new_cache, 1, n, m, d,
                               n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

// V (B, n, d), C (B, m, d), cache (B, n), part (B, n_segs, m), gains (B, m),
// all contiguous.
extern "C" int repro_gain_eval_batched(const void* V, const void* C, const float* cache,
                                       float* part, float* gains, int B, int n, int m, int d,
                                       float n_total, float gamma, int fold_max, float alpha,
                                       float beta, int policy, int in_dtype, void* stream) {
  return dispatch<false, true>(V, C, cache, nullptr, nullptr, part, gains, nullptr, B, n, m, d,
                               n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}

// + w (B, d), w_valid (B,), new_cache (B, n) distinct from cache.
extern "C" int repro_gain_update_eval_batched(const void* V, const void* C, const float* cache,
                                              const void* w, const float* w_valid, float* part,
                                              float* gains, float* new_cache, int B, int n,
                                              int m, int d, float n_total, float gamma,
                                              int fold_max, float alpha, float beta, int policy,
                                              int in_dtype, void* stream) {
  return dispatch<true, true>(V, C, cache, w, w_valid, part, gains, new_cache, B, n, m, d,
                              n_total, gamma, fold_max, alpha, beta, policy, in_dtype, stream);
}
