// Multiset exemplar-clustering evaluation on Hopper (SIMT, sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/exemplar_eval.py:
//   * fused_eval (builders `fused_eval`, bodies `_fused_flat_kernel` and
//     `_fused_loop_kernel`): out[j] = n_total^-1 sum_i min(d(v_i, e0),
//     min_{kk < len_j} d(v_i, S_j[kk])). W never reaches device memory.
//     One kernel serves both layouts: it takes S's strides, so the k-major
//     (k, l, d) "flat" buffer and the (l, k, d) "loop" buffer launch it alike.
//   * two_pass_eval (`_two_pass_kernel`): writes W[j, i] = min-dist / n_total
//     (fp32, 64-bit offsets: l*n passes 2^31 in the paper's sweep); the
//     caller row-sums it.
//
// What bounds it: 2*n*l*k*d FMA operations against n*d + l*k*d input
// elements — compute-bound by a wide margin (paper size: 5e11 FLOP vs
// 40 MB), and on this SIMT path by the fp32 FMA rate (67 TFLOP/s), not by
// the tensor cores. The design keeps the FMA pipes fed from shared memory:
// each block stages its BC sets' vectors once per k-chunk (all k slots at
// once when they fit in the 227 KB budget, so at the paper's shape S is
// read from device memory once per block), streams V through a small
// (64 x 32) staged chunk, and computes a 4 x 2 register tile of cells per
// thread per staged feature. The running min over k, the e0 seed and the
// row sum all stay in registers; the only cross-thread step is one
// fixed-shape tree at the end (deterministic, no atomics).
#include "tile.cuh"

using namespace repro;

template <typename TIn, int P, bool TWO_PASS>
__global__ void __launch_bounds__(NT)
exemplar_kernel(const TIn* __restrict__ V, const TIn* __restrict__ S,
                const int* __restrict__ lengths, const float* __restrict__ d_e0,
                float* __restrict__ out, int n, int l, int k, int d, long long s_set,
                long long s_slot, int kc, float n_total, float gamma) {
  using St = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<St, A> sm(smem_raw, kc, d);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int j0 = blockIdx.x * BC;
  const int sd = d | 1;

  int len[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    const int j = j0 + tx + TX * c;
    len[c] = j < l ? lengths[j] : 0;
  }
  float colsum[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) colsum[c] = 0.f;

  const bool resident = kc >= k;
  if (resident) stage_cols<P>(sm, S, j0, l, 0, k, d, s_set, s_slot);

  for (int i0 = 0; i0 < n; i0 += BN) {
    A minv[RN][RC];
    A vn[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = i0 + ty + TY * r;
      A e;
      from_f(row < n ? d_e0[row] : 0.f, e);
#pragma unroll
      for (int c = 0; c < RC; ++c) minv[r][c] = e;
      vn[r] = zero_(A());
    }
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int kn = min(kc, k - k0);
      if (!resident) {
        __syncthreads();  // earlier readers of the staged columns are done
        stage_cols<P>(sm, S, j0, l, k0, kn, d, s_set, s_slot);
      }
      for (int kk = 0; kk < kn; ++kk) {
        const bool first = (k0 == 0 && kk == 0);
        A acc[RN][RC];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < RC; ++c) acc[r][c] = zero_(A());
        for (int e0 = 0; e0 < d; e0 += DC) {
          __syncthreads();  // earlier readers of the V chunk are done
          stage_v<P>(sm.vchunk, V, i0, e0, n, d);
          __syncthreads();
          const int ne = min(DC, d - e0);
          if (first) {
            // row norms ride the first slot's pass: lane tx takes features
            // tx, tx+TX, ... and lane_sum joins them below
            for (int ee = tx; ee < ne; ee += TX) {
#pragma unroll
              for (int r = 0; r < RN; ++r) {
                const St v = sm.vchunk[(ty + TY * r) * VS + ee];
                vn[r] = fma_(v, v, vn[r]);
              }
            }
          }
          const St* cbase = sm.cols + (kk * BC + tx) * sd + e0;
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
        if (first) {
#pragma unroll
          for (int r = 0; r < RN; ++r) vn[r] = lane_sum(vn[r]);
        }
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          if (k0 + kk < len[c]) {  // invalid slots are masked (the _BIG of the reference)
            const A sn = sm.cnorm[kk * BC + tx + TX * c];
#pragma unroll
            for (int r = 0; r < RN; ++r)
              minv[r][c] = min_(minv[r][c], dist_(vn[r], sn, acc[r][c], gamma));
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = i0 + ty + TY * r;
      if (row >= n) continue;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (TWO_PASS) {
          const int j = j0 + tx + TX * c;
          if (j < l) out[(long long)j * n + row] = to_f(minv[r][c]) / n_total;
        } else {
          colsum[c] += to_f(minv[r][c]);
        }
      }
    }
  }
  if (!TWO_PASS) {
    float total[RC];
    column_tree(sm.red, colsum, tx, ty, total);
    if (ty == 0) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int j = j0 + tx + TX * c;
        if (j < l) out[j] = total[c] / n_total;
      }
    }
  }
}

template <typename TIn, int P, bool TWO_PASS>
static int launch(const void* V, const void* S, const int* lengths, const float* d_e0,
                  float* out, int n, int l, int k, int d, long long s_set, long long s_slot,
                  int kc, float n_total, float gamma, cudaStream_t stream) {
  const int smem = smem_bytes<P>(kc, d);
  if (kc < 1 || smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  auto kern = exemplar_kernel<TIn, P, TWO_PASS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (l + BC - 1) / BC;
  kern<<<grid, NT, smem, stream>>>(static_cast<const TIn*>(V), static_cast<const TIn*>(S), lengths,
                                   d_e0, out, n, l, k, d, s_set, s_slot, kc, n_total, gamma);
  return (int)cudaGetLastError();
}

template <bool TWO_PASS>
static int dispatch(const void* V, const void* S, const int* lengths, const float* d_e0,
                    float* out, int n, int l, int k, int d, long long s_set, long long s_slot,
                    int kc, float n_total, float gamma, int policy, int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(POL, IN, T)                                                              \
  if (policy == POL && in_dtype == IN)                                                      \
    return launch<T, POL, TWO_PASS>(V, S, lengths, d_e0, out, n, l, k, d, s_set, s_slot, kc, \
                                     n_total, gamma, st);
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

extern "C" int repro_fused_eval(const void* V, const void* S, const int* lengths,
                                const float* d_e0, float* out, int n, int l, int k, int d,
                                long long s_set, long long s_slot, int kc, float n_total,
                                float gamma, int policy, int in_dtype, void* stream) {
  return dispatch<false>(V, S, lengths, d_e0, out, n, l, k, d, s_set, s_slot, kc, n_total, gamma,
                         policy, in_dtype, stream);
}

extern "C" int repro_two_pass_eval(const void* V, const void* S, const int* lengths,
                                   const float* d_e0, float* W, int n, int l, int k, int d,
                                   long long s_set, long long s_slot, int kc, float n_total,
                                   float gamma, int policy, int in_dtype, void* stream) {
  return dispatch<true>(V, S, lengths, d_e0, W, n, l, k, d, s_set, s_slot, kc, n_total, gamma,
                        policy, in_dtype, stream);
}
