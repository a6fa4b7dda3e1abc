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
// the tensor cores. The design (see tile.cuh): a block owns BC = 32 sets
// and spb consecutive SEG = 256-row segments of n (grid: set tiles x
// ceil(n_segs / spb)). It stages
// its sets' k slots once, feature-major (all k slots when they fit the
// 227 KB budget: ops.kernel_config picks k_chunk from what is left, else
// k_chunk slots per chunk and row tile), and streams V past them in
// double-buffered 128 x 16 chunks. Each thread holds 8 rows x 2 sets x 2
// slots = 32 cells: a pair of slots shares one pass over the V chunk, so V
// is staged ceil(k/2) times per row tile, and per feature a thread issues
// 2 128-bit row loads and 2 64-bit column loads for 32 FMAs. The running
// min over k, the e0 seed and the row sum stay in registers; fused_eval
// writes one fp32 partial per (segment, set), and seg_sum_kernel adds them
// in segment order and divides by n_total (one C call, one launch in
// ops.LAUNCHES). two_pass_eval writes W directly: its segments only add
// blocks. No atomics: a set's value does not depend on l or its block.
//
// Sizing at the paper's shape (n = 50 000, l = 5 000, k = 10, d = 100,
// fp32): 157 set tiles x 196 segments; 157 x 25 = 3 925 blocks of 8
// segments (tile.cuh segs_per_block) of 164 240 bytes of shared memory, one
// block per SM: 29.7 waves of 132, so the partial last wave leaves 0.9 % of
// the card's block slots idle. A block stages its 320 vectors (128 KB) once
// for its 8 segments: one segment a block ran 17 % longer on the H100
// (tools/kernel_variants.py).
#include "tile.cuh"

using namespace repro;

constexpr int ERC = 2;          // sets per thread
constexpr int EBC = TX * ERC;   // 32 sets per block
constexpr int G = 2;            // k slots per pass over a V chunk

// acc[r][c][q] += row r x set c's slot q (q = 0 at c0, 1 at c1) over
// features 0..ne-1 of a staged chunk, one FMA per feature in feature order.
template <int UNROLL, typename S, typename A>
__device__ __forceinline__ void gram_pair(A (&acc)[RN][ERC][G], const S* vr, const S* c0,
                                          const S* c1, int tx, int ne) {
  constexpr int BCP = EBC + 4;
#pragma unroll UNROLL
  for (int ee = 0; ee < ne; ++ee) {
    S a[RN], b0[ERC], b1[ERC];
    load8(a, vr + ee * VS);
    load_cols<ERC>(b0, c0 + ee * BCP, tx);
    load_cols<ERC>(b1, c1 + ee * BCP, tx);
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int c = 0; c < ERC; ++c) {
        acc[r][c][0] = fma_(a[r], b0[c], acc[r][c][0]);
        acc[r][c][1] = fma_(a[r], b1[c], acc[r][c][1]);
      }
  }
}

// 192 registers: ptxas's own choice (128) spills the slot-pair tile; one
// block per SM leaves the register file to it anyway.
template <typename TIn, int P, bool TWO_PASS>
__global__ void __maxnreg__(192)
exemplar_kernel(const TIn* __restrict__ V, const TIn* __restrict__ S,
                const int* __restrict__ lengths, const float* __restrict__ d_e0,
                float* __restrict__ out, float* __restrict__ part, int n, int l, int k, int d,
                long long s_set, long long s_slot, int kc, int n_segs, int spb, float n_total,
                float gamma) {
  using St = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  constexpr int BCP = EBC + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<St, A, EBC> sm(smem_raw, kc, d, false);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int j0 = blockIdx.x * EBC;
  // segments seg0 .. seg0 + spb - 1: rows [row0, row_end)
  const int seg0 = blockIdx.y * spb;
  const int row0 = seg0 * SEG, row_end = min(n, min(n_segs, seg0 + spb) * SEG);

  int len[ERC];
#pragma unroll
  for (int c = 0; c < ERC; ++c) {
    const int j = j0 + col_of<ERC>(tx, c);
    len[c] = j < l ? lengths[j] : 0;
  }
  float colsum[ERC];
#pragma unroll
  for (int c = 0; c < ERC; ++c) colsum[c] = 0.f;

  const bool resident = kc >= k;
  if (resident) stage_cols<P, EBC>(sm.cols, sm.cnorm, S, j0, l, 0, k, d, s_set, s_slot);

  // steps: (row tile, k chunk, slot pair, feature chunk), the feature chunk
  // fastest; the V chunk of the next step is in flight in registers while
  // this one runs its FMAs
  const int n_ch = max(1, (d + DC - 1) / DC);  // d = 0: one empty chunk
  const int n_tiles = row_end > row0 ? (row_end - row0 + BN - 1) / BN : 0;
  float pre[PRE];
  if (n_tiles > 0) {
    load_chunk(pre, V, row0, row_end, 0, d);
    store_chunk<P>(sm.vbuf, pre);
  }
  __syncthreads();
  int buf = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int i0 = row0 + t * BN;
    A minv[RN][ERC], vn[RN];
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = i0 + row_of(ty, r);
      A e;
      from_f(row < row_end ? d_e0[row] : 0.f, e);
#pragma unroll
      for (int c = 0; c < ERC; ++c) minv[r][c] = e;
      vn[r] = zero_(A());
    }
    for (int k0 = 0; k0 < k; k0 += kc) {
      const int kn = min(kc, k - k0);
      // earlier readers of the staged columns passed the last step's barrier
      if (!resident) stage_cols<P, EBC>(sm.cols, sm.cnorm, S, j0, l, k0, kn, d, s_set, s_slot);
      for (int g0 = 0; g0 < kn; g0 += G) {
        const bool first = (k0 == 0 && g0 == 0);
        const bool last_pair = k0 + kn >= k && g0 + G >= kn;
        const int s1 = min(g0 + 1, kn - 1);  // odd kn: the pair's second slot repeats the first
        A acc[RN][ERC][G];
#pragma unroll
        for (int r = 0; r < RN; ++r)
#pragma unroll
          for (int c = 0; c < ERC; ++c)
#pragma unroll
            for (int q = 0; q < G; ++q) acc[r][c][q] = zero_(A());
        for (int ch = 0; ch < n_ch; ++ch) {
          const int e0 = ch * DC;
          const bool last_ch = ch == n_ch - 1;
          const bool has_next = !(last_ch && last_pair && t == n_tiles - 1);
          if (has_next) {
            const int nt = last_ch && last_pair ? t + 1 : t;
            load_chunk(pre, V, row0 + nt * BN, row_end, last_ch ? 0 : e0 + DC, d);
          }
          const St* vb = sm.vbuf + buf * DC * VS;
          const int ne = min(DC, d - e0);
          if (first && tx < ne) {
            // row norms ride the first slot pair's pass: lane tx takes
            // feature e0 + tx, and lane_sum joins the 16 lanes below
            St a[RN];
            load8(a, vb + tx * VS + ty * 4);
#pragma unroll
            for (int r = 0; r < RN; ++r) vn[r] = fma_(a[r], a[r], vn[r]);
          }
          const St* c0 = sm.cols + (g0 * d + e0) * BCP;
          const St* c1 = sm.cols + (s1 * d + e0) * BCP;
          if (ne == DC)  // a whole chunk: a compile-time trip count
            gram_pair<DC>(acc, vb + ty * 4, c0, c1, tx, DC);
          else
            gram_pair<4>(acc, vb + ty * 4, c0, c1, tx, ne);
          if (has_next) store_chunk<P>(sm.vbuf + (buf ^ 1) * DC * VS, pre);
          __syncthreads();
          buf ^= 1;
        }
        if (first) {
#pragma unroll
          for (int r = 0; r < RN; ++r) vn[r] = lane_sum(vn[r]);
        }
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const int kk = g0 + q;
          if (kk >= kn) continue;
#pragma unroll
          for (int c = 0; c < ERC; ++c) {
            if (k0 + kk < len[c]) {  // invalid slots are masked (the _BIG of the reference)
              const A sn = sm.cnorm[kk * EBC + col_of<ERC>(tx, c)];
#pragma unroll
              for (int r = 0; r < RN; ++r)
                minv[r][c] = min_(minv[r][c], dist_(vn[r], sn, acc[r][c][q], gamma));
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int row = i0 + row_of(ty, r);
      if (row >= row_end) continue;
#pragma unroll
      for (int c = 0; c < ERC; ++c) {
        if (TWO_PASS) {
          const int j = j0 + col_of<ERC>(tx, c);
          if (j < l) out[(long long)j * n + row] = to_f(minv[r][c]) / n_total;
        } else {
          colsum[c] += to_f(minv[r][c]);
        }
      }
    }
    if (!TWO_PASS && ((i0 + BN) % SEG == 0 || i0 + BN >= row_end))  // the tile ends a segment
      write_partial<ERC, EBC>(sm.red, colsum, part + (long long)(i0 / SEG) * l, j0, l, tx, ty);
  }
  if (!TWO_PASS && n_tiles == 0)  // n = 0: one empty segment
    write_partial<ERC, EBC>(sm.red, colsum, part + (long long)seg0 * l, j0, l, tx, ty);
}

template <typename TIn, int P, bool TWO_PASS>
static int launch(const void* V, const void* S, const int* lengths, const float* d_e0,
                  float* out, float* part, int n, int l, int k, int d, long long s_set,
                  long long s_slot, int kc, float n_total, float gamma, cudaStream_t stream) {
  const int smem = smem_bytes<P, EBC>(kc, d, false);
  const int n_segs = n_segments(n);
  const int l_blocks = (l + EBC - 1) / EBC;
  const int spb = segs_per_block(l_blocks, n_segs);
  if (kc < 1 || smem > SMEM_LIMIT || n_segs > 65535) return (int)cudaErrorInvalidConfiguration;
  auto kern = exemplar_kernel<TIn, P, TWO_PASS>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(l_blocks, (n_segs + spb - 1) / spb);
  kern<<<grid, NT, smem, stream>>>(static_cast<const TIn*>(V), static_cast<const TIn*>(S), lengths,
                                   d_e0, out, part, n, l, k, d, s_set, s_slot, kc, n_segs, spb,
                                   n_total, gamma);
  err = cudaGetLastError();
  if (err != cudaSuccess || TWO_PASS) return (int)err;
  return (int)launch_seg_sum(part, out, 1, l, n_segs, n_total, stream);
}

template <bool TWO_PASS>
static int dispatch(const void* V, const void* S, const int* lengths, const float* d_e0,
                    float* out, float* part, int n, int l, int k, int d, long long s_set,
                    long long s_slot, int kc, float n_total, float gamma, int policy,
                    int in_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CASE(POL, IN, T)                                                                  \
  if (policy == POL && in_dtype == IN)                                                          \
    return launch<T, POL, TWO_PASS>(V, S, lengths, d_e0, out, part, n, l, k, d, s_set, s_slot, \
                                     kc, n_total, gamma, st);
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

// `part` is a device workspace of n_segments(n) * l floats (fused_eval's
// per-segment partial sums); two_pass_eval takes none (pass 0).
extern "C" int repro_fused_eval(const void* V, const void* S, const int* lengths,
                                const float* d_e0, float* out, float* part, int n, int l, int k,
                                int d, long long s_set, long long s_slot, int kc, float n_total,
                                float gamma, int policy, int in_dtype, void* stream) {
  return dispatch<false>(V, S, lengths, d_e0, out, part, n, l, k, d, s_set, s_slot, kc, n_total,
                         gamma, policy, in_dtype, stream);
}

extern "C" int repro_two_pass_eval(const void* V, const void* S, const int* lengths,
                                   const float* d_e0, float* W, float* part, int n, int l, int k,
                                   int d, long long s_set, long long s_slot, int kc,
                                   float n_total, float gamma, int policy, int in_dtype,
                                   void* stream) {
  return dispatch<true>(V, S, lengths, d_e0, W, part, n, l, k, d, s_set, s_slot, kc, n_total,
                        gamma, policy, in_dtype, stream);
}
