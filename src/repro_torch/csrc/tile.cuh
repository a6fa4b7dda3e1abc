// Shared tile machinery of the exemplar-eval and marginal-gain kernels.
//
// Every kernel of this package is a Gram product with a fused epilogue:
//   d2(v_i, c_j) = max(|v_i|^2 + |c_j|^2 - 2<v_i, c_j>, 0)   [then rbf]
// computed by SIMT FMA over tiles staged in shared memory (no tensor cores:
// the fp32 policy is real fp32, never TF32).
//
// Fixed split of n. The n rows are cut into segments of SEG = 256 rows;
// n_segs = max(1, ceil(n / SEG)) is a function of n alone. A block owns BC
// columns (sets or candidates) and spb consecutive segments (grid: column
// tiles, ceil(n_segs / spb), requests; segs_per_block below). For each of
// its segments it sums each column over the segment's rows in one fixed
// order and writes an fp32 partial into a workspace (requests, n_segs,
// columns); seg_sum_kernel then sums each column's partials in segment
// order 0..n_segs-1 and divides by n_total once. spb changes which block
// computes a segment, never how. No atomics anywhere: a
// column's value depends on n and its own inputs only, never on how many
// columns were launched beside it, which of them share its block, or B.
//
// Block layout: NT = 256 threads as TY x TX = 16 x 16. Thread (tx, ty) owns
// RN = 8 rows of a BN = 128-row tile: ty*4 + q and 64 + ty*4 + q (q < 4),
// and RC columns: with RC = 8, tx*4 + q and BC/2 + tx*4 + q; with RC = 2,
// tx*2 + q. The staged V chunk and the staged columns are feature-major
// (vbuf[f][row], cols[slot][f][col], row strides VS = BN + 4 and
// BCP = BC + 4 elements), so for one feature a thread reads its 8 rows with
// two 128-bit shared loads (two 64-bit ones at fp16_strict) and its columns
// with one or two more: at RC = 8, 4 loads per 64 FMAs. Within a warp the row loads touch two
// addresses (broadcast) and the column loads 16 contiguous vectors, so
// neither conflicts; the +4 pads keep 16-byte alignment and spread the
// row-norm pass (16 lanes on 16 feature rows) over distinct banks.
//
// Staging overlaps the FMAs by register prefetch: the V chunk of the next
// step (BN rows x DC = 16 features, 8 elements a thread) is loaded from
// device memory into registers before the FMAs of the current step, then
// rounded by Pol<P>::stage and stored into the other half of a double
// buffer; one barrier per step. Register staging rather than cp.async or
// TMA because the payload must be rounded to the policy's dtype exactly as
// the Pallas tile rounds it, the input may be fp32, bf16 or fp16 at any d
// (rows of 45 or 129 floats are not 16-byte aligned), and the chunk is
// small against the step's FMAs (8 loads against 16 features x RN x RC
// FMAs a thread).
//
// Precision policies (P): 0 fp32, 1 bf16, 2 fp16, 3 fp16_strict. Payload
// elements are rounded to the policy's compute dtype as they are staged
// (__float2bfloat16_rn / __float2half_rn), exactly as the Pallas kernels
// round inside the tile. P 0-2 keep the rounded value as a float (exact) and
// accumulate in fp32; P 3 stores __half and accumulates with __hfma: each
// cell's Gram term by one FMA per feature in feature order, each row norm
// (and the update kernel's winner column) by 16 lanes, lane t over features
// t, t+16, ..., joined by an xor butterfly (exemplar_eval._lane_sum16 and
// _strict_dist follow this order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;   // 256 threads
constexpr int RN = 8;         // rows per thread
constexpr int BN = TY * RN;   // 128 rows of V per tile
constexpr int DC = 16;        // features of V staged per step (= TX: lane t
                              // of the norm pass takes feature t of a step)
constexpr int VS = BN + 4;    // row stride of the staged V chunk
constexpr int SEG = 256;      // rows per segment: 2 tiles
constexpr int SMEM_LIMIT = 232448;  // Hopper: 227 KB opt-in per block

static_assert(SEG % BN == 0, "a segment is whole row tiles");
static_assert(DC == TX, "the row-norm pass gives each lane one feature a step");

__host__ __device__ constexpr int n_segments(int n) { return n > SEG ? (n + SEG - 1) / SEG : 1; }

// Segments per block: a block walks spb consecutive segments with its
// columns staged once, and writes one partial per segment (the same bits as
// one block per segment). spb is the largest of 8, 4, 2, 1 that still
// launches MIN_BLOCKS blocks, so a narrow launch (CELF's m = 256) keeps one
// segment per block while a wide one pays its per-block staging once per
// 8 segments.
constexpr int MAX_SPB = 8;
constexpr long long MIN_BLOCKS = 1024;
inline int segs_per_block(long long col_blocks, int n_segs) {
  int spb = MAX_SPB;
  while (spb > 1 && col_blocks * ((n_segs + spb - 1) / spb) < MIN_BLOCKS) spb >>= 1;
  return spb;
}

template <int P> struct Pol;
template <> struct Pol<0> {
  using S = float; using A = float;
  __device__ static S stage(float x) { return x; }
};
template <> struct Pol<1> {
  using S = float; using A = float;
  __device__ static S stage(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};
template <> struct Pol<2> {
  using S = float; using A = float;
  __device__ static S stage(float x) { return __half2float(__float2half_rn(x)); }
};
template <> struct Pol<3> {
  using S = __half; using A = __half;
  __device__ static S stage(float x) { return __float2half_rn(x); }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void from_f(float x, float& y) { y = x; }
__device__ __forceinline__ void from_f(float x, __half& y) { y = __float2half_rn(x); }

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ __half fma_(__half a, __half b, __half c) { return __hfma(a, b, c); }

__device__ __forceinline__ float zero_(float) { return 0.f; }
__device__ __forceinline__ __half zero_(__half) { return __float2half_rn(0.f); }

__device__ __forceinline__ float min_(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ __half min_(__half a, __half b) { return __hmin(a, b); }

__device__ __forceinline__ float shfl_xor_(float x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}
__device__ __forceinline__ __half shfl_xor_(__half x, int m) {
  return __shfl_xor_sync(0xffffffffu, x, m);
}

__device__ __forceinline__ float add_(float a, float b) { return a + b; }
__device__ __forceinline__ __half add_(__half a, __half b) { return __hadd(a, b); }

// Sum over the TX lanes that share a row (tid = ty*TX + tx, so they are 16
// neighbouring lanes of one warp): a fixed xor butterfly; every lane ends
// with the same bits.
template <typename A>
__device__ __forceinline__ A lane_sum(A x) {
#pragma unroll
  for (int m = TX / 2; m > 0; m >>= 1) x = add_(x, shfl_xor_(x, m));
  return x;
}

// Squared distance from norms and Gram term, clamped at 0, then the rbf
// transform 2(1 - exp(-gamma d2)) when gamma >= 0. Same operation order as
// the Pallas _dist_tile: (vn + sn) - 2g.
__device__ __forceinline__ float dist_(float vn, float sn, float g, float gamma) {
  float d2 = fmaxf(__fsub_rn(__fadd_rn(vn, sn), __fmul_rn(2.f, g)), 0.f);
  if (gamma >= 0.f) d2 = 2.f * (1.f - expf(-gamma * d2));
  return d2;
}
__device__ __forceinline__ __half dist_(__half vn, __half sn, __half g, float gamma) {
  const __half two = __float2half_rn(2.f);
  __half d2 = __hmax(__hsub(__hadd(vn, sn), __hmul(two, g)), __float2half_rn(0.f));
  if (gamma >= 0.f) {
    // each step rounds to fp16, as fp16 array arithmetic does
    __half t = __hmul(__float2half_rn(-gamma), d2);
    __half e = __float2half_rn(expf(__half2float(t)));
    d2 = __hmul(two, __hsub(__float2half_rn(1.f), e));
  }
  return d2;
}

__host__ __device__ constexpr int round16(int bytes) { return (bytes + 15) & ~15; }

// Row offset (within a BN tile) of row r of thread row ty, and column
// offset (within a BC tile) of column c of thread column tx.
__device__ __forceinline__ int row_of(int ty, int r) { return (r < 4 ? 0 : BN / 2) + ty * 4 + (r & 3); }
template <int RC>
__device__ __forceinline__ int col_of(int tx, int c) {
  if (RC == 8) return (c < 4 ? 0 : TX * 4) + tx * 4 + (c & 3);
  return tx * RC + c;
}

// Dynamic shared memory of one block with BC columns: kc staged slots of
// the block's columns (feature-major, row stride BC + 4), the winner vector
// (update kernel), the double-buffered V chunk, the column norms (and the
// winner's), and the final cross-TY reduction buffer. ops.smem_bytes
// computes the same sum for the exemplar kernel (BC = 32).
template <int P, int BC>
__host__ __device__ inline int smem_bytes(int kc, int d, bool winner) {
  using S = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  return round16(kc * d * (BC + 4) * (int)sizeof(S)) + round16((winner ? d : 0) * (int)sizeof(S)) +
         round16(2 * DC * VS * (int)sizeof(S)) + round16((kc * BC + 1) * (int)sizeof(A)) +
         TY * BC * (int)sizeof(float);
}

template <typename S, typename A, int BC>
struct Smem {
  static constexpr int BCP = BC + 4;
  S* cols;    // [kc][d][BCP]
  S* ws;      // [d] (update kernel)
  S* vbuf;    // [2][DC][VS]
  A* cnorm;   // [kc*BC] + the winner's at [kc*BC]
  float* red; // [TY][BC]
  __device__ Smem(unsigned char* base, int kc, int d, bool winner) {
    int off = 0;
    cols = reinterpret_cast<S*>(base + off);
    off += round16(kc * d * BCP * (int)sizeof(S));
    ws = reinterpret_cast<S*>(base + off);
    off += round16((winner ? d : 0) * (int)sizeof(S));
    vbuf = reinterpret_cast<S*>(base + off);
    off += round16(2 * DC * VS * (int)sizeof(S));
    cnorm = reinterpret_cast<A*>(base + off);
    off += round16((kc * BC + 1) * (int)sizeof(A));
    red = reinterpret_cast<float*>(base + off);
  }
};

// The V chunk of one step, in flight in registers: element t of thread tid
// is row (tid + NT*t) / DC, feature (tid + NT*t) % DC of the chunk, so a
// warp reads two 64-byte row pieces per load (coalesced for any d).
constexpr int PRE = BN * DC / NT;  // 8
template <typename TIn>
__device__ __forceinline__ void load_chunk(float (&x)[PRE], const TIn* __restrict__ V, int i0,
                                           int row_end, int e0, int d) {
#pragma unroll
  for (int t = 0; t < PRE; ++t) {
    const int idx = threadIdx.x + NT * t;
    const int row = i0 + idx / DC, f = e0 + idx % DC;
    x[t] = (row < row_end && f < d) ? to_f(V[(long long)row * d + f]) : 0.f;
  }
}
template <int P>
__device__ __forceinline__ void store_chunk(typename Pol<P>::S* vb, const float (&x)[PRE]) {
#pragma unroll
  for (int t = 0; t < PRE; ++t) {
    const int idx = threadIdx.x + NT * t;
    vb[(idx % DC) * VS + idx / DC] = Pol<P>::stage(x[t]);
  }
}

// A thread's 8 rows of one staged feature row (two 128-bit loads; two
// 64-bit ones for __half).
__device__ __forceinline__ void load8(float (&a)[8], const float* p) {
  const float4 lo = *reinterpret_cast<const float4*>(p);
  const float4 hi = *reinterpret_cast<const float4*>(p + BN / 2);
  a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
  a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
}
// Four halves of a 64-bit word, by register moves only.
__device__ __forceinline__ void unpack4(__half* a, uint2 v) {
  a[0] = __ushort_as_half(static_cast<unsigned short>(v.x));
  a[1] = __ushort_as_half(static_cast<unsigned short>(v.x >> 16));
  a[2] = __ushort_as_half(static_cast<unsigned short>(v.y));
  a[3] = __ushort_as_half(static_cast<unsigned short>(v.y >> 16));
}
__device__ __forceinline__ void load8(__half (&a)[8], const __half* p) {
  unpack4(a, *reinterpret_cast<const uint2*>(p));
  unpack4(a + 4, *reinterpret_cast<const uint2*>(p + BN / 2));
}
// A thread's RC columns of one staged feature row (p points at the row).
template <int RC, typename S>
__device__ __forceinline__ void load_cols(S (&b)[RC], const S* p, int tx) {
  if constexpr (RC == 8) {
    // same pattern as the rows, with the column tile's halves TX*4 apart
    const S* q = p + tx * 4;
    if constexpr (sizeof(S) == 4) {
      const float4 lo = *reinterpret_cast<const float4*>(q);
      const float4 hi = *reinterpret_cast<const float4*>(q + TX * 4);
      b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
      b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
    } else {
      unpack4(b, *reinterpret_cast<const uint2*>(q));
      unpack4(b + 4, *reinterpret_cast<const uint2*>(q + TX * 4));
    }
  } else {
    static_assert(RC == 2, "column tiles of 8 or 2 per thread");
    const S* q = p + tx * 2;
    if constexpr (sizeof(S) == 4) {
      const float2 v = *reinterpret_cast<const float2*>(q);
      b[0] = v.x; b[1] = v.y;
    } else {
      const __half2 v = *reinterpret_cast<const __half2*>(q);
      b[0] = __low2half(v); b[1] = __high2half(v);
    }
  }
}

// acc[r][q] += row r x column q over features 0..ne-1 of a staged chunk,
// one FMA per feature in feature order (vr: the thread's rows of feature 0;
// cb: the staged columns' feature 0, row stride bcp). UNROLL = DC with
// ne = DC gives the compiler the whole chunk to schedule.
template <int UNROLL, int RC, typename S, typename A>
__device__ __forceinline__ void gram(A (&acc)[RN][RC], const S* vr, const S* cb, int bcp, int tx,
                                     int ne) {
#pragma unroll UNROLL
  for (int ee = 0; ee < ne; ++ee) {
    S a[RN], b[RC];
    load8(a, vr + ee * VS);
    load_cols<RC>(b, cb + ee * bcp, tx);
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < RC; ++q) acc[r][q] = fma_(a[r], b[q], acc[r][q]);
  }
}

// Stage kn slots of the block's BC columns: column cc of slot s is the
// vector at X + (j0+cc)*s_col + (k0+s)*s_slot (contiguous d), zero past
// n_cols; stored feature-major at cols[(s*d + f)*BCP + cc]. Then compute
// every staged vector's squared norm in the accumulation dtype, one FMA per
// feature in feature order. Ends with a barrier.
template <int P, int BC, typename TIn>
__device__ void stage_cols(typename Pol<P>::S* cols, typename Pol<P>::A* cnorm,
                           const TIn* __restrict__ X, int j0, int n_cols, int k0, int kn, int d,
                           long long s_col, long long s_slot) {
  using A = typename Pol<P>::A;
  constexpr int BCP = BC + 4;
  constexpr int U = 16;  // loads in flight per thread before the first store
  const int per_slot = BC * d, total = kn * per_slot;
  for (int base = 0; base < total; base += NT * U) {
    float x[U];
    int at[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = base + u * NT + threadIdx.x;
      const int s = t / per_slot, rem = t - s * per_slot;
      const int cc = rem / d, f = rem - cc * d;
      const int j = j0 + cc;
      at[u] = t < total ? (s * d + f) * BCP + cc : -1;
      x[u] = (t < total && j < n_cols)
                 ? to_f(X[(long long)j * s_col + (long long)(k0 + s) * s_slot + f])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (at[u] >= 0) cols[at[u]] = Pol<P>::stage(x[u]);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kn * BC; t += NT) {
    const int s = t / BC, cc = t % BC;
    const auto* c = cols + s * d * BCP + cc;
    A acc = zero_(A());
#pragma unroll 4
    for (int f = 0; f < d; ++f) {
      const auto x = c[f * BCP];
      acc = fma_(x, x, acc);
    }
    cnorm[t] = acc;
  }
  __syncthreads();
}

// Column sums of `part` (one partial per thread and column, over that
// thread's rows) through a fixed-shape tree over the TY thread rows.
// Returns, on threads with ty == 0, the column totals; ends with a barrier.
template <int RC, int BC>
__device__ __forceinline__ void column_tree(float* red, const float (&part)[RC], int tx, int ty,
                                            float (&total)[RC]) {
#pragma unroll
  for (int c = 0; c < RC; ++c) red[ty * BC + col_of<RC>(tx, c)] = part[c];
  __syncthreads();
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int cc = col_of<RC>(tx, c);
        red[ty * BC + cc] += red[(ty + s) * BC + cc];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) total[c] = red[col_of<RC>(tx, c)];
  __syncthreads();
}

// One segment's partials: the fixed tree over the thread rows, written by
// the ty = 0 threads to part_seg[j] (j < n_cols), then colsum reset.
template <int RC, int BC>
__device__ __forceinline__ void write_partial(float* red, float (&colsum)[RC],
                                              float* __restrict__ part_seg, int j0, int n_cols,
                                              int tx, int ty) {
  float total[RC];
  column_tree<RC, BC>(red, colsum, tx, ty, total);
#pragma unroll
  for (int q = 0; q < RC; ++q) {
    const int j = j0 + col_of<RC>(tx, q);
    if (ty == 0 && j < n_cols) part_seg[j] = total[q];
    colsum[q] = 0.f;
  }
}

// The second pass: out[b, j] = (sum over s = 0..n_segs-1, in that order, of
// part[b, s, j]) / n_total. One thread per column; grid (column blocks, B).
__global__ void __launch_bounds__(256)
seg_sum_kernel(const float* __restrict__ part, float* __restrict__ out, int m, int n_segs,
               float n_total) {
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= m) return;
  const long long b = blockIdx.y;
  const float* p = part + b * n_segs * m + j;
  float acc = 0.f;
  for (int s = 0; s < n_segs; ++s) acc += p[(long long)s * m];
  out[b * m + j] = acc / n_total;
}

inline cudaError_t launch_seg_sum(const float* part, float* out, int B, int m, int n_segs,
                                  float n_total, cudaStream_t stream) {
  if (m <= 0) return cudaSuccess;
  seg_sum_kernel<<<dim3((m + 255) / 256, B), 256, 0, stream>>>(part, out, m, n_segs, n_total);
  return cudaGetLastError();
}

}  // namespace repro

// Input dtype codes shared with the Python wrappers.
enum { IN_F32 = 0, IN_F16 = 1, IN_BF16 = 2 };

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
