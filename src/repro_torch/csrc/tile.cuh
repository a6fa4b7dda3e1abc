// Shared tile machinery of the exemplar-eval and marginal-gain kernels.
//
// Every kernel of this package is a Gram product with a fused epilogue:
//   d2(v_i, c_j) = max(|v_i|^2 + |c_j|^2 - 2<v_i, c_j>, 0)   [then rbf]
// computed by SIMT FMA over tiles staged in shared memory (no tensor cores:
// the fp32 policy is real fp32, never TF32).
//
// Block layout: NT = 256 threads as TY x TX = 16 x 16. Thread (tx, ty) owns
// RN = 4 rows (ty + TY*r) of V and RC = 2 columns (tx + TX*c), so one block
// covers a BN x BC = 64 x 32 tile of (row, column) cells. Columns are the
// block's own sets (exemplar eval) or candidates (gains); the block keeps
// them for its whole life and loops over ALL n rows itself. That loop takes
// the place of the TPU's sequential n grid axis, and every reduction over n
// runs in one fixed order inside the block (no split-n atomics), so results
// are deterministic from run to run and a column's value does not depend on
// which other columns share its block.
//
// Precision policies (P): 0 fp32, 1 bf16, 2 fp16, 3 fp16_strict. Payload
// elements are rounded to the policy's compute dtype as they are staged
// (__float2bfloat16_rn / __float2half_rn), exactly as the Pallas kernels
// round inside the tile. P 0-2 keep the rounded value as a float (exact) and
// accumulate in fp32; P 3 stores __half and accumulates with __hfma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int TX = 16;
constexpr int TY = 16;
constexpr int RN = 4;
constexpr int RC = 2;
constexpr int NT = TX * TY;   // 256 threads
constexpr int BN = TY * RN;   // 64 rows of V per tile
constexpr int BC = TX * RC;   // 32 columns per block
constexpr int DC = 32;        // features of V staged per step
constexpr int VS = DC + 1;    // padded row stride of the staged V chunk
constexpr int SMEM_LIMIT = 232448;  // Hopper: 227 KB opt-in per block

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

// Dynamic shared memory of one block: the staged columns (kc slots of BC
// vectors, row stride sd = d|1 so that neighbouring columns fall in
// different banks), the staged V chunk, the column norms and the final
// cross-TY reduction buffer. ops.kernel_config computes the same sum.
template <int P>
__host__ __device__ inline int smem_bytes(int kc, int d) {
  using S = typename Pol<P>::S;
  using A = typename Pol<P>::A;
  const int sd = d | 1;
  return round16(kc * BC * sd * (int)sizeof(S)) + round16(BN * VS * (int)sizeof(S)) +
         round16(kc * BC * (int)sizeof(A)) + TY * BC * (int)sizeof(float);
}

template <typename S, typename A>
struct Smem {
  S* cols;    // [kc][BC][sd]
  S* vchunk;  // [BN][VS]
  A* cnorm;   // [kc][BC]
  float* red; // [TY][BC]
  __device__ Smem(unsigned char* base, int kc, int d) {
    const int sd = d | 1;
    int off = 0;
    cols = reinterpret_cast<S*>(base + off);
    off += round16(kc * BC * sd * (int)sizeof(S));
    vchunk = reinterpret_cast<S*>(base + off);
    off += round16(BN * VS * (int)sizeof(S));
    cnorm = reinterpret_cast<A*>(base + off);
    off += round16(kc * BC * (int)sizeof(A));
    red = reinterpret_cast<float*>(base + off);
  }
};

// Stage V rows [i0, i0+BN) x features [e0, e0+DC) into sm.vchunk, rounded
// to the compute dtype; rows past n and features past d are zero.
template <int P, typename TIn>
__device__ __forceinline__ void stage_v(typename Pol<P>::S* vchunk, const TIn* __restrict__ V,
                                        int i0, int e0, int n, int d) {
  for (int t = threadIdx.x; t < BN * DC; t += NT) {
    const int rr = t / DC, ee = t % DC;
    const int row = i0 + rr, f = e0 + ee;
    const float x = (row < n && f < d) ? to_f(V[(long long)row * d + f]) : 0.f;
    vchunk[rr * VS + ee] = Pol<P>::stage(x);
  }
}

// Stage kn slots of the block's BC columns: column cc of slot s is the
// vector at X + (j0+cc)*s_col + (k0+s)*s_slot (contiguous d), zero past
// n_cols. Then compute every staged vector's squared norm in the
// accumulation dtype. Ends with a barrier.
template <int P, typename TIn>
__device__ void stage_cols(const Smem<typename Pol<P>::S, typename Pol<P>::A>& sm,
                           const TIn* __restrict__ X, int j0, int n_cols, int k0, int kn,
                           int d, long long s_col, long long s_slot) {
  using A = typename Pol<P>::A;
  const int sd = d | 1;
  const int per_slot = BC * d;
  for (int t = threadIdx.x; t < kn * per_slot; t += NT) {
    const int s = t / per_slot, rem = t % per_slot;
    const int cc = rem / d, f = rem % d;
    const int j = j0 + cc;
    const float x = j < n_cols ? to_f(X[(long long)j * s_col + (long long)(k0 + s) * s_slot + f]) : 0.f;
    sm.cols[(s * BC + cc) * sd + f] = Pol<P>::stage(x);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < kn * BC; t += NT) {
    A acc = zero_(A());
    for (int f = 0; f < d; ++f) {
      const auto x = sm.cols[t * sd + f];
      acc = fma_(x, x, acc);
    }
    sm.cnorm[t] = acc;
  }
  __syncthreads();
}

// Column sums of `part` (one partial per thread and column, over that
// thread's rows) through a fixed-shape tree over the TY thread rows.
// Returns, on threads with ty == 0, the column totals; ends with a barrier.
__device__ __forceinline__ void column_tree(float* red, const float (&part)[RC], int tx, int ty,
                                            float (&total)[RC]) {
#pragma unroll
  for (int c = 0; c < RC; ++c) red[ty * BC + tx + TX * c] = part[c];
  __syncthreads();
  for (int s = TY / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int c = 0; c < RC; ++c) red[ty * BC + tx + TX * c] += red[(ty + s) * BC + tx + TX * c];
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < RC; ++c) total[c] = red[tx + TX * c];
  __syncthreads();
}

}  // namespace repro

// Input dtype codes shared with the Python wrappers.
enum { IN_F32 = 0, IN_F16 = 1, IN_BF16 = 2 };

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
