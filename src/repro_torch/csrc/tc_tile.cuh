// Tensor-core tile machinery of the exemplar-eval and marginal-gain kernels
// at the bf16 and fp16 policies (P = 1, 2), for sm_90a. The fp32 and
// fp16_strict policies (P = 0, 3) keep the SIMT tile of tile.cuh.
//
// What it computes is what the SIMT tile computes: the Gram term <v_i, c_j>
// of d2 = max(|v_i|^2 + |c_j|^2 - 2<v_i, c_j>, 0) over the payload rounded
// to the compute dtype, products in that dtype and sums in fp32, here as
// warpgroup MMAs (wgmma.mma_async m64nNk16, fp32 accumulators in
// registers), as the Pallas kernels run their _dist_tile on the MXU. The
// row and column norms stay SIMT fp32 FMA from the rounded payload, in the
// order of tile.cuh (a column: feature order; a row: 16 lanes over features
// t, t + 16, ..., joined by lane_sum). The row norms (and the update
// kernel's fold of the winner into the cache) come from a row pass launched
// first in the same C call, once for every column tile; the epilogue reads
// the accumulator fragments in registers: nothing of (n, m) reaches device
// memory but two_pass_eval's W.
//
// Block: NT = 256 threads = two warpgroups. A row tile is TM = 64 rows of V
// (one wgmma M), shared by both warpgroups; warpgroup g multiplies it
// against its own columns (N of them). V streams through a ring of two
// TM x KC chunks in the 128-byte swizzle (v_off; KC = 64 features for the
// gain kernel, 128 for the exemplar-eval kernel); the block's columns stay
// staged as 8 x 8 core matrices (8 rows x 16 bytes, each row's 8 features
// contiguous), no swizzle: the K-adjacent core matrix LBO = 128 bytes on,
// the next 8 columns SBO bytes on. Both operands are K-major 16-bit values.
// d is padded to kpad(d), a multiple of KSTEP = 16, with zeros, which add
// nothing to a sum.
//
// Staging. Every element is rounded to the compute dtype once
// (Half<P>::bits: __float2bfloat16_rn / __float2half_rn, as the SIMT tile
// rounds), so an fp32 input and the same values already in the compute
// dtype give the same bits. The block's columns are staged once (or once
// per k chunk) through registers. V is rounded by the row pass into a
// zero-padded 16-bit copy with 16-byte aligned rows, whatever d or the
// input's alignment, and every column tile streams that copy into its
// chunks by cp.async two steps ahead (VStream); a generic-proxy write
// precedes fence.proxy.async and the step's barrier before wgmma reads it.
//
// Fixed split of n, as tile.cuh: a segment is SEG / TM = 4 row tiles. A
// thread sums its column's rows of the segment in one order (tile by tile,
// its row r0, then r0 + 8), an xor butterfly joins the 8 lanes that share
// the column, and one thread adds the 4 warps' sums in warp order into the
// (segment, column) partial. That order does not depend on the column's
// place in the block, on m, l or B; the MMA computes each output element
// from its own row and column alone. No atomics.
#pragma once

#include <cstdint>

#include "tile.cuh"

namespace repro {
namespace tc {

constexpr int WGT = 128;       // threads of a warpgroup
constexpr int TM = 64;         // V rows per tile: one wgmma M
constexpr int KCH = 64;        // features of a 128-byte swizzle row (a chunk has 1 or 2)
constexpr int KSTEP = 16;      // features per wgmma (32 bytes of 16-bit values)
constexpr int CORE = 64;       // elements of a core matrix (8 rows x 8)
constexpr int LBO = 128;       // bytes to the K-adjacent core matrix

static_assert(NT == 2 * WGT, "a block is two warpgroups");
static_assert(SEG % TM == 0, "a segment is whole row tiles");

__host__ __device__ constexpr int kpad(int d) {
  return d > 0 ? (d + KSTEP - 1) / KSTEP * KSTEP : KSTEP;
}
// k slots staged (or multiplied) for kc wanted: 1, 2, or a multiple of 4.
__host__ __device__ constexpr int slot_cap(int kc) { return kc <= 2 ? kc : (kc + 3) & ~3; }

// Dynamic shared memory of one block with V chunks of kc features: the V
// ring (3 x TM x kc, 16-bit), `ncols` staged columns (kpad(d) 16-bit
// elements each), their norms, and the reduction buffer (4 warps' sums of
// `oc` output columns a block). ops.smem_bytes computes the same sum.
__host__ __device__ inline int smem_bytes(int ncols, int oc, int d, int kc) {
  return 3 * TM * kc * 2 + round16(ncols * kpad(d) * 2) + round16(ncols * 4) + 4 * oc * 4;
}

struct Smem {
  uint16_t* vbuf;  // [3][TM x kc], 128-byte swizzle (1024-byte aligned)
  uint16_t* cols;  // staged columns, core matrices
  float* cnorm;    // [ncols]
  float* red;      // [2 warpgroups][4 warps][oc / 2]
  __device__ Smem(unsigned char* base, int ncols, int d, int kc) {
    // the swizzle is on the address bits: the chunks start 1024-aligned
    if (static_cast<uint32_t>(__cvta_generic_to_shared(base)) % 1024 != 0) __trap();
    int off = 0;
    vbuf = reinterpret_cast<uint16_t*>(base + off);
    off += 3 * TM * kc * 2;
    cols = reinterpret_cast<uint16_t*>(base + off);
    off += round16(ncols * kpad(d) * 2);
    cnorm = reinterpret_cast<float*>(base + off);
    off += round16(ncols * 4);
    red = reinterpret_cast<float*>(base + off);
  }
};

// The compute dtype's bits of an input element: an fp32 value rounded to
// nearest, a value already in the compute dtype as it is.
template <int P> struct Half;
template <> struct Half<1> {
  __device__ static uint16_t bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
  __device__ static uint16_t bits(uint16_t x) { return x; }
  __device__ static float value(uint16_t b) { return __bfloat162float(__ushort_as_bfloat16(b)); }
};
template <> struct Half<2> {
  __device__ static uint16_t bits(float x) { return __half_as_ushort(__float2half_rn(x)); }
  __device__ static uint16_t bits(uint16_t x) { return x; }
  __device__ static float value(uint16_t b) { return __half2float(__ushort_as_half(b)); }
};
// Registers an input element is loaded into: fp32, or the 16 bits as they are.
template <typename TIn> struct Raw { using T = uint16_t; };
template <> struct Raw<float> { using T = float; };

template <typename TIn>
__device__ __forceinline__ typename Raw<TIn>::T load_raw(const TIn* p) {
  return *reinterpret_cast<const typename Raw<TIn>::T*>(p);
}

template <int P>
__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = uint32_t(Half<P>::bits(x[2 * i])) | (uint32_t(Half<P>::bits(x[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}
template <int P>
__device__ __forceinline__ uint4 pack8(const uint16_t (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = uint32_t(x[2 * i]) | (uint32_t(x[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor: start address, LBO, SBO (all >> 4), no
// swizzle (layout type 0 in bits 62-63).
__device__ __forceinline__ uint64_t desc(const uint16_t* p, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a >> 4) & 0x3FFF) | (uint64_t((LBO >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Generic-proxy shared-memory writes made visible to wgmma (the async proxy).
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to the accumulators across the
// asynchronous MMAs that own them.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define REPRO_WGMMA(N, TY, REGS, NA, NB, NP, ...)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" #NP ", 0;\n"                              \
               "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32." TY "." TY " {" REGS         \
               "}, %" #NA ", %" #NB ", p, 1, 1, 0, 0;\n}\n"                                   \
               : __VA_ARGS__                                                                 \
               : "l"(a), "l"(b), "r"(acc))
#define REPRO_ACC4(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define REPRO_ACC16(o) REPRO_ACC4(o), REPRO_ACC4(o + 4), REPRO_ACC4(o + 8), REPRO_ACC4(o + 12)
#define REPRO_R0H "%0, %1, %2, %3, %4, %5, %6, %7"
#define REPRO_R0 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define REPRO_R1 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define REPRO_R2 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
#define REPRO_R3 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define REPRO_R4 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
#define REPRO_R5 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// d[0 .. N/2) += (or, acc = 0, =) A (64 x 16, descriptor a) x B^T (N x 16,
// descriptor b); thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// (+ 8) and columns 8 i + 2 (t % 4) (+ 1): d[4i + 2h + e] = (row + 8h,
// column 8i + 2(t % 4) + e).
template <int P, int N> __device__ __forceinline__ void mma(float* d, uint64_t a, uint64_t b, int acc);
#define REPRO_MMA_SPECS(P, TY)                                                                  \
  template <> __device__ __forceinline__ void mma<P, 16>(float* d, uint64_t a, uint64_t b,     \
                                                         int acc) {                             \
    REPRO_WGMMA(16, TY, REPRO_R0H, 8, 9, 10, REPRO_ACC4(0), REPRO_ACC4(4));                     \
  }                                                                                             \
  template <> __device__ __forceinline__ void mma<P, 32>(float* d, uint64_t a, uint64_t b,     \
                                                         int acc) {                             \
    REPRO_WGMMA(32, TY, REPRO_R0, 16, 17, 18, REPRO_ACC16(0));                                  \
  }                                                                                             \
  template <> __device__ __forceinline__ void mma<P, 64>(float* d, uint64_t a, uint64_t b,     \
                                                         int acc) {                             \
    REPRO_WGMMA(64, TY, REPRO_R0 ", " REPRO_R1, 32, 33, 34, REPRO_ACC16(0), REPRO_ACC16(16));   \
  }                                                                                             \
  template <> __device__ __forceinline__ void mma<P, 128>(float* d, uint64_t a, uint64_t b,    \
                                                          int acc) {                            \
    REPRO_WGMMA(128, TY, REPRO_R0 ", " REPRO_R1 ", " REPRO_R2 ", " REPRO_R3, 64, 65, 66,        \
                REPRO_ACC16(0), REPRO_ACC16(16), REPRO_ACC16(32), REPRO_ACC16(48));             \
  }                                                                                             \
  template <> __device__ __forceinline__ void mma<P, 192>(float* d, uint64_t a, uint64_t b,    \
                                                          int acc) {                            \
    REPRO_WGMMA(192, TY,                                                                        \
                REPRO_R0 ", " REPRO_R1 ", " REPRO_R2 ", " REPRO_R3 ", " REPRO_R4 ", " REPRO_R5, \
                96, 97, 98, REPRO_ACC16(0), REPRO_ACC16(16), REPRO_ACC16(32), REPRO_ACC16(48),  \
                REPRO_ACC16(64), REPRO_ACC16(80));                                              \
  }
REPRO_MMA_SPECS(1, "bf16")
REPRO_MMA_SPECS(2, "f16")
#undef REPRO_MMA_SPECS
#undef REPRO_WGMMA
#undef REPRO_ACC16
#undef REPRO_ACC4
#undef REPRO_R0H
#undef REPRO_R0
#undef REPRO_R1
#undef REPRO_R2
#undef REPRO_R3
#undef REPRO_R4
#undef REPRO_R5

// ---------------------------------------------------------------------------
// the staged columns
// ---------------------------------------------------------------------------

// Element offset of 8-feature unit kg of staged column c (core matrices of
// 8 columns: SBO = kpad(d) * 16 bytes between them).
__device__ __forceinline__ int col_off(int c, int kg, int kp8) {
  return ((c >> 3) * kp8 + kg) * CORE + (c & 7) * 8;
}

// Stage ncols columns, column c the d contiguous elements at src(c) (zero
// where src(c) is null, and past d), rounded to the compute dtype; then
// every column's squared norm, fp32 FMA in feature order (tile.cuh
// stage_cols). Neighbouring threads read neighbouring units of a column
// (coalesced). Ends with the async-proxy fence and a barrier.
template <int P, typename TIn, typename Src>
__device__ void stage_cols(uint16_t* cols, float* cnorm, int ncols, int d, Src src) {
  constexpr int FLIGHT = 4;  // units in flight a thread before the first store
  const int kp8 = kpad(d) / 8, units = ncols * kp8;
  for (int base = threadIdx.x; base < units; base += NT * FLIGHT) {
    typename Raw<TIn>::T v[FLIGHT][8];
#pragma unroll
    for (int k = 0; k < FLIGHT; ++k) {
      const int u = base + k * NT, kg = u % kp8;
      const TIn* x = u < units ? src(u / kp8) : nullptr;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[k][e] = (x != nullptr && kg * 8 + e < d) ? load_raw(x + kg * 8 + e)
                                                   : typename Raw<TIn>::T(0);
    }
#pragma unroll
    for (int k = 0; k < FLIGHT; ++k) {
      const int u = base + k * NT;
      if (u < units)
        *reinterpret_cast<uint4*>(cols + col_off(u / kp8, u % kp8, kp8)) = pack8<P>(v[k]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < ncols; c += NT) {
    float acc = 0.f;
    for (int f = 0; f < d; ++f) {
      const float x = Half<P>::value(cols[col_off(c, f >> 3, kp8) + (f & 7)]);
      acc = fmaf(x, x, acc);
    }
    cnorm[c] = acc;
  }
  fence_async();
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the V stream
// ---------------------------------------------------------------------------

// A TM x KC chunk of V (KC = 64 or 128 16-bit features) is KC / 64
// columns of 64 rows of 128 bytes, in the 128-byte swizzle of wgmma and
// TMA: 8-feature unit kg of row r of a column sits at r * 128 + ((kg ^
// (r % 8)) * 16) bytes, 8-row groups SBO_V = 1024 bytes apart. A row's
// eight units fall in eight distinct bank groups, so each 16-byte copy of
// a row lands without conflicts. The chunk buffers are 1024-byte aligned.
__device__ __forceinline__ int v_off(int row, int f) {
  return (f >> 6) * TM * KCH + row * KCH + ((((f >> 3) ^ row) & 7) << 3) + (f & 7);
}
constexpr int SBO_V = 8 * KCH * 2;
static_assert(KCH * 2 == 128, "a chunk row is one 128-byte swizzle row");

// K-major, 128-byte swizzle (layout type 1): start address, SBO; LBO is not
// read. K step kk of a chunk starts in swizzle column kk / 4, 32 bytes a
// step along the row; the hardware applies the swizzle to the address bits.
__device__ __forceinline__ uint64_t desc_sw128(const uint16_t* chunk, int kk) {
  const uint16_t* p = chunk + (kk >> 2) * TM * KCH + (kk & 3) * KSTEP;
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return uint64_t((a >> 4) & 0x3FFF) | (uint64_t(1) << 16) | (uint64_t(SBO_V >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The V stream of a block: step s copies rows [i0, i0 + TM) x features
// [e0, e0 + KC) (pos(s, i0, e0)) of the row pass's rounded copy vr (rows of
// kp 16-bit values, 16-byte aligned) into chunk buffer buf(s) of a ring of
// three, by cp.async two steps ahead: 16 bytes (8 features) a copy,
// neighbouring threads along a row (coalesced), rows past n zero-filled
// (source size 0). At the top of step s a thread waits for its own copies
// of step s; fence_async and the step's barrier publish them to wgmma. The
// copies of step s + 2 go into the buffer step s - 1's MMAs read, which
// every warpgroup waited for before that barrier.
template <int KC>
struct VStream {
  const uint16_t* vr;
  int kp, row_end, steps;
  uint16_t* vbuf;

  static constexpr int WPR = KC / 8;            // 16-byte copies a chunk row
  static constexpr int N = TM * WPR / NT;        // copies a thread: 2 or 4

  __device__ uint16_t* buf(int s) const { return vbuf + (s % 3) * TM * KC; }

  // Copies of step s (one commit group, empty past the last step).
  template <typename Pos>
  __device__ void issue(int s, Pos pos) const {
    if (s < steps) {
      int i0, e0;
      pos(s, i0, e0);
      uint16_t* b = buf(s);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int w = threadIdx.x + NT * i, row = w / WPR, f = (w % WPR) * 8;
        if (e0 + f >= kp) continue;  // past kpad(d): no K step reads it
        const bool ok = i0 + row < row_end;
        cp_async16(b + v_off(row, f), ok ? vr + (long long)(i0 + row) * kp + e0 + f : vr,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }
  // Before the loop: steps 0 and 1 in flight.
  template <typename Pos>
  __device__ void begin(Pos pos) const {
    issue(0, pos);
    issue(1, pos);
  }
  // Top of step s: this thread's copies of step s have landed (step s + 1's
  // may be in flight).
  __device__ void arrive() const { cp_async_wait<1>(); }
};

// The row pass of a launch, before the tensor-core kernel, one 16-lane
// group a row of request b = blockIdx.y: lane t takes features t, t + 16,
// ..., rounds each to the compute dtype (Half<P>::bits) and writes the
// rounded row, zero-padded to kp = kpad(d), into vr[(b n + i) kp ...], the
// copy the scoring kernel streams; and sums the squares in tile.cuh's order
// (one fp32 FMA a feature, then lane_sum) into rows[b n + i]. With UPDATE
// it also folds the request's winner w into its cache, gated by *w_valid:
// <v_i, w> in the same lane order, then min(c, d) or max(c, relu(alpha +
// beta d)) into new_cache, which the scoring reads. One row pass serves
// every column tile: each block of the scoring kernel reads its tile's
// norms and folded cache once. Block: 16 rows of 16 lanes.
template <typename TIn, int P, bool UPDATE>
__global__ void __launch_bounds__(NT)
row_pass_kernel(const TIn* __restrict__ V, const float* __restrict__ cache,
                const TIn* __restrict__ w, const float* __restrict__ w_valid,
                float* __restrict__ rows, uint16_t* __restrict__ vr,
                float* __restrict__ new_cache, int n, int d, int kp, float gamma, int fold_max,
                float alpha, float beta) {
  const long long b = blockIdx.y;
  V += b * n * d;
  rows += b * n;
  vr += b * n * kp;
  extern __shared__ float ws[];  // the rounded winner (UPDATE)
  float wn = 0.f;
  if (UPDATE) {
    cache += b * n;
    new_cache += b * n;
    w += b * d;
    for (int f = threadIdx.x; f < d; f += NT) ws[f] = Half<P>::value(Half<P>::bits(load_raw(w + f)));
    __syncthreads();
    for (int f = 0; f < d; ++f) wn = fmaf(ws[f], ws[f], wn);  // feature order
  }
  const int row = blockIdx.x * (NT / DC) + threadIdx.x / DC, t = threadIdx.x % DC;
  float vn = 0.f, vw = 0.f;
  if (row < n) {
    for (int f = t; f < kp; f += DC) {
      const uint16_t h = f < d ? Half<P>::bits(load_raw(V + (long long)row * d + f)) : 0;
      vr[(long long)row * kp + f] = h;
      if (f >= d) continue;
      const float x = Half<P>::value(h);
      vn = fmaf(x, x, vn);
      if (UPDATE) vw = fmaf(x, ws[f], vw);
    }
  }
  vn = lane_sum(vn);
  if (UPDATE) vw = lane_sum(vw);
  if (t != 0 || row >= n) return;
  rows[row] = vn;
  if (UPDATE) {
    float c = cache[row];
    if (w_valid[b] > 0.f) {
      const float dw = dist_(vn, wn, vw, gamma);
      c = fold_max ? fmaxf(c, fmaxf(__fadd_rn(alpha, __fmul_rn(beta, dw)), 0.f)) : fminf(c, dw);
    }
    new_cache[row] = c;
  }
}

template <typename TIn, int P, bool UPDATE>
inline cudaError_t launch_row_pass(const TIn* V, const float* cache, const TIn* w,
                                   const float* w_valid, float* rows, uint16_t* vr,
                                   float* new_cache, int B, int n, int d, float gamma,
                                   int fold_max, float alpha, float beta, cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int smem = UPDATE ? d * 4 : 0;
  auto kern = row_pass_kernel<TIn, P, UPDATE>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((n + NT / DC - 1) / (NT / DC), B), NT, smem, stream>>>(
      V, cache, w, w_valid, rows, vr, new_cache, n, d, kpad(d), gamma, fold_max, alpha, beta);
  return cudaGetLastError();
}

// The row pass's part of a launch's workspace, after `head` floats: B n
// row norms, then (16-byte aligned) B n kpad(d) rounded 16-bit values.
// ops.tc_rows_workspace mirrors it.
struct RowSpace {
  float* rows;
  uint16_t* vr;
  RowSpace(float* part, long long head, int B, int n) {
    rows = part + head;
    vr = reinterpret_cast<uint16_t*>(part + ((head + (long long)B * n + 3) & ~3LL));
  }
};

// Squared distance from norms and Gram term (tile.cuh dist_), rbf when RBF.
template <bool RBF>
__device__ __forceinline__ float dist(float vn, float sn, float g, float gamma) {
  float d2 = fmaxf(__fsub_rn(__fadd_rn(vn, sn), __fmul_rn(2.f, g)), 0.f);
  if (RBF) d2 = 2.f * (1.f - expf(-gamma * d2));
  return d2;
}

// One segment's partials. colsum[j] is column 8 (j / 2) + 2 q + j % 2 of the
// warpgroup's columns (q = lane % 4); the butterfly over lanes xor 4, 8, 16
// joins the lanes that hold it, lanes 0-3 write the warp's sums, and thread
// c < oc adds its column's 4 warps in warp order into part_seg[j0 + c]
// (c < n_cols). Ends with colsum reset; red is next written after at least
// one more barrier.
template <int NC>
__device__ __forceinline__ void write_partial(float* red, float (&colsum)[NC], int oc,
                                              float* __restrict__ part_seg, int j0, int n_cols) {
  const int g = threadIdx.x / WGT, w = (threadIdx.x % WGT) / 32, lane = threadIdx.x % 32;
  const int half = oc / 2;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    float x = colsum[j];
    x += __shfl_xor_sync(0xffffffffu, x, 4);
    x += __shfl_xor_sync(0xffffffffu, x, 8);
    x += __shfl_xor_sync(0xffffffffu, x, 16);
    if (lane < 4) red[(g * 4 + w) * half + 8 * (j >> 1) + 2 * lane + (j & 1)] = x;
    colsum[j] = 0.f;
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < oc && j0 + c < n_cols) {
    const float* r = red + (c / half) * 4 * half + c % half;
    part_seg[j0 + c] = ((r[0] + r[half]) + r[2 * half]) + r[3 * half];
  }
}

}  // namespace tc
}  // namespace repro
