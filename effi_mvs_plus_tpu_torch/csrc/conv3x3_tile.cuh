// The building block of K2 (conv_gru.cu) and K4 (conv_chain.cu): a 3x3
// convolution over a channels-last tile with a halo, staged in shared
// memory, accumulated in fp32, with the epilogue left to the kernel.
//
// Layout.  A tile holds one row of `pixel_stride<T>(C)` elements a pixel,
// pixels in row-major order, so a tap (dy, dx) is a constant offset and
// the im2col of the convolution is implicit.  The stride pads a pixel
// to an odd number of 16-byte units: eight neighbouring pixels' 16-byte
// rows then fall in eight distinct bank groups, which makes `ldmatrix`
// (bf16) and the 16-byte loads of the fp32 route free of bank conflicts.
//
// Staging.  `stage` copies a tile with `cp.async` 16-byte copies, with
// src-size 0 for pixels outside the image, so the convolution's zero
// padding costs no branch in the math (3-channel inputs, 12 or 6 bytes a
// pixel, are copied element by element with a zeroed fourth channel).
// Weights are packed once by the wrapper (ops/conv_pack.py) into units,
// taps or tap pairs, in the order below, and streamed a stage of 1, 3 or
// 9 units at a time (`units_per_stage`) into a double buffer with
// `cp.async`, so the next stage's copy overlaps this stage's math.
//
// Two routes, chosen by the type the kernel is instantiated for:
//
// * bf16, on the tensor cores (`mma_stage`): mma.sync m16n8k16, bf16 in,
//   fp32 accumulators.  An A fragment is 16 pixels of the tile (rows) by
//   16 input channels (k), loaded by `ldmatrix.x4` from one row address a
//   lane: lanes 0-15 give pixels 0-15 at k 0-7, lanes 16-31 the same
//   pixels at k 8-15 (or, for 8-channel layers, the next tap: two taps
//   of 8 channels make one k16 step, 9 taps padded to 10 with zero
//   weights).  The B fragments are packed in register order,
//   [k-step][n-tile][lane][b0, b1], each b a bf16 pair (k, k + 1) of one
//   output channel n: lane l holds n = l / 4, k = 2 (l % 4) (+8 for b1),
//   so a warp reads its fragment as one conflict-free 8-byte load a lane.
//   A warp owns whole m16 tiles across every output channel, so each
//   A fragment feeds N / 8 products and each B fragment the warp's
//   IPT m-tiles.
// * fp32, on the CUDA cores, true fp32 (no TF32) (`fma_tap`): a thread
//   owns NP pixels x NC output channels.  It reads 4 input channels of a
//   pixel as one 16-byte load (each feeds 4 x NC FMAs) and 4 output
//   channels of one input channel's weight row as one 16-byte broadcast
//   load from shared memory (each feeds 4 x NP FMAs, NP = 4).  Stage
//   weights are [input channel, padded to 4][output channel] fp32.  The
//   bf16 kernels take this route too for layers with fewer than 8 input
//   or output channels (K4's 3-channel first layers and 3-4-4 chain),
//   which are bound by bytes: they read bf16 pixels and widen them.
//
// Shared-memory budgets (227 KB a block; T = element size):
//   K2, 8x16 output tile: [h, x] on 12x20 pixels at stride(2hd), r*h on
//   10x18 at stride(hd), two weight stages of 1-3 taps of (2hd x hd):
//   fp32 34/65/96 + 14/26/37 + 12/16/37 KB at hd 16/32/48 (3/2/1 blocks
//   an SM of 4/4/12 warps); bf16 17/31/50 + 8/14/20 + 6/8/18 KB (blocks
//   of 4 warps, 2 or more an SM).
//   K4: the input with an L-pixel halo, each intermediate with its
//   shrinking halo, two weight stages.  16x32 tiles up to 16 channels,
//   16x16 at 32 (bf16: 16x32) and 64: the 64-channel chain takes 109 + 88
//   + 32 KB in fp32 (one block of 8 warps) and 58 + 47 + 16 KB in bf16;
//   the first layer's halo recompute is 27% at 16x16, 20% at 16x32.
//   Chains of up to 8 channels take blocks of 4 warps, the rest 8.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace conv3x3 {

using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool kMma = std::is_same<T, bf16>::value;

// Elements between neighbouring pixels of a tile of c channels (c padded
// to 4 first): an odd number of 16-byte units where a pixel is 16 bytes
// or more.
template <typename T>
__host__ __device__ constexpr int pixel_stride(int c) {
  const int cp = (c + 3) / 4 * 4;
  const int bytes = cp * (int)sizeof(T);
  if (bytes % 16) return cp;
  return (bytes / 16) % 2 ? cp : cp + 16 / (int)sizeof(T);
}

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Weight units (taps, or tap pairs) a pipeline stage carries: a layer of
// `units` units of `bytes` each goes whole when it is small (4.5 KB),
// else three taps at a time up to 6 KB, else one: few stages (barriers)
// for the small layers, little shared memory for the large ones.
__host__ __device__ constexpr int units_per_stage(int units, int bytes) {
  return units * bytes <= 4608 ? units : (units == 9 && 3 * bytes <= 6144 ? 3 : 1);
}

// ---- conversions ----
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// 4 consecutive channels in one store (16 bytes in fp32, 8 in bf16)
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                            *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---- asynchronous copies ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared; 16 zero bytes where !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes (a multiple of 16) from global to shared, by the whole block
template <int NT>
__device__ __forceinline__ void copy_async(void* dst, const void* src, int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += NT)
    cp_async16(static_cast<char*>(dst) + 16 * i, static_cast<const char*>(src) + 16 * i, true);
}

// Stage channels [0, C) of the pixels (gy0 + y, gx0 + x), y < RH, x < RW,
// of image b of g (B, H, W, C) into s[(y * RW + x) * S + c], zeros outside
// the image.  By cp.async where a pixel is a whole number of 16-byte units
// (the caller commits and waits), else element by element with channels
// [C, round_up(C, 4)) zeroed.
template <typename T, int C, int S, int NT>
__device__ __forceinline__ void stage(T* s, const T* __restrict__ g, int b, int gy0, int gx0,
                                      int RH, int RW, int H, int W) {
  constexpr int E = 16 / (int)sizeof(T);
  if constexpr (C % E == 0) {
    constexpr int CH = C / E;                       // 16-byte chunks a pixel
    for (int i = threadIdx.x; i < RH * RW * CH; i += NT) {
      const int p = i / CH, k = i - p * CH;
      const int y = p / RW, x = p - y * RW;
      const int gy = gy0 + y, gx = gx0 + x;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const T* src = in ? g + ((long long)(b * H + gy) * W + gx) * C + k * E : g;
      cp_async16(s + p * S + k * E, src, in);
    }
  } else {
    constexpr int CP = (C + 3) / 4 * 4;
    for (int i = threadIdx.x; i < RH * RW * CP; i += NT) {
      const int p = i / CP, c = i - p * CP;
      const int y = p / RW, x = p - y * RW;
      const int gy = gy0 + y, gx = gx0 + x;
      float v = 0.0f;
      if (c < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = to_f(g[((long long)(b * H + gy) * W + gx) * C + c]);
      s[p * S + c] = from_f<T>(v);
    }
  }
}

// ---- fp32 route: CUDA cores ----
// acc[i][p][j] += sum_{c < CI} in[off[i][p] + c] * w[c * CO + co[i] + j]
// `in` points at the tap's first element (tile + tap offset + channel
// offset); w is one stage, [round_up(CI, 4)][CO] fp32 in shared memory.
template <typename T, int CI, int CO, int IPT, int NP, int NC>
__device__ __forceinline__ void fma_tap(float (&acc)[IPT][NP][NC], const T* in,
                                        const int (&off)[IPT][NP], const int (&co)[IPT],
                                        const float* w) {
  static_assert(NC % 4 == 0, "output channels a thread: a multiple of 4");
  constexpr int CI4 = (CI + 3) / 4 * 4;
#pragma unroll 1
  for (int c = 0; c < CI4; c += 4) {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      float4 a[NP];
#pragma unroll
      for (int p = 0; p < NP; ++p) a[p] = load4(in + off[i][p] + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        if (CI % 4 && c + cc >= CI) break;          // the padded channels
        float wv[NC];
#pragma unroll
        for (int k = 0; k < NC / 4; ++k) {
          const float4 q = load4(w + (c + cc) * CO + co[i] + 4 * k);
          wv[4 * k] = q.x; wv[4 * k + 1] = q.y; wv[4 * k + 2] = q.z; wv[4 * k + 3] = q.w;
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float v = comp(a[p], cc);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][p][j] = fmaf(v, wv[j], acc[i][p][j]);
        }
      }
    }
  }
}

// ---- bf16 route: tensor cores ----
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The ldmatrix row address of this lane for m-tile `mt` of an OH x OW
// output region (npix = OH * OW pixels; rows past it repeat the last
// pixel and are discarded): output pixel (oy, ox) reads the tile pixel
// (oy + iy0, ox + ix0) of a tile IW pixels wide at stride S, plus koff
// bytes (the lane's k half: 16 bytes, or 0 where the half is a tap).
template <int S>
__device__ __forceinline__ uint32_t mma_row(uint32_t tile, int mt, int OW, int npix, int IW,
                                            int iy0, int ix0, int koff) {
  const int lane = threadIdx.x & 31;
  int m = mt * 16 + (lane & 15);
  m = m < npix ? m : npix - 1;
  const int oy = m / OW, ox = m - oy * OW;
  return tile + (uint32_t)((((oy + iy0) * IW + ox + ix0) * S) * 2 + koff);
}

// acc[i][n] += A(row[i] + off, k-step kk) x B(kk, n) over KSTEPS k16
// steps, the k-step kk's A at +32 kk bytes; w: one stage of packed B
// fragments, [KSTEPS][NTILES][32 lanes] uint2, in shared memory.
template <int IPT, int NTILES, int KSTEPS>
__device__ __forceinline__ void mma_stage(float (&acc)[IPT][NTILES][4],
                                          const uint32_t (&row)[IPT], uint32_t off,
                                          const uint2* w) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[IPT][4];
#pragma unroll
    for (int i = 0; i < IPT; ++i) ldmatrix_x4(a[i], row[i] + off + 32 * kk);
#pragma unroll
    for (int n = 0; n < NTILES; ++n) {
      const uint2 b = w[(kk * NTILES + n) * 32 + lane];
#pragma unroll
      for (int i = 0; i < IPT; ++i) mma_16816(acc[i][n], a[i], b.x, b.y);
    }
  }
}

// ---- the weight pipeline ----
// Runs stages s = s0 .. s1-1 of NS: when body(s - s0, ws) runs, stage s's
// weights (the bytes(s) bytes at w + off(s)) are at ws, one of two
// WST-byte buffers at wbuf, and the copy of stage s + 1 into the other is
// in flight.  The caller has issued and committed stage 0 (with the
// tile's staging) into the first buffer.
template <int NT, int WST, typename Off, typename Bytes, typename Body>
__device__ __forceinline__ void pipeline(int s0, int s1, int NS, const char* __restrict__ w,
                                         char* wbuf, Off off, Bytes bytes, Body body) {
#pragma unroll 1
  for (int s = s0; s < s1; ++s) {
    if (s + 1 < NS) {
      copy_async<NT>(wbuf + ((s + 1) & 1) * WST, w + off(s + 1), bytes(s + 1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    body(s - s0, wbuf + (s & 1) * WST);
    __syncthreads();                 // before the next copy overwrites it
  }
}

// Where this lane's accumulators sit: acc[i][n][2 h + e] is row
// mt * 16 + lane / 4 + 8 h of the m-tile, output channel n * 8 + 2 (lane % 4) + e.
__device__ __forceinline__ int mma_acc_row(int mt, int h) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int mma_acc_col(int n) { return n * 8 + 2 * (threadIdx.x & 3); }

}  // namespace conv3x3
