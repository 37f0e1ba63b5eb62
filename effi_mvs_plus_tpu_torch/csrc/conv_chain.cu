// A fused chain of 3x3 conv (+ folded eval BN) + ReLU layers (kernel K4).
//
// Replaces the TPU kernel effi_mvs_plus_tpu/ops/pallas_conv.py::_kernel
// (launched by _fwd, reached through conv_bn_relu_chain).  For x
// (B, H, W, C0) channels-last and L layers i = 0..L-1,
//
//   y_{i+1} = relu(conv3x3(y_i, W_i) + b_i),   y_0 = x,
//
// every convolution stride 1 with zero padding 1, W_i and b_i the BN-folded
// weights and biases (fold_bn).  Between layers everything outside the
// image is zero, so each layer's padding sees zeros, and each intermediate
// is rounded to the input's type, as the TPU kernel stores it.
//
// Design: one block per TH x TW output tile of one image.
//   0. the input tile plus an L-pixel halo is staged in shared memory as
//      fp32, channel-major ([c][pixel]), zero outside the image;
//   1. layer i computes its output over the tile plus an (L-1-i)-pixel
//      halo (the ring is recomputed by the neighbouring block too, as the
//      TPU kernel recomputes its strip halo) and keeps it in shared
//      memory, zero outside the image;
//   2. only the last layer is written to device memory.
// So x is read once and the chain's output written once; the intermediate
// activations never leave the SM.
//
// Bound.  A layer does 18*Ci*Co flops a pixel.  The FPN chains have
// Ci = Co = 8..64 (conv0: 3 -> 8 -> 8), so a pixel of a chain costs
// 18*(C0*C1 + C1*C2) flops against (C0 + C2)*4 bytes of compulsory
// traffic in fp32: 40 flops a byte for 3 -> 8 -> 8, 72 for 8 -> 8 -> 8,
// 288 for 32 -> 32 -> 32, all above the H100's fp32 ridge of 67 TFLOP/s
// over 3.35 TB/s = 20.  The kernel is bound by the fp32 FMA rate of the
// CUDA cores, and fp32 stays there so that the fp32 mode is true fp32 (no
// TF32).  The design answers with register tiling: a thread holds a
// 4-pixel x 8-channel tile of accumulators, so each shared-memory read of
// an input value feeds 8 FMAs and each 8-channel weight row (two 16-byte
// loads, the same address across the warp) feeds 4 pixels.  The weights
// are read through the read-only cache, never staged: at 64 channels one
// layer's 9*64*64 fp32 weights are 147 KB, which do not fit in shared
// memory beside the tiles, and every chain's weights (at most 295 KB)
// stay resident in L1/L2.  The halo recompute costs (TH+2)(TW+2)/(TH*TW)
// - 1 of the first layer: 20% at 16x32 (up to 8 channels), 27% at 16x16
// (16 and 32 channels), 41% at 8x16 (64 channels, whose two fp32 tiles
// take 107 KB).  bf16 inputs are widened to fp32 on staging; accumulation
// is fp32 for both types.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int NP = 4;                       // pixels per thread
constexpr int NCMAX = 8;                    // output channels per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float from_f(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 from_f(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Geometry of a chain (C3 = 0 for two layers, C2 = C3 = 0 for one).
template <int C0, int C1, int C2, int C3>
struct Chain {
  static constexpr int L = C3 ? 3 : (C2 ? 2 : 1);
  static constexpr int CM = cmax(cmax(C0, C1), cmax(C2, C3));
  static constexpr int TH = CM <= 32 ? 16 : 8;
  static constexpr int TW = CM <= 8 ? 32 : 16;
  static constexpr int NT = CM <= 16 ? 128 : 256;   // threads a block
  // buffer k (k = 0: the staged input; k = i + 1: layer i's output) spans
  // the tile plus an (L - k)-pixel halo
  __host__ __device__ static constexpr int RH(int k) {
    return TH + 2 * (L - k);
  }
  __host__ __device__ static constexpr int RW(int k) {
    return TW + 2 * (L - k);
  }
  __host__ __device__ static constexpr int R(int k) { return RH(k) * RW(k); }
  static constexpr int smem_floats() {
    return C0 * R(0) + (L >= 2 ? C1 * R(1) : 0) + (L >= 3 ? C2 * R(2) : 0);
  }
};

// One layer: output over an RH x RW region whose input is the
// (RH + 2) x (RW + 2) channel-major tile `in`.  (gy0, gx0) is the image
// position of the region's top-left pixel.  Not LAST: relu(acc + b),
// rounded to T and zero outside the image, into the channel-major tile
// `out_s`; LAST: the in-image pixels into out_g (B, H, W, CO).
template <typename T, int NT, int CI, int CO, int RH, int RW, bool LAST>
__device__ __forceinline__ void layer(const float* __restrict__ in,
                                      float* __restrict__ out_s,
                                      T* __restrict__ out_g,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      int b, int gy0, int gx0, int H,
                                      int W) {
  constexpr int IW = RW + 2;
  constexpr int IPLANE = (RH + 2) * IW;
  constexpr int NPIX = RH * RW;
  constexpr int NC = CO < NCMAX ? CO : NCMAX;
  constexpr int NG = CO / NC;                       // channel groups
  constexpr int NPG = (NPIX + NP - 1) / NP;         // pixel groups
  static_assert(CO % 4 == 0, "output channels must be a multiple of 4");
  for (int item = threadIdx.x; item < NPG * NG; item += NT) {
    const int g = item / NPG;
    const int pg = item - g * NPG;
    const int co = g * NC;
    int pix[NP], base[NP];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      pix[p] = pg + p * NPG;                        // lanes: adjacent pixels
      const int q = pix[p] < NPIX ? pix[p] : 0;
      const int y = q / RW;
      base[p] = y * IW + (q - y * RW);              // window top-left in `in`
    }
    float acc[NP][NC];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[p][j] = 0.0f;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * IW + (tap % 3);
      const float* wt = w + tap * CI * CO + co;
      const float* it = in + off;
#pragma unroll 4
      for (int c = 0; c < CI; ++c) {
        float wv[NC];
#pragma unroll
        for (int k = 0; k < NC / 4; ++k) {
          const float4 q =
              __ldg(reinterpret_cast<const float4*>(wt + c * CO) + k);
          wv[4 * k] = q.x; wv[4 * k + 1] = q.y;
          wv[4 * k + 2] = q.z; wv[4 * k + 3] = q.w;
        }
        const float* ic = it + c * IPLANE;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const float v = ic[base[p]];
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[p][j] = fmaf(v, wv[j], acc[p][j]);
        }
      }
    }
    float bv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) bv[j] = __ldg(bias + co + j);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (pix[p] >= NPIX) continue;
      const int y = pix[p] / RW;
      const int x = pix[p] - y * RW;
      const int gy = gy0 + y;
      const int gx = gx0 + x;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      if constexpr (LAST) {
        if (!inside) continue;
        T* o = out_g + ((long long)(b * H + gy) * W + gx) * CO + co;
#pragma unroll
        for (int j = 0; j < NC; ++j)
          o[j] = from_f(fmaxf(acc[p][j] + bv[j], 0.0f), o);
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float v = fmaxf(acc[p][j] + bv[j], 0.0f);
          // the next layer's zero padding, and the input type's rounding
          out_s[(co + j) * NPIX + pix[p]] =
              inside ? to_f(from_f(v, out_g)) : 0.0f;
        }
      }
    }
  }
}

template <typename T, int C0, int C1, int C2, int C3>
__global__ void __launch_bounds__(Chain<C0, C1, C2, C3>::NT)
conv_chain_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int H,
                  int W) {
  using G = Chain<C0, C1, C2, C3>;
  constexpr int L = G::L, TH = G::TH, TW = G::TW, NT = G::NT;
  extern __shared__ float smem[];
  float* buf0 = smem;                               // [C0][R(0)]
  float* buf1 = buf0 + C0 * G::R(0);                // [C1][R(1)]
  float* buf2 = buf1 + (L >= 2 ? C1 * G::R(1) : 0); // [C2][R(2)]

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;

  // 0. stage the input with an L-pixel halo; consecutive threads read
  //    consecutive channels of one pixel
  for (int i = threadIdx.x; i < G::R(0) * C0; i += NT) {
    const int p = i / C0;
    const int c = i - p * C0;
    const int iy = p / G::RW(0);
    const int ix = p - iy * G::RW(0);
    const int gy = ty0 - L + iy;
    const int gx = tx0 - L + ix;
    float v = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = to_f(x[((long long)(b * H + gy) * W + gx) * C0 + c]);
    buf0[c * G::R(0) + p] = v;
  }
  __syncthreads();

  // 1-2. the layers, each over the tile plus its shrinking halo
  layer<T, NT, C0, C1, G::RH(1), G::RW(1), L == 1>(
      buf0, buf1, out, w, bias, b, ty0 - (L - 1), tx0 - (L - 1), H, W);
  if constexpr (L >= 2) {
    __syncthreads();
    layer<T, NT, C1, C2, G::RH(2), G::RW(2), L == 2>(
        buf1, buf2, out, w + 9 * C0 * C1, bias + C1, b, ty0 - (L - 2),
        tx0 - (L - 2), H, W);
  }
  if constexpr (L >= 3) {
    __syncthreads();
    layer<T, NT, C2, C3, TH, TW, true>(
        buf2, nullptr, out, w + 9 * (C0 * C1 + C1 * C2), bias + C1 + C2, b,
        ty0, tx0, H, W);
  }
}

template <typename T, int C0, int C1, int C2, int C3>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  using G = Chain<C0, C1, C2, C3>;
  const int smem = G::smem_floats() * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      conv_chain_kernel<T, C0, C1, C2, C3>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  conv_chain_kernel<T, C0, C1, C2, C3><<<grid, G::NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

// The chains the kernel is built for: every stride-1 run of the FPN (the
// feature net's 3->8->8, 16->16->16, 32->32->32, 64->64->64 and the
// context net's 3->4->4, 8->8->8), and a one- and a three-layer chain that
// no model path runs: the GPU tests launch them to hold the kernel's layer
// count (1 to 3) against the plain version.
#define EFFI_CHAINS(X)  \
  X(3, 4, 4, 0)         \
  X(3, 8, 8, 0)         \
  X(8, 8, 8, 0)         \
  X(16, 16, 16, 0)      \
  X(32, 32, 32, 0)      \
  X(64, 64, 64, 0)      \
  X(8, 16, 0, 0)        \
  X(3, 8, 8, 16)

template <typename T>
cudaError_t dispatch(int c0, int c1, int c2, int c3, const void* x,
                     const void* w, const void* bias, void* out, int B, int H,
                     int W, cudaStream_t s) {
#define EFFI_CASE(a, b, c, d)                                          \
  if (c0 == a && c1 == b && c2 == c && c3 == d)                        \
    return launch<T, a, b, c, d>(x, w, bias, out, B, H, W, s);
  EFFI_CHAINS(EFFI_CASE)
#undef EFFI_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: contiguous (B, H, W, c0) and (B, H, W, c_last) of `dtype`
// (0 = float32, 1 = bfloat16).  Channels c0..c3 (0 past the last layer)
// must be one of EFFI_CHAINS.  w: fp32, layer by layer [9][Ci][Co] (tap,
// input channel, output channel); bias: fp32, layer by layer [Co].
// Returns the launch's cudaGetLastError().
extern "C" int effi_conv_chain(const void* x, const void* w,
                               const void* bias, void* out, int B, int H,
                               int W, int c0, int c1, int c2, int c3,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(c0, c1, c2, c3, x, w, bias, out, B, H, W, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(c0, c1, c2, c3, x, w, bias, out, B,
                                        H, W, s);
  return (int)cudaErrorInvalidValue;
}
