// One fused ConvGRU step (kernel K2).
//
// Replaces the TPU kernel effi_mvs_plus_tpu/ops/pallas_gru.py::_kernel
// (launched by _fwd_pallas, reached through _gru_fused / gru_step).  For
// hidden state h and input x, both (B, H, W, HD) channels-last,
//
//   z = sigmoid(conv3x3([h, x], Wz) + bz)
//   r = sigmoid(conv3x3([h, x], Wr) + br)
//   q = tanh(conv3x3([r*h, x], Wq) + bq)
//   h' = h + z * (q - h)
//
// with zero padding 1 for every convolution.
//
// Design: the single fused launch, built from csrc/conv3x3_tile.cuh.  A
// block owns an 8x16 tile of output pixels of one image and
//   0. stages [h, x] on the tile plus a 2-pixel halo (12x20) in shared
//      memory, channels-last, zero outside the image;
//   1. computes r on the tile plus a 1-pixel halo (10x18) and keeps r*h
//      there in shared memory, rounded to the input type as the TPU kernel
//      stores it (pallas_gru.py:149).  The halo ring of r is recomputed by
//      the neighbouring block too, as the TPU kernel recomputes its strip
//      halo: 180/128 - 1 = 41% more r, 14% more work in all;
//   2. computes z (over [h, x]) and q (over r*h and x) on the tile, and in
//      the epilogue the gates (fp32 sigmoid and tanh) and h', written
//      once in the input type.
// So h and x are read from device memory once and h' written once; z, r
// and q never leave the SM.  The weights stream through a double buffer
// in stages of 1, 3 or 9 taps (conv3x3_tile.cuh units_per_stage): r's 9
// taps, then z's, q's r*h half's and q's x half's.
//
// Bound.  Three 3x3 convolutions: 108 HD^2 flops a pixel against 3 HD
// elements of compulsory traffic: 9 HD flops a byte in fp32 (144-432),
// 18 HD in bf16 (288-864), above the H100's ridge in fp32 (67 TFLOP/s /
// 3.35 TB/s = 20) and, from HD = 32 on, in bf16 on the tensor cores
// (989 / 3.35 = 295).  So the kernel is bound by operations: the fp32 FMA
// rate in fp32, the tensor cores in bf16 (bytes at HD = 16).
//
// Routes.  bf16: mma.sync on the tensor cores.  An m16 tile is 16
//   consecutive pixels of a region in row-major order: the 10x18 r-region
//   is 12 m-tiles (192 rows, 12 wasted), the 8x16 tile 8 (one row each).
//   4 warps: 3 r m-tiles and 2 output m-tiles a warp, each across all HD
//   output channels.  Rounding as the TPU kernel: weights and r*h in bf16,
//   fp32 accumulation, gates and blend, h' rounded once.
// fp32: the CUDA cores, true fp32.  A thread owns 4 pixels x 4 output
//   channels, 8 at HD = 32 (2 such items in step 1, one each of z and q in
//   step 2): 128, 128 or 384 threads a block at HD = 16, 32, 48 (8 channels
//   measured faster at HD = 32 and slower at 16 and 48 on the H100).
//   Everything in fp32.
// Shared memory: see the budgets in conv3x3_tile.cuh.

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

constexpr int TH = 8, TW = 16;              // output tile
constexpr int RH = TH + 2, RW = TW + 2;     // r*h region (1-pixel halo)
constexpr int IH = TH + 4, IW = TW + 4;     // staged [h, x] (2-pixel halo)
constexpr int NPIX_O = TH * TW;             // 128
constexpr int NPIX_R = RH * RW;             // 180
constexpr int NPIX_I = IH * IW;             // 240

template <typename T, int HD>
struct Gru {
  static constexpr bool MMA = kMma<T>;
  static constexpr int SI = pixel_stride<T>(2 * HD);    // [h, x] tile
  static constexpr int SR = pixel_stride<T>(HD);        // r*h tile
  // fp32: a thread owns 4 pixels x FNC output channels of each gate
  static constexpr int FNC = HD == 32 ? 8 : 4;
  static constexpr int NT = MMA ? 128 : 32 * HD / FNC;
  // one stage: a tap of a (2HD -> HD) segment (r, z) or (HD -> HD) (q)
  static constexpr int SZ2 = MMA ? (2 * HD / 16) * (HD / 8) * 256 : 2 * HD * HD * 4;
  static constexpr int SZ1 = SZ2 / 2;
  static constexpr int G = units_per_stage(9, SZ2);     // taps a stage
  static constexpr int NSEG = 9 / G;                    // stages a segment
  static constexpr int NS = 4 * NSEG;
  static constexpr int smem_bytes() {
    return (NPIX_I * SI + NPIX_R * SR) * (int)sizeof(T) + 2 * G * SZ2;
  }
  // segments: r's 9 taps, z's, q's r*h half's, q's x half's
  __device__ static int off(int s) {
    const int seg = s / NSEG, k = s - seg * NSEG;
    return seg < 2 ? (seg * 9 + k * G) * SZ2 : 18 * SZ2 + ((seg - 2) * 9 + k * G) * SZ1;
  }
  __device__ static int bytes(int s) { return G * (s < 2 * NSEG ? SZ2 : SZ1); }
};

// bf16: tensor cores
template <int HD>
__device__ __forceinline__ void gru_mma(const bf16* in_s, bf16* rh_s, const char* w,
                                        char* wbuf, const float* __restrict__ bias,
                                        bf16* __restrict__ out, int b, int ty0, int tx0,
                                        int H, int W) {
  using G = Gru<bf16, HD>;
  constexpr int SI = G::SI, SR = G::SR, NTL = HD / 8, NW = G::NT / 32;
  constexpr int IPR = 3, IPO = 2;                 // m-tiles a warp: r, output
  static_assert(NW * IPR * 16 >= NPIX_R && NW * IPO * 16 == NPIX_O, "m-tiles");
  const int warp = threadIdx.x >> 5;
  const int half = ((threadIdx.x & 31) >> 4) * 16;
  const uint32_t in_a = smem_addr(in_s), rh_a = smem_addr(rh_s);
  uint32_t row_r[IPR], row_o[IPO], row_h[IPO];
#pragma unroll
  for (int i = 0; i < IPR; ++i)
    row_r[i] = mma_row<SI>(in_a, warp + NW * i, RW, NPIX_R, IW, 0, 0, half);
#pragma unroll
  for (int i = 0; i < IPO; ++i) {
    row_o[i] = mma_row<SI>(in_a, warp + NW * i, TW, NPIX_O, IW, 1, 1, half);
    row_h[i] = mma_row<SR>(rh_a, warp + NW * i, TW, NPIX_O, RW, 0, 0, half);
  }
  float ar[IPR][NTL][4] = {}, az[IPO][NTL][4] = {}, aq[IPO][NTL][4] = {};
  auto off = [](int s) { return G::off(s); };
  auto bytes = [](int s) { return G::bytes(s); };
  // 1. r on the r-region (stages 0-8), then r*h rounded to bf16 (zero
  //    where h was staged 0)
  pipeline<G::NT, G::G * G::SZ2>(0, G::NSEG, G::NS, w, wbuf, off, bytes,
                                 [&](int t, const char* ws) {
#pragma unroll 1
    for (int u = 0; u < G::G; ++u) {
      const int tap = t * G::G + u, dy = tap / 3, dx = tap - 3 * dy;
      mma_stage<IPR, NTL, 2 * HD / 16>(ar, row_r, (dy * IW + dx) * SI * 2,
                                       reinterpret_cast<const uint2*>(ws + u * G::SZ2));
    }
  });
#pragma unroll
  for (int i = 0; i < IPR; ++i)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mma_acc_row(warp + NW * i, hh);
        if (m >= NPIX_R) continue;
        const int ry = m / RW, rx = m - ry * RW, c = mma_acc_col(n);
        const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            in_s + ((ry + 1) * IW + rx + 1) * SI + c));
        const float r0 = sigmoidf_(ar[i][n][2 * hh] + bias[HD + c]);
        const float r1 = sigmoidf_(ar[i][n][2 * hh + 1] + bias[HD + c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(rh_s + m * SR + c) =
            __floats2bfloat162_rn(r0 * hv.x, r1 * hv.y);
      }
  // 2. z, and q's r*h and x halves, on the tile (stages 9-35)
  pipeline<G::NT, G::G * G::SZ2>(G::NSEG, G::NS, G::NS, w, wbuf, off, bytes,
                                 [&](int t, const char* ws) {
    const int seg = t / G::NSEG, k = t - seg * G::NSEG;
#pragma unroll 1
    for (int u = 0; u < G::G; ++u) {
      const int tap = k * G::G + u, dy = tap / 3, dx = tap - 3 * dy;
      const uint32_t ti = (dy * IW + dx) * SI * 2;
      if (seg == 0) {
        mma_stage<IPO, NTL, 2 * HD / 16>(az, row_o, ti,
                                         reinterpret_cast<const uint2*>(ws + u * G::SZ2));
      } else {
        const uint2* wf = reinterpret_cast<const uint2*>(ws + u * G::SZ1);
        if (seg == 1)
          mma_stage<IPO, NTL, HD / 16>(aq, row_h, (dy * RW + dx) * SR * 2, wf);
        else
          mma_stage<IPO, NTL, HD / 16>(aq, row_o, ti + HD * 2, wf);
      }
    }
  });

#pragma unroll
  for (int i = 0; i < IPO; ++i)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = mma_acc_row(warp + NW * i, hh);
        const int oy = m / TW, ox = m - oy * TW, c = mma_acc_col(n);
        const int gy = ty0 + oy, gx = tx0 + ox;
        if (gy >= H || gx >= W) continue;
        const float2 hv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            in_s + ((oy + 2) * IW + ox + 2) * SI + c));
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = sigmoidf_(az[i][n][2 * hh + e] + bias[c + e]);
          const float q = tanhf(aq[i][n][2 * hh + e] + bias[2 * HD + c + e]);
          const float hc = e ? hv.y : hv.x;
          o[e] = hc + z * (q - hc);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + ((long long)(b * H + gy) * W + gx) * HD + c) =
            __floats2bfloat162_rn(o[0], o[1]);
      }
}

// fp32: CUDA cores
template <int HD>
__device__ __forceinline__ void gru_fma(const float* in_s, float* rh_s, const char* w,
                                        char* wbuf, const float* __restrict__ bias,
                                        float* __restrict__ out, int b, int ty0, int tx0,
                                        int H, int W) {
  using G = Gru<float, HD>;
  constexpr int SI = G::SI, SR = G::SR, NT = G::NT;
  constexpr int NP = 4, NC = G::FNC, NCG = HD / NC;
  constexpr int NPG_R = NPIX_R / NP, NPG_O = NPIX_O / NP;     // 45, 32
  constexpr int IPR = ceil_div(NPG_R * NCG, NT);               // 2
  static_assert(NPG_O * NCG == NT, "one output item a thread");
  const int tid = threadIdx.x;
  int off_r[IPR][NP], co_r[IPR], off_o[1][NP], off_h[1][NP], co_o[1];
  bool ok_r[IPR];
#pragma unroll
  for (int i = 0; i < IPR; ++i) {
    const int item = tid + NT * i;
    ok_r[i] = item < NPG_R * NCG;
    const int it = ok_r[i] ? item : 0;
    const int pg = it % NPG_R;
    co_r[i] = (it / NPG_R) * NC;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int rp = pg + NPG_R * p, ry = rp / RW, rx = rp - ry * RW;
      off_r[i][p] = (ry * IW + rx) * SI;
    }
  }
  co_o[0] = (tid / NPG_O) * NC;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int op = tid % NPG_O + NPG_O * p, oy = op / TW, ox = op - oy * TW;
    off_o[0][p] = ((oy + 1) * IW + ox + 1) * SI;
    off_h[0][p] = (oy * RW + ox) * SR;
  }
  float ar[IPR][NP][NC] = {}, az[1][NP][NC] = {}, aq[1][NP][NC] = {};
  auto off = [](int s) { return G::off(s); };
  auto bytes = [](int s) { return G::bytes(s); };
  // 1. r on the r-region (stages 0-8), then r*h
  pipeline<NT, G::G * G::SZ2>(0, G::NSEG, G::NS, w, wbuf, off, bytes,
                              [&](int t, const char* ws) {
#pragma unroll 1
    for (int u = 0; u < G::G; ++u) {
      const int tap = t * G::G + u, dy = tap / 3, dx = tap - 3 * dy;
      fma_tap<float, 2 * HD, HD, IPR, NP, NC>(ar, in_s + (dy * IW + dx) * SI, off_r, co_r,
                                              reinterpret_cast<const float*>(ws + u * G::SZ2));
    }
  });
#pragma unroll
  for (int i = 0; i < IPR; ++i) {
    if (!ok_r[i]) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int rp = (tid + NT * i) % NPG_R + NPG_R * p;
      const float* hc = in_s + off_r[i][p] + (IW + 1) * SI + co_r[i];
#pragma unroll
      for (int j = 0; j < NC; j += 4) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = sigmoidf_(ar[i][p][j + e] + bias[HD + co_r[i] + j + e]) * hc[j + e];
        store4(rh_s + rp * SR + co_r[i] + j, v);
      }
    }
  }
  // 2. z, and q's r*h and x halves, on the tile (stages 9-35)
  pipeline<NT, G::G * G::SZ2>(G::NSEG, G::NS, G::NS, w, wbuf, off, bytes,
                              [&](int t, const char* ws) {
    const int seg = t / G::NSEG, k = t - seg * G::NSEG;
#pragma unroll 1
    for (int u = 0; u < G::G; ++u) {
      const int tap = k * G::G + u, dy = tap / 3, dx = tap - 3 * dy;
      const float* ti = in_s + (dy * IW + dx) * SI;
      if (seg == 0) {
        fma_tap<float, 2 * HD, HD, 1, NP, NC>(az, ti, off_o, co_o,
                                              reinterpret_cast<const float*>(ws + u * G::SZ2));
      } else {
        const float* wf = reinterpret_cast<const float*>(ws + u * G::SZ1);
        if (seg == 1)
          fma_tap<float, HD, HD, 1, NP, NC>(aq, rh_s + (dy * RW + dx) * SR, off_h, co_o, wf);
        else
          fma_tap<float, HD, HD, 1, NP, NC>(aq, ti + HD, off_o, co_o, wf);
      }
    }
  });

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const int op = tid % NPG_O + NPG_O * p, oy = op / TW, ox = op - oy * TW;
    const int gy = ty0 + oy, gx = tx0 + ox;
    if (gy >= H || gx >= W) continue;
    const float* hc = in_s + off_o[0][p] + (IW + 1) * SI + co_o[0];
    float* o = out + ((long long)(b * H + gy) * W + gx) * HD + co_o[0];
#pragma unroll
    for (int j = 0; j < NC; j += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = co_o[0] + j + e;
        const float z = sigmoidf_(az[0][p][j + e] + bias[c]);
        const float q = tanhf(aq[0][p][j + e] + bias[2 * HD + c]);
        v[e] = hc[j + e] + z * (q - hc[j + e]);
      }
      store4(o + j, v);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Gru<T, HD>::NT)
conv_gru_kernel(const T* __restrict__ h, const T* __restrict__ x, const char* __restrict__ w,
                const float* __restrict__ bias, T* __restrict__ out, int H, int W) {
  using G = Gru<T, HD>;
  extern __shared__ __align__(16) char smem[];
  T* in_s = reinterpret_cast<T*>(smem);                      // [NPIX_I][SI]
  T* rh_s = in_s + NPIX_I * G::SI;                           // [NPIX_R][SR]
  char* wbuf = reinterpret_cast<char*>(rh_s + NPIX_R * G::SR);
  const int b = blockIdx.z, ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;

  stage<T, HD, G::SI, G::NT>(in_s, h, b, ty0 - 2, tx0 - 2, IH, IW, H, W);
  stage<T, HD, G::SI, G::NT>(in_s + HD, x, b, ty0 - 2, tx0 - 2, IH, IW, H, W);
  copy_async<G::NT>(wbuf, w, G::G * G::SZ2);
  cp_async_commit();
  if constexpr (G::MMA)
    gru_mma<HD>(in_s, rh_s, w, wbuf, bias, out, b, ty0, tx0, H, W);
  else
    gru_fma<HD>(in_s, rh_s, w, wbuf, bias, out, b, ty0, tx0, H, W);
}

template <typename T, int HD>
cudaError_t launch(const void* h, const void* x, const void* w, const void* bias, void* out,
                   int B, int H, int W, cudaStream_t stream) {
  using G = Gru<T, HD>;
  static unsigned sized = 0;           // devices whose attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 31) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(conv_gru_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::smem_bytes());
    if (e != cudaSuccess) return e;
    sized |= 1u << (dev & 31);
  }
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  conv_gru_kernel<T, HD><<<grid, G::NT, G::smem_bytes(), stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<const char*>(w),
      static_cast<const float*>(bias), static_cast<T*>(out), H, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* h, const void* x, const void* w, const void* bias,
                        void* out, int B, int H, int W, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(h, x, w, bias, out, B, H, W, s);
    case 32: return launch<T, 32>(h, x, w, bias, out, B, H, W, s);
    case 48: return launch<T, 48>(h, x, w, bias, out, B, H, W, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// h, x, out: contiguous (B, H, W, hd) of `dtype` (0 = float32,
// 1 = bfloat16), 16-byte aligned.  w: the wrapper's packed weights
// (ops/cuda_gru.py `pack_weights`): 36 stages, r's taps, z's, q's r*h
// half's, q's x half's, each in the route's stage layout
// (conv3x3_tile.cuh).  bias: fp32 [bz, br, bq], 3 hd.  Returns the
// launch's cudaGetLastError().
extern "C" int effi_conv_gru(const void* h, const void* x, const void* w, const void* bias,
                             void* out, int B, int H, int W, int hd, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_hd<float>(hd, h, x, w, bias, out, B, H, W, s);
  if (dtype == 1) return (int)dispatch_hd<bf16>(hd, h, x, w, bias, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
