// One 3-D layer of the serving forward's cost regularisation, fused:
// a 3x3x3 convolution or transposed convolution, running-statistic BN,
// ReLU and the residual, with the cross-scale block's two inputs read as
// one concatenated input.
//
// Replaces no TPU kernel: the JAX package runs these layers through XLA
// (effi_mvs_plus_tpu/models/blocks.py CostRegNet, CSPBlock).  On the card
// cuDNN serves them with generic kernels (grouped direct, implicit sgemm,
// and for the transposed layers input-gradient kernels), each followed by
// elementwise passes for BN, ReLU, the residual add and the concatenation.
//
// For an input x (B, Di, Hi, Wi, CIA) channels-last, an optional second
// input x2 (B, Di, Hi, Wi, CIB) appended to x's channels, weights w and
// the per-channel fp32 scale and shift of BN (ones and zeros for a plain
// convolution), every output voxel and channel is
//
//   y = relu?(conv(x, w) * scale + shift) + res?,
//
// with the products summed in fp32 over the weights rounded to the input
// type, the epilogue in fp32 and one rounding at the end
// (ops/cuda_conv3d.py _reg_torch is the same arithmetic in plain PyTorch).
//
// Modes (padding 1 everywhere): 0 stride 1; 1 stride 2; 2 stride (1,2,2);
// 3 transposed, stride 2, output padding 1; 4 transposed, stride (1,2,2),
// output padding (0,1,1).  A transposed layer is split by the parity of
// its output along each stride-2 axis: output 2m reads input m through tap
// 1, output 2m+1 inputs m and m+1 through taps 2 and 0.  Each class is a
// stride-1 convolution over only the taps that reach it: no zero-inserted
// input and no wasted tap.
//
// Design: a persistent grid of blocks, as many as fit on the card, each
// loading the layer's weights (rounded to the input type, in its route's
// layout) and BN's scale and shift into shared memory once, from the
// module's own tensors, and then taking
// output tiles of TD x TH x TW voxels and all output channels in turn.
// A tile's input, with its halo, is staged in shared memory by cp.async
// as planes of G channels ([C / G][voxel][G], zeros outside the volume),
// so every input byte is read from device memory about once (the halo is
// shared with the neighbouring tiles through L2).  Each class of a tile
// (one for a plain convolution) is then computed by the whole block:
//   * bf16 layers with 8 or more input and output channels on the tensor
//     cores: mma.sync m16n8k8 (bf16 in, fp32 accumulators), an m-tile of
//     16 output voxels by 8 input channels loaded with ldmatrix.x2 from
//     one row address a lane, a k8 step a tap and plane of 8 channels;
//     a warp owns whole m-tiles across every output channel; the weights
//     are laid out as B fragments in register order (load_layer);
//   * every other layer (fp32, and the bf16 layers of 1 input or output
//     channel) on the CUDA cores, true fp32: a thread owns 4 voxels x 8
//     output channels (8 voxels where the layer has one output channel),
//     reads 4 input channels of a voxel as one load and each weight row as
//     a broadcast load.
// The epilogue applies scale, shift, ReLU and the residual in fp32 and
// writes each output once.  No atomics and a fixed order of summation:
// two calls give the same bits.  No workspace and no copy of the weights
// in device memory: the call allocates only its output.

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

// One axis of a layer: stride S, transposed or not.
template <int S, bool TR>
struct Ax {
  static constexpr int P = (TR && S == 2) ? 2 : 1;  // output parity classes
  // input extent of an output tile of t (t a multiple of P)
  __host__ __device__ static constexpr int extent(int t) {
    return TR ? (S == 2 ? t / 2 + 1 : t + 2) : (t - 1) * S + 3;
  }
  // the first input index of the tile whose first output is o0
  __device__ static int start(int o0) { return TR ? (S == 2 ? o0 / 2 : o0 - 1) : o0 * S - 1; }
  // taps reaching class p: their kernel index and their input offset from
  // the output's base(m)
  __device__ static int ntaps(int p) { return P == 2 ? (p == 0 ? 1 : 2) : 3; }
  __device__ static int k(int p, int j) { return P == 2 ? (p == 0 ? 1 : 2 * j) : j; }
  __device__ static int delta(int p, int j) {
    return P == 2 ? (p == 0 ? 0 : 1 - j) : (TR ? 2 - j : j);
  }
  // the tile's input index of class-local output m before its taps
  __device__ static int base(int m) { return TR ? m : S * m; }
};

template <int MODE> struct Mode;
template <> struct Mode<0> { using D = Ax<1, false>; using HW = Ax<1, false>; };
template <> struct Mode<1> { using D = Ax<2, false>; using HW = Ax<2, false>; };
template <> struct Mode<2> { using D = Ax<1, false>; using HW = Ax<2, false>; };
template <> struct Mode<3> { using D = Ax<2, true>; using HW = Ax<2, true>; };
template <> struct Mode<4> { using D = Ax<1, true>; using HW = Ax<2, true>; };

// A layer's geometry, routes and shared memory.
template <typename T, int CIA, int CIB, int CO, int MODE, int TD, int TH, int TW, int NT>
struct Geo {
  static constexpr int CI = CIA + CIB;
  static constexpr bool MMA = kMma<T> && CI >= 8 && CO >= 8;
  static constexpr int G = CI == 1 ? 1 : (kMma<T> ? 8 : 4);   // channels a plane
  using AD = typename Mode<MODE>::D;
  using AH = typename Mode<MODE>::HW;
  using AW = typename Mode<MODE>::HW;
  static constexpr int ID = AD::extent(TD), IH = AH::extent(TH), IW = AW::extent(TW);
  static constexpr int NV = ID * IH * IW;                     // input voxels a tile
  static constexpr int PD = AD::P, PH = AH::P, PW = AW::P, NCLS = PD * PH * PW;
  static constexpr int TDc = TD / PD, THc = TH / PH, TWc = TW / PW;
  static constexpr int NPIX = TDc * THc * TWc;                // outputs a class
  static constexpr bool TRANS = MODE >= 3;
  static constexpr int WBYTES = 27 * CI * CO * (MMA ? 2 : 4);   // weights
  static constexpr int BNBYTES = (8 * CO + 15) / 16 * 16;        // scale, shift
  static constexpr int smem_bytes() { return WBYTES + BNBYTES + NV * CI * (int)sizeof(T); }
  static_assert(CIA % G == 0 && CIB % G == 0, "channels a plane");
  static_assert(G == 1 || G * sizeof(T) == 16, "a plane's voxel is 16 bytes");
  static_assert(WBYTES % 16 == 0, "weights");
  static_assert(TD % PD == 0 && TH % PH == 0 && TW % PW == 0, "tile");
  static_assert(!MMA || (CI % 8 == 0 && CO % 8 == 0), "mma layers");
};

// The layer's operands into shared memory, by the whole block: the weights
// w, fp32 as the module holds them ((CO, CI, 3, 3, 3), transposed (CI, CO,
// 3, 3, 3)), rounded to T, in the route's layout -- [tap][ci][co] fp32 on
// the CUDA cores; on the tensor cores B fragments of m16n8k8 in register
// order, [tap][k8 step][n-tile][lane][2] bf16, lane l holding output
// channel 8 n + l / 4 and input channels 8 kk + 2 (l % 4) + e -- then BN's
// running-statistic scale g / sqrt(var + eps) and shift b - mean * scale in
// fp32 (1 and 0 where g is null).
template <class L, typename T, int CO, int NT>
__device__ __forceinline__ void load_layer(char* smem, const float* __restrict__ w,
                                           const float* __restrict__ g,
                                           const float* __restrict__ bb,
                                           const float* __restrict__ mean,
                                           const float* __restrict__ var, float eps) {
  constexpr int CI = L::CI, N = 27 * CI * CO;
  auto src = [](int ci, int co, int tap) {
    return (L::TRANS ? ci * CO + co : co * CI + ci) * 27 + tap;
  };
  if constexpr (L::MMA) {
    constexpr int KST = CI / 8, NTL = CO / 8;
    bf16* ws = reinterpret_cast<bf16*>(smem);
    for (int e = threadIdx.x; e < N; e += NT) {
      const int h = e & 1, lane = (e >> 1) & 31;
      int r = e >> 6;                                    // (tap * KST + kk) * NTL + n
      const int n = r % NTL;
      r /= NTL;
      const int kk = r % KST, tap = r / KST;
      ws[e] = __float2bfloat16(w[src(kk * 8 + 2 * (lane & 3) + h, n * 8 + (lane >> 2), tap)]);
    }
  } else {
    float* ws = reinterpret_cast<float*>(smem);
    for (int e = threadIdx.x; e < N; e += NT) {
      const int co = e % CO, r = e / CO, ci = r % CI, tap = r / CI;
      ws[e] = to_f(from_f<T>(w[src(ci, co, tap)]));
    }
  }
  float* bn = reinterpret_cast<float*>(smem + L::WBYTES);
  for (int c = threadIdx.x; c < CO; c += NT) {
    float sc = 1.0f, sh = 0.0f;
    if (g != nullptr) {
      sc = __fmul_rn(g[c], 1.0f / sqrtf(__fadd_rn(var[c], eps)));
      sh = __fsub_rn(bb[c], __fmul_rn(mean[c], sc));
    }
    bn[c] = sc;
    bn[CO + c] = sh;
  }
}

// The tile's input voxels (i0d + vd, i0h + vh, i0w + vw) of image b into
// tile[(g * NV + v) * G + e], channel g * G + e of [x, x2], zeros outside
// the volume: by cp.async 16-byte copies (the caller commits and waits),
// or element by element for one channel.
template <class L, typename T, int CIA, int CIB, int NT>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ x, const T* __restrict__ x2,
                                      int b, int i0d, int i0h, int i0w, int Di, int Hi, int Wi) {
  constexpr int G = L::G, NV = L::NV, IH = L::IH, IW = L::IW;
  constexpr int GA = CIA / G, NG = (CIA + CIB) / G;
  for (int idx = threadIdx.x; idx < NG * NV; idx += NT) {
    const int g = idx / NV, v = idx - g * NV;
    const int vd = v / (IH * IW), r = v - vd * (IH * IW), vh = r / IW, vw = r - vh * IW;
    const int gd = i0d + vd, gh = i0h + vh, gw = i0w + vw;
    const bool in = gd >= 0 && gd < Di && gh >= 0 && gh < Hi && gw >= 0 && gw < Wi;
    const long long vox = (((long long)b * Di + gd) * Hi + gh) * Wi + gw;
    if constexpr (G == 1) {
      tile[idx] = in ? x[vox] : from_f<T>(0.0f);
    } else {
      const T* src = g < GA ? x + vox * CIA + g * G : x2 + vox * CIB + (g - GA) * G;
      cp_async16(tile + idx * G, in ? src : x, in);
    }
  }
}

// Class-local output m of a tile -> its three class-local coordinates.
template <class L>
__device__ __forceinline__ void coords(int m, int& md, int& mh, int& mw) {
  md = m / (L::THc * L::TWc);
  const int r = m - md * (L::THc * L::TWc);
  mh = r / L::TWc;
  mw = r - mh * L::TWc;
}

template <class L>
__device__ __forceinline__ int base_voxel(int m) {
  int md, mh, mw;
  coords<L>(m, md, mh, mw);
  return (L::AD::base(md) * L::IH + L::AH::base(mh)) * L::IW + L::AW::base(mw);
}

// Output m of class (pd, ph, pw) of the tile at (o0d, o0h, o0w): its element
// offset in out (B, Do, Ho, Wo, CO), and whether it lies in the volume.
template <class L, int CO>
__device__ __forceinline__ bool out_at(int m, int pd, int ph, int pw, int b, int o0d, int o0h,
                                       int o0w, int Do, int Ho, int Wo, long long& g) {
  int md, mh, mw;
  coords<L>(m, md, mh, mw);
  const int od = o0d + L::PD * md + pd, oh = o0h + L::PH * mh + ph, ow = o0w + L::PW * mw + pw;
  g = ((((long long)b * Do + od) * Ho + oh) * Wo + ow) * CO;
  return od < Do && oh < Ho && ow < Wo;
}

template <bool RELU>
__device__ __forceinline__ float epilogue(float acc, float sc, float sh) {
  const float v = fmaf(acc, sc, sh);
  return RELU ? fmaxf(v, 0.0f) : v;
}

// ---- CUDA-core route ----
// acc[i][p][j] += sum_c tile[voxel voff[i][p] + toff, channel c] * w[c][co[i] + j]
template <class L, typename T, int CO, int IPT, int NP, int NC>
__device__ __forceinline__ void fma_tap(float (&acc)[IPT][NP][NC], const T* tile, int toff,
                                        const int (&voff)[IPT][NP], const int (&co)[IPT],
                                        const float* w) {
  constexpr int CI = L::CI, G = L::G, NV = L::NV;
  if constexpr (CI == 1) {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      float wv[NC];
      if constexpr (NC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < NC / 4; ++q) {
          const float4 u = load4(w + co[i] + 4 * q);
          wv[4 * q] = u.x; wv[4 * q + 1] = u.y; wv[4 * q + 2] = u.z; wv[4 * q + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NC; ++j) wv[j] = w[co[i] + j];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const float v = to_f(tile[voff[i][p] + toff]);
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][p][j] = fmaf(v, wv[j], acc[i][p][j]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < CI; c += 4) {
      const T* plane = tile + (c / G) * NV * G + c % G;
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        float4 a[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) a[p] = load4(plane + (voff[i][p] + toff) * G);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float wv[NC];
          if constexpr (NC % 4 == 0) {
#pragma unroll
            for (int q = 0; q < NC / 4; ++q) {
              const float4 u = load4(w + (c + cc) * CO + co[i] + 4 * q);
              wv[4 * q] = u.x; wv[4 * q + 1] = u.y; wv[4 * q + 2] = u.z; wv[4 * q + 3] = u.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < NC; ++j) wv[j] = w[(c + cc) * CO + co[i] + j];
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
}

template <class L, typename T, int CO, bool RELU, bool RES, int NT>
__device__ __forceinline__ void fma_tile(const T* tile, const float* wsm,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift,
                                         const T* __restrict__ res, T* __restrict__ out, int b,
                                         int o0d, int o0h, int o0w, int Do, int Ho, int Wo) {
  constexpr int NC = CO < 8 ? CO : 8, NP = NC == 1 ? 8 : 4, NCG = CO / NC, NPIX = L::NPIX;
  constexpr int NPG = ceil_div(NPIX, NP), ITEMS = NPG * NCG, IPT = ceil_div(ITEMS, NT);
  constexpr int IH = L::IH, IW = L::IW;
  static_assert(CO % NC == 0, "output channels");
  int co[IPT], pg[IPT];
  bool ok[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    const int item = threadIdx.x + NT * i;
    ok[i] = item < ITEMS;
    const int it = ok[i] ? item : 0;
    co[i] = (it / NPG) * NC;
    pg[i] = it % NPG;
  }
  int voff[IPT][NP];
#pragma unroll
  for (int i = 0; i < IPT; ++i)
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const int m = pg[i] + NPG * p;
      voff[i][p] = base_voxel<L>(m < NPIX ? m : NPIX - 1);
    }
#pragma unroll 1
  for (int cls = 0; cls < L::NCLS; ++cls) {
    const int pd = cls / (L::PH * L::PW), ph = (cls / L::PW) % L::PH, pw = cls % L::PW;
    float acc[IPT][NP][NC] = {};
#pragma unroll 1
    for (int jd = 0; jd < L::AD::ntaps(pd); ++jd) {
      const int kd = L::AD::k(pd, jd), dd = L::AD::delta(pd, jd);
#pragma unroll 1
      for (int jh = 0; jh < L::AH::ntaps(ph); ++jh) {
        const int kh = L::AH::k(ph, jh), dh = L::AH::delta(ph, jh);
#pragma unroll 1
        for (int jw = 0; jw < L::AW::ntaps(pw); ++jw) {
          const int kw = L::AW::k(pw, jw), dw = L::AW::delta(pw, jw);
          const int tap = (kd * 3 + kh) * 3 + kw;
          fma_tap<L, T, CO, IPT, NP, NC>(acc, tile, (dd * IH + dh) * IW + dw, voff, co,
                                         wsm + tap * L::CI * CO);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (!ok[i]) continue;
      float sc[NC], sh[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        sc[j] = scale[co[i] + j];
        sh[j] = shift[co[i] + j];
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int m = pg[i] + NPG * p;
        if (m >= NPIX) continue;
        long long g;
        if (!out_at<L, CO>(m, pd, ph, pw, b, o0d, o0h, o0w, Do, Ho, Wo, g)) continue;
        g += co[i];
        if constexpr (NC % 4 == 0) {
#pragma unroll
          for (int q = 0; q < NC; q += 4) {
            float v[4];
            float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
            if constexpr (RES) r = load4(res + g + q);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = epilogue<RELU>(acc[i][p][q + e], sc[q + e], sh[q + e]) + (RES ? comp(r, e) : 0.0f);
            store4(out + g + q, v);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            float v = epilogue<RELU>(acc[i][p][j], sc[j], sh[j]);
            if constexpr (RES) v += to_f(res[g + j]);
            out[g + j] = from_f<T>(v);
          }
        }
      }
    }
  }
}

// ---- tensor-core route (bf16) ----
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

template <class L, int CO, bool RELU, bool RES, int NT>
__device__ __forceinline__ void mma_tile(const bf16* tile, const uint32_t* wsm,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift,
                                         const bf16* __restrict__ res, bf16* __restrict__ out,
                                         int b, int o0d, int o0h, int o0w, int Do, int Ho, int Wo) {
  constexpr int NPIX = L::NPIX, NW = NT / 32, MT = ceil_div(NPIX, 16), IPT = ceil_div(MT, NW);
  constexpr int NTL = CO / 8, KST = L::CI / 8, NV = L::NV, IH = L::IH, IW = L::IW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t row[IPT];
#pragma unroll
  for (int i = 0; i < IPT; ++i) {
    int m = (warp + NW * i) * 16 + (lane & 15);
    m = m < NPIX ? m : NPIX - 1;
    row[i] = smem_addr(tile) + (uint32_t)base_voxel<L>(m) * 16u;
  }
#pragma unroll 1
  for (int cls = 0; cls < L::NCLS; ++cls) {
    const int pd = cls / (L::PH * L::PW), ph = (cls / L::PW) % L::PH, pw = cls % L::PW;
    float acc[IPT][NTL][4] = {};
#pragma unroll 1
    for (int jd = 0; jd < L::AD::ntaps(pd); ++jd) {
      const int kd = L::AD::k(pd, jd), dd = L::AD::delta(pd, jd);
#pragma unroll 1
      for (int jh = 0; jh < L::AH::ntaps(ph); ++jh) {
        const int kh = L::AH::k(ph, jh), dh = L::AH::delta(ph, jh);
#pragma unroll 1
        for (int jw = 0; jw < L::AW::ntaps(pw); ++jw) {
          const int kw = L::AW::k(pw, jw), dw = L::AW::delta(pw, jw);
          const int tap = (kd * 3 + kh) * 3 + kw;
          const uint32_t toff = (uint32_t)((dd * IH + dh) * IW + dw) * 16u;
          const uint32_t* wt = wsm + tap * KST * NTL * 32;
#pragma unroll
          for (int kk = 0; kk < KST; ++kk) {
            uint32_t a[IPT][2];
#pragma unroll
            for (int i = 0; i < IPT; ++i)
              if (warp + NW * i < MT) ldmatrix_x2(a[i], row[i] + toff + (uint32_t)(kk * NV * 16));
#pragma unroll
            for (int n = 0; n < NTL; ++n) {
              const uint32_t bw = wt[(kk * NTL + n) * 32 + lane];
#pragma unroll
              for (int i = 0; i < IPT; ++i)
                if (warp + NW * i < MT) mma_1688(acc[i][n], a[i], bw);
            }
          }
        }
      }
    }
    float sc[NTL][2], sh[NTL][2];
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[n][e] = scale[n * 8 + 2 * (lane & 3) + e];
        sh[n][e] = shift[n * 8 + 2 * (lane & 3) + e];
      }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (warp + NW * i >= MT) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = (warp + NW * i) * 16 + (lane >> 2) + 8 * hh;
        if (m >= NPIX) continue;
        long long g;
        if (!out_at<L, CO>(m, pd, ph, pw, b, o0d, o0h, o0w, Do, Ho, Wo, g)) continue;
#pragma unroll
        for (int n = 0; n < NTL; ++n) {
          const int c = n * 8 + 2 * (lane & 3);
          float v0 = epilogue<RELU>(acc[i][n][2 * hh], sc[n][0], sh[n][0]);
          float v1 = epilogue<RELU>(acc[i][n][2 * hh + 1], sc[n][1], sh[n][1]);
          if constexpr (RES) {
            const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res + g + c));
            v0 += r.x;
            v1 += r.y;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + g + c) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

template <typename T, int CIA, int CIB, int CO, int MODE, bool RELU, bool RES, int TD, int TH,
          int TW, int NT>
__global__ void __launch_bounds__(NT)
conv3d_reg_kernel(const T* __restrict__ x, const T* __restrict__ x2, const T* __restrict__ res,
                  const float* __restrict__ w, const float* __restrict__ g,
                  const float* __restrict__ bb, const float* __restrict__ mean,
                  const float* __restrict__ var, float eps, T* __restrict__ out, int B, int Di,
                  int Hi, int Wi, int Do, int Ho, int Wo) {
  using L = Geo<T, CIA, CIB, CO, MODE, TD, TH, TW, NT>;
  extern __shared__ __align__(16) char smem[];
  const float* scale = reinterpret_cast<const float*>(smem + L::WBYTES);
  const float* shift = scale + CO;
  T* tile = reinterpret_cast<T*>(smem + L::WBYTES + L::BNBYTES);
  load_layer<L, T, CO, NT>(smem, w, g, bb, mean, var, eps);
  const int nd = (Do + TD - 1) / TD, nh = (Ho + TH - 1) / TH, nw = (Wo + TW - 1) / TW;
  const long long ntiles = (long long)B * nd * nh * nw;
#pragma unroll 1
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int o0w = (int)(t % nw) * TW;
    long long r = t / nw;
    const int o0h = (int)(r % nh) * TH;
    r /= nh;
    const int o0d = (int)(r % nd) * TD;
    const int b = (int)(r / nd);
    stage<L, T, CIA, CIB, NT>(tile, x, x2, b, L::AD::start(o0d), L::AH::start(o0h),
                              L::AW::start(o0w), Di, Hi, Wi);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (L::MMA) {
      mma_tile<L, CO, RELU, RES, NT>(tile, reinterpret_cast<const uint32_t*>(smem), scale, shift,
                                     res, out, b, o0d, o0h, o0w, Do, Ho, Wo);
    } else {
      fma_tile<L, T, CO, RELU, RES, NT>(tile, reinterpret_cast<const float*>(smem), scale, shift,
                                        res, out, b, o0d, o0h, o0w, Do, Ho, Wo);
    }
    __syncthreads();                 // before the next tile overwrites this one
  }
}

template <typename T, int CIA, int CIB, int CO, int MODE, bool RELU, bool RES, int TD, int TH,
          int TW, int NT>
cudaError_t launch(const void* x, const void* x2, const void* res, const float* w,
                   const float* g, const float* bb, const float* mean, const float* var,
                   float eps, void* out, int B, int Di, int Hi, int Wi, int Do, int Ho, int Wo,
                   cudaStream_t stream) {
  using L = Geo<T, CIA, CIB, CO, MODE, TD, TH, TW, NT>;
  auto kern = conv3d_reg_kernel<T, CIA, CIB, CO, MODE, RELU, RES, TD, TH, TW, NT>;
  static int slots[32] = {};           // resident blocks on each device
  int dev = 0;
  cudaGetDevice(&dev);
  if (!slots[dev & 31]) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::smem_bytes());
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, L::smem_bytes());
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    slots[dev & 31] = (per_sm > 0 ? per_sm : 1) * sms;
  }
  const long long ntiles = (long long)B * ((Do + TD - 1) / TD) * ((Ho + TH - 1) / TH) *
                           ((Wo + TW - 1) / TW);
  if (ntiles == 0) return cudaSuccess;
  const int grid = (int)(ntiles < slots[dev & 31] ? ntiles : slots[dev & 31]);
  kern<<<grid, NT, L::smem_bytes(), stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(x2), static_cast<const T*>(res), w, g, bb,
      mean, var, eps, static_cast<T*>(out), B, Di, Hi, Wi, Do, Ho, Wo);
  return cudaGetLastError();
}

// The layers the kernel is built for (dispatch returns
// cudaErrorInvalidValue for any other; ops/cuda_conv3d.py raises on it):
// (CIA, CIB, CO, MODE, RELU, RES) and the tile TD x TH x TW and threads.
//   CostRegNet.conv0, CSPBlock.conv_cost   1 -> 8, stride 1
//   CostRegNet.conv1                        8 -> 8
//   CostRegNet.conv2                        8 -> 16, stride 2
//   CostRegNet.conv3                        16 -> 16
//   CostRegNet.conv4                        16 -> 32, stride 2
//   CostRegNet.conv5                        32 -> 32
//   CostRegNet.conv6 (+ conv3)              32 -> 16, transposed stride 2
//   CostRegNet.conv7 (+ conv1)              16 -> 8, transposed stride 2
//   CostRegNet.prob (no BN, no ReLU)        8 -> 1
//   CSPBlock.conv0                          1 -> 8, stride (1, 2, 2)
//   CSPBlock.conv1 ([down, emb])            8 + 8 -> 8
//   CSPBlock.conv2                          8 -> 1, transposed stride (1, 2, 2)
// Tiles: a class of outputs (a tile of a plain convolution) gives each
// thread one item (4 voxels x 8 channels, or 8 voxels of one), or each
// warp 1-8 m-tiles; the largest fp32 block (conv5's, one tile buffer
// beside its 110 KB of weights) takes 202 KB.
#define EFFI_REG_LAYERS(X)                  \
  X(1, 0, 8, 0, true, false, 4, 8, 32, 256)   \
  X(8, 0, 8, 0, true, false, 4, 8, 32, 256)   \
  X(8, 0, 16, 1, true, false, 2, 8, 16, 128)  \
  X(16, 0, 16, 0, true, false, 4, 8, 16, 256) \
  X(16, 0, 32, 1, true, false, 2, 4, 16, 128) \
  X(32, 0, 32, 0, true, false, 2, 8, 16, 256) \
  X(32, 0, 16, 3, true, true, 8, 8, 32, 128)  \
  X(16, 0, 8, 3, true, true, 8, 16, 32, 128)  \
  X(8, 0, 1, 0, false, false, 4, 8, 32, 128)  \
  X(1, 0, 8, 2, true, false, 4, 8, 32, 256)   \
  X(8, 8, 8, 0, true, false, 4, 8, 16, 128)   \
  X(8, 0, 1, 4, true, false, 4, 16, 32, 64)

template <typename T>
cudaError_t dispatch(int cia, int cib, int co, int mode, int relu, int has_res, const void* x,
                     const void* x2, const void* res, const float* w, const float* g,
                     const float* bb, const float* mean, const float* var, float eps, void* out,
                     int B, int Di, int Hi, int Wi, int Do, int Ho, int Wo, cudaStream_t s) {
#define EFFI_CASE(a, b, c, m, rl, rs, td, th, tw, nt)                                         \
  if (cia == a && cib == b && co == c && mode == m && (relu != 0) == rl &&                    \
      (has_res != 0) == rs)                                                                   \
    return launch<T, a, b, c, m, rl, rs, td, th, tw, nt>(x, x2, res, w, g, bb, mean, var, eps, \
                                                         out, B, Di, Hi, Wi, Do, Ho, Wo, s);
  EFFI_REG_LAYERS(EFFI_CASE)
#undef EFFI_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x (B, Di, Hi, Wi, cia), x2 (B, Di, Hi, Wi, cib) or null where cib = 0,
// res (B, Do, Ho, Wo, co) or null, out (B, Do, Ho, Wo, co): contiguous,
// of `dtype` (0 = float32, 1 = bfloat16), 16-byte aligned.  w: the
// layer's fp32 weights as the module holds them, contiguous; g, bb, mean,
// var: BN's fp32 weight, bias, running mean and running variance [co], all
// null for a plain convolution; eps: BN's.  (cia, cib, co, mode, relu,
// has_res) must be one of EFFI_REG_LAYERS.  Returns the launch's
// cudaGetLastError().
extern "C" int effi_conv3d_reg(const void* x, const void* x2, const void* res, const void* w,
                               const void* g, const void* bb, const void* mean, const void* var,
                               float eps, void* out, int B, int Di, int Hi, int Wi, int Do, int Ho,
                               int Wo, int cia, int cib, int co, int mode, int relu, int has_res,
                               int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return (int)dispatch<float>(cia, cib, co, mode, relu, has_res, x, x2, res, f(w), f(g), f(bb),
                                f(mean), f(var), eps, out, B, Di, Hi, Wi, Do, Ho, Wo, s);
  if (dtype == 1)
    return (int)dispatch<bf16>(cia, cib, co, mode, relu, has_res, x, x2, res, f(w), f(g), f(bb),
                               f(mean), f(var), eps, out, B, Di, Hi, Wi, Do, Ho, Wo, s);
  return (int)cudaErrorInvalidValue;
}
