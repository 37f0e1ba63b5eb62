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
// Design: one block per TH x TW output tile of one image, built from
// csrc/conv3x3_tile.cuh.
//   0. the input tile plus an L-pixel halo is staged in shared memory,
//      channels-last in the input type, zero outside the image;
//   1. layer i computes its output over the tile plus an (L-1-i)-pixel
//      halo (the ring is recomputed by the neighbouring block too, as the
//      TPU kernel recomputes its strip halo) and keeps it in shared
//      memory in the input type, zero outside the image: in bf16 exactly
//      the TPU kernel's rounding, and what the next layer's ldmatrix reads;
//   2. only the last layer is written to device memory.
// So x is read once and the chain's output written once; the intermediate
// activations never leave the SM.  Each layer's weights stream through a
// double buffer one stage at a time, the next stage's copy under this
// one's math; a stage is the whole layer where it is small, else 3 taps or
// one (conv3x3_tile.cuh units_per_stage; units are taps, or tap pairs for
// 8-channel layers on the tensor cores).
//
// Bound.  A layer does 18 Ci Co flops a pixel.  The FPN chains have
// Ci = Co = 8..64 (conv0: 3 -> 8 -> 8), so a pixel of a chain costs
// 18 (C0 C1 + C1 C2) flops against (C0 + C2) elements of compulsory
// traffic: in fp32 40-576 flops a byte, above the ridge of 20, bound by
// the fp32 FMA rate; in bf16 the chains up to 16 channels are bound by
// bytes, the 32- and 64-channel chains by the tensor cores.
//
// Routes, a layer at a time: bf16 layers with 8 or more input and output
// channels on the tensor cores (mma.sync; a warp owns m16 tiles of 16
// consecutive region pixels across all output channels); fp32 layers,
// and bf16 layers with fewer than 8 channels (the 3-channel first layers
// and the 3-4-4 chain), on the CUDA cores (a thread owns 4 pixels x 8
// output channels, 4 where a layer has 4).  Tiles: 16x32 up to 16
// channels (bf16: up to 32), else 16x16; the first layer's halo
// recompute is 20% at 16x32 and 27% at 16x16.  256 threads a block, 128
// up to 8 channels (more blocks an SM for the chains whose layers are
// short).

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A layer's route and weight stages (CO = 0: no layer)
template <typename T, int CI, int CO>
struct Layer {
  static constexpr bool MMA = kMma<T> && CI >= 8 && CO >= 8;
  static constexpr bool PAIR = MMA && CI == 8;          // two taps a k16 step
  static constexpr int KST = PAIR ? 1 : CI / 16;        // k16 steps a unit
  static constexpr int NU = PAIR ? 5 : 9;               // units: taps or pairs
  static constexpr int UB = MMA ? KST * (CO / 8) * 256 : (CI + 3) / 4 * 4 * CO * 4;
  static constexpr int G = units_per_stage(NU, UB);     // units a stage
  static constexpr int NSTG = CO == 0 ? 0 : NU / G;
  static constexpr int SB = G * UB;                     // bytes a stage
  static_assert(!MMA || PAIR || CI % 16 == 0, "mma layers take 8 or 16k channels");
};

// Geometry of a chain (C3 = 0 for two layers, C2 = C3 = 0 for one).
template <typename T, int C0, int C1, int C2, int C3>
struct Chain {
  static constexpr int L = C3 ? 3 : (C2 ? 2 : 1);
  static constexpr int CM = cmax(cmax(C0, C1), cmax(C2, C3));
  static constexpr int TH = 16;
  static constexpr int TW = CM <= (kMma<T> ? 32 : 16) ? 32 : 16;
  static constexpr int NT = CM <= 8 ? 128 : 256;
  using L0 = Layer<T, C0, C1>;
  using L1 = Layer<T, C1, C2>;
  using L2 = Layer<T, C2, C3>;
  static constexpr int N0 = L0::NSTG, N1 = L1::NSTG, N2 = L2::NSTG, NS = N0 + N1 + N2;
  static constexpr int WST = L0::SB > L1::SB ? (L0::SB > L2::SB ? L0::SB : L2::SB)
                                             : (L1::SB > L2::SB ? L1::SB : L2::SB);
  // buffer k (k = 0: the staged input; k = i + 1: layer i's output) spans
  // the tile plus an (L - k)-pixel halo
  __host__ __device__ static constexpr int RH(int k) { return TH + 2 * (L - k); }
  __host__ __device__ static constexpr int RW(int k) { return TW + 2 * (L - k); }
  __host__ __device__ static constexpr int R(int k) { return RH(k) * RW(k); }
  static constexpr int S0 = pixel_stride<T>(C0), S1 = pixel_stride<T>(C1),
                       S2 = pixel_stride<T>(C2);
  static constexpr int E0 = R(0) * S0, E1 = L >= 2 ? R(1) * S1 : 0,
                       E2 = L >= 3 ? R(2) * S2 : 0;
  static constexpr int smem_bytes() { return (E0 + E1 + E2) * (int)sizeof(T) + 2 * WST; }
  __device__ static int off(int s) {
    return s < N0 ? s * L0::SB
                  : (s < N0 + N1 ? N0 * L0::SB + (s - N0) * L1::SB
                                 : N0 * L0::SB + N1 * L1::SB + (s - N0 - N1) * L2::SB);
  }
  __device__ static int bytes(int s) {
    return s < N0 ? L0::SB : (s < N0 + N1 ? L1::SB : L2::SB);
  }
};

// One layer: output over an OH x OW region whose input is the
// (OH + 2) x (OW + 2) tile `in` (stride SIN).  (gy0, gx0) is the image
// position of the region's top-left pixel.  Not LAST: relu(acc + b),
// rounded to T and zero outside the image, into the tile `out_s` (stride
// SOUT); LAST: the in-image pixels into out_g (B, H, W, CO).  Its weight
// stages are s0 .. s0 + NSTG - 1 of the chain's NS.
template <typename G, int CI, int CO, int OH, int OW, int SIN, int SOUT, bool LAST, typename T>
__device__ __forceinline__ void layer(const T* in, T* out_s, T* __restrict__ out_g,
                                      const char* __restrict__ w, char* wbuf, int s0,
                                      const float* __restrict__ bias, int b, int gy0, int gx0,
                                      int H, int W) {
  using Ly = Layer<T, CI, CO>;
  constexpr int NT = G::NT, IW = OW + 2, NPIX = OH * OW;
  auto off = [](int s) { return G::off(s); };
  auto bytes = [](int s) { return G::bytes(s); };
  // region pixel pix: its output element offset g, and whether it lies in
  // the image (outside, an intermediate is the next layer's zero padding)
  auto where = [&](int pix, long long& g) {
    const int oy = pix / OW, ox = pix - oy * OW, gy = gy0 + oy, gx = gx0 + ox;
    g = ((long long)(b * H + gy) * W + gx) * CO;
    return gy >= 0 && gy < H && gx >= 0 && gx < W;
  };

  if constexpr (Ly::MMA) {
    constexpr int NTL = CO / 8, NW = NT / 32, MT = ceil_div(NPIX, 16);
    constexpr int IPT = ceil_div(MT, NW);
    const int warp = threadIdx.x >> 5;
    const int hl = (threadIdx.x & 31) >> 4;            // this lane's k half
    const uint32_t in_a = smem_addr(in);
    uint32_t row[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i)
      row[i] = mma_row<SIN>(in_a, warp + NW * i, OW, NPIX, IW, 0, 0, Ly::PAIR ? 0 : 16 * hl);
    float acc[IPT][NTL][4] = {};
    pipeline<NT, G::WST>(s0, s0 + Ly::NSTG, G::NS, w, wbuf, off, bytes,
                         [&](int t, const char* ws) {
#pragma unroll 1
      for (int u = 0; u < Ly::G; ++u) {
        const int unit = t * Ly::G + u;
        int tap = Ly::PAIR ? 2 * unit + hl : unit;
        tap = tap < 9 ? tap : 8;                       // the zero-weight 10th tap
        const int dy = tap / 3, dx = tap - 3 * dy;
        mma_stage<IPT, NTL, Ly::KST>(acc, row, (dy * IW + dx) * SIN * 2,
                                     reinterpret_cast<const uint2*>(ws + u * Ly::UB));
      }
    });
#pragma unroll
    for (int i = 0; i < IPT; ++i)
#pragma unroll
      for (int n = 0; n < NTL; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = mma_acc_row(warp + NW * i, hh);
          if (m >= NPIX) continue;
          const int c = mma_acc_col(n);
          long long g;
          const bool inside = where(m, g);
          const float v0 = inside ? fmaxf(acc[i][n][2 * hh] + bias[c], 0.0f) : 0.0f;
          const float v1 = inside ? fmaxf(acc[i][n][2 * hh + 1] + bias[c + 1], 0.0f) : 0.0f;
          if constexpr (LAST) {
            if (inside)
              *reinterpret_cast<__nv_bfloat162*>(out_g + g + c) = __floats2bfloat162_rn(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(out_s + m * SOUT + c) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
  } else {
    constexpr int NP = 4, NC = CO < 8 ? CO : 8, NCG = CO / NC;
    constexpr int NPG = ceil_div(NPIX, NP), IPT = ceil_div(NPG * NCG, NT);
    static_assert(CO % NC == 0, "output channels");
    int offs[IPT][NP], co[IPT];
    bool ok[IPT];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int item = threadIdx.x + NT * i;
      ok[i] = item < NPG * NCG;
      const int it = ok[i] ? item : 0;
      co[i] = (it / NPG) * NC;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        int pix = it % NPG + NPG * p;
        pix = pix < NPIX ? pix : NPIX - 1;
        const int oy = pix / OW, ox = pix - oy * OW;
        offs[i][p] = (oy * IW + ox) * SIN;
      }
    }
    float acc[IPT][NP][NC] = {};
    pipeline<NT, G::WST>(s0, s0 + Ly::NSTG, G::NS, w, wbuf, off, bytes,
                         [&](int t, const char* ws) {
#pragma unroll 1
      for (int u = 0; u < Ly::G; ++u) {
        const int tap = t * Ly::G + u, dy = tap / 3, dx = tap - 3 * dy;
        fma_tap<T, CI, CO, IPT, NP, NC>(acc, in + (dy * IW + dx) * SIN, offs, co,
                                        reinterpret_cast<const float*>(ws + u * Ly::UB));
      }
    });
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (!ok[i]) continue;
      float bv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) bv[j] = bias[co[i] + j];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const int pix = (threadIdx.x + NT * i) % NPG + NPG * p;
        if (pix >= NPIX) continue;
        long long g;
        const bool inside = where(pix, g);
        if (LAST && !inside) continue;
#pragma unroll
        for (int j = 0; j < NC; j += 4) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = inside ? fmaxf(acc[i][p][j + e] + bv[j + e], 0.0f) : 0.0f;
          store4(LAST ? out_g + g + co[i] + j : out_s + pix * SOUT + co[i] + j, v);
        }
      }
    }
  }
}

template <typename T, int C0, int C1, int C2, int C3>
__global__ void __launch_bounds__(Chain<T, C0, C1, C2, C3>::NT)
conv_chain_kernel(const T* __restrict__ x, const char* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, int H, int W) {
  using G = Chain<T, C0, C1, C2, C3>;
  constexpr int L = G::L, TH = G::TH, TW = G::TW;
  extern __shared__ __align__(16) char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);                      // [R(0)][S0]
  T* buf1 = buf0 + G::E0;                                    // [R(1)][S1]
  T* buf2 = buf1 + G::E1;                                    // [R(2)][S2]
  char* wbuf = reinterpret_cast<char*>(buf2 + G::E2);

  const int b = blockIdx.z;
  const int ty0 = blockIdx.y * TH;
  const int tx0 = blockIdx.x * TW;

  stage<T, C0, G::S0, G::NT>(buf0, x, b, ty0 - L, tx0 - L, G::RH(0), G::RW(0), H, W);
  copy_async<G::NT>(wbuf, w, G::bytes(0));
  cp_async_commit();

  layer<G, C0, C1, G::RH(1), G::RW(1), G::S0, G::S1, L == 1>(
      buf0, buf1, out, w, wbuf, 0, bias, b, ty0 - (L - 1), tx0 - (L - 1), H, W);
  if constexpr (L >= 2)
    layer<G, C1, C2, G::RH(2), G::RW(2), G::S1, G::S2, L == 2>(
        buf1, buf2, out, w, wbuf, G::N0, bias + C1, b, ty0 - (L - 2), tx0 - (L - 2), H, W);
  if constexpr (L >= 3)
    layer<G, C2, C3, TH, TW, G::S2, G::S2, true>(
        buf2, static_cast<T*>(nullptr), out, w, wbuf, G::N0 + G::N1, bias + C1 + C2, b, ty0, tx0, H, W);
}

template <typename T, int C0, int C1, int C2, int C3>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int B, int H,
                   int W, cudaStream_t stream) {
  using G = Chain<T, C0, C1, C2, C3>;
  static unsigned sized = 0;           // devices whose attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 31) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(conv_chain_kernel<T, C0, C1, C2, C3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G::smem_bytes());
    if (e != cudaSuccess) return e;
    sized |= 1u << (dev & 31);
  }
  dim3 grid((W + G::TW - 1) / G::TW, (H + G::TH - 1) / G::TH, B);
  conv_chain_kernel<T, C0, C1, C2, C3><<<grid, G::NT, G::smem_bytes(), stream>>>(
      static_cast<const T*>(x), static_cast<const char*>(w), static_cast<const float*>(bias),
      static_cast<T*>(out), H, W);
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
cudaError_t dispatch(int c0, int c1, int c2, int c3, const void* x, const void* w,
                     const void* bias, void* out, int B, int H, int W, cudaStream_t s) {
#define EFFI_CASE(a, b, c, d)                   \
  if (c0 == a && c1 == b && c2 == c && c3 == d) \
    return launch<T, a, b, c, d>(x, w, bias, out, B, H, W, s);
  EFFI_CHAINS(EFFI_CASE)
#undef EFFI_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// x, out: contiguous (B, H, W, c0) and (B, H, W, c_last) of `dtype`
// (0 = float32, 1 = bfloat16), 16-byte aligned.  Channels c0..c3 (0 past
// the last layer) must be one of EFFI_CHAINS.  w: the wrapper's packed
// weights (ops/cuda_conv.py `pack_weights`), layer by layer, each layer's
// stages in its route's layout (conv3x3_tile.cuh); bias: fp32, layer by
// layer [Co].  Returns the launch's cudaGetLastError().
extern "C" int effi_conv_chain(const void* x, const void* w, const void* bias, void* out,
                               int B, int H, int W, int c0, int c1, int c2, int c3, int dtype,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(c0, c1, c2, c3, x, w, bias, out, B, H, W, s);
  if (dtype == 1) return (int)dispatch<bf16>(c0, c1, c2, c3, x, w, bias, out, B, H, W, s);
  return (int)cudaErrorInvalidValue;
}
