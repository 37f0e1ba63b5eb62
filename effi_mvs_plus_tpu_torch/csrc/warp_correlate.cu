// Plane-sweep warp + correlation over all source views (kernel K1).
//
// Replaces the TPU kernel effi_mvs_plus_tpu/ops/pallas_warp.py::_kernel
// (launched by _plane_sweep_correlate_views, dispatched by
// warp_correlate_views_fused / _views_fwd_impl).  It computes
//
//   corr[b,v,d,y,x] = (1/C) * sum_c ref[b,y,x,c] * bilinear(src[b,v], px, py)[c]
//
// where (px, py) projects ref pixel (x, y0 + y) at depth[b,d,y,x] through
// rot[b,v] and trans[b,v]: ray = rot.[x,y0+y,1], xyz = ray*depth + trans, the
// z==0 -> z+1e-8 guard, px = xyz.x/z, py = xyz.y/z.  Bilinear sampling is
// grid_sample's align_corners=True / zeros padding: each out-of-image tap
// contributes 0, weights are not renormalised.  The projection and taps
// are those of warp_project.cuh, which the backward (K3) shares.
//
// Bound.  By bytes at stages 2-3 (about 10*C + 20 flops an output against
// 4-8 bytes written), by fp32 operations at the 48- and 96-hypothesis
// stage-1 sweeps in fp32.  What the card must do besides is read four
// C-vectors a (pixel, hypothesis), 512 bytes at C = 32 fp32: neighbouring
// pixels and hypotheses read the same source texels, and a gather through
// L1 with lanes 128 bytes apart spreads each 16-byte load over 32 lines.
//
// Design (warp_window.cuh).  A block of 128 threads owns an 8x16 ref tile
// of one (b, v) at a time, one thread a pixel with its ref C-vector in
// registers, and walks the hypotheses in chunks; where the tiles are too
// few to fill the card, a tile's chunks go to several blocks.  A chunk's
// window, the bounding box of its taps clipped to the budget, is staged
// into shared memory with cp.async, double-buffered: the next chunk's
// window is found and its copy issued before this chunk's math, so the
// copy overlaps it.  A texel is stored at a stride of an odd number of
// 16-byte units, so eight lanes' 16-byte loads from eight neighbouring
// texels fall in distinct bank groups.  The launch stages windows for a
// sweep of several chunks (stage 1) with texels of 64 bytes or more
// (ops/cuda_warp.py `window_plan`).  A sweep of one chunk (stages 2-3)
// and small texels take a second kernel with no window: 128 consecutive
// pixels a block, taps read from device memory through the read-only
// cache, no barrier; there a warp's gather costs less than staging
// (measured: PERF.md, section 6).
//
// Along the stage-1 sweep every pixel has the same depths, so the squares
// of a warp's pixels move together, by a fraction of a pixel a
// hypothesis: a thread keeps the four products ref . texel of its last
// 2x2 square and forms them anew only when the square moves (the products
// depend on the square alone, so this holds for any depths).  The direct
// kernel sums each (pixel, hypothesis)'s bilinear sample over C channels
// and takes one product with ref.  Arithmetic is fp32 for fp32 and bf16 features alike (bf16 texels are
// unpacked in registers); the output is stored once in the features'
// dtype.
//
// Row blocks.  The ref maps (ref, depth, out) hold Hr rows starting at
// row y0 of the reference, and the source maps all Hs rows: under spatial
// sharding a rank correlates its block of ref rows against the whole
// source features (y0 = 0, Hr = Hs otherwise).  A pixel's ray is formed
// from its global row y0 + y, as the whole image's, so a block's output
// is bitwise the whole image's rows; taps and windows clip to Hs.

#include "warp_window.cuh"

namespace {

using effi::from_f;
using effi::load_vec;
using effi::TILE_N;
using effi::TILE_W;
using effi::TILE_WARPS;
using effi::Window;

constexpr int kMaxSmem = 200 * 1024;
constexpr int kBlocksPerSm = 16;      // blocks to aim for an SM, over the waves of a launch

// 16-byte units a texel, and the window's texel stride in elements: an
// odd number of units (ops/cuda_warp.py `_window_stride`).
template <typename T, int C>
__host__ __device__ constexpr int window_stride() {
  return ((C * (int)sizeof(T) / 16) | 1) * (16 / (int)sizeof(T));
}

// C channels of a texel into fp32 registers (kGlobal: from device memory
// through the read-only cache, else from shared memory).
template <int C, bool kGlobal>
__device__ __forceinline__ void load_texel(const float* p, float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    const float4* q = reinterpret_cast<const float4*>(p) + i;
    const float4 f = kGlobal ? __ldg(q) : *q;
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}

template <int C, bool kGlobal>
__device__ __forceinline__ void load_texel(const __nv_bfloat16* p, float (&v)[C]) {
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    const uint4* q = reinterpret_cast<const uint4*>(p) + i;
    const uint4 f = kGlobal ? __ldg(q) : *q;
    const unsigned u[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(u[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// Copy the window's texels of one source map into buf (cp.async, 16 bytes
// a copy, the whole block).
template <typename T, int C>
__device__ __forceinline__ void stage_window(T* buf, const T* s, const Window& w, int W) {
  constexpr int E = 16 / (int)sizeof(T);   // elements in 16 bytes
  constexpr int U = C / E;                 // 16-byte units a texel
  constexpr int CP = window_stride<T, C>();
  const int n = w.w * w.h * U;
  for (int u = threadIdx.x; u < n; u += TILE_N) {
    const int t = u / U, k = u - t * U;
    const int ly = t / w.w, lx = t - ly * w.w;
    effi::cp_async16(buf + t * CP + k * E,
                     s + ((long long)(w.y0 + ly) * W + (w.x0 + lx)) * C + k * E);
  }
}

// One ref pixel of an 8x16 tile: where it is, and its ray and depths.
struct Pixel {
  int y, x;
  bool inside;
  effi::Ray ray;
  const float* dep;
};

__device__ __forceinline__ Pixel pixel_of(int tile, int tiles_x, int Hr, int W, int y0,
                                          const float* rot, const float* trans,
                                          const float* depth, long long dep_sh,
                                          long long dep_sw) {
  Pixel p;
  p.y = (tile / tiles_x) * effi::TILE_H + threadIdx.x / TILE_W;
  p.x = (tile % tiles_x) * TILE_W + threadIdx.x % TILE_W;
  p.inside = p.y < Hr && p.x < W;
  p.ray = effi::make_ray(rot, trans, p.x, y0 + p.y);
  p.dep = depth + (p.inside ? p.y * dep_sh + p.x * dep_sw : 0);
  return p;
}

// Where a tap of the square is read: its texel in the window, or, when
// the whole square lies in the window, `fast` and the texel of tap 0 (the
// others follow at +1, +w, +w+1).
__device__ __forceinline__ bool square_in_window(const effi::Taps& tp, const Window& w,
                                                 int& t0) {
  const int lx = tp.x0 - w.x0, ly = tp.y0 - w.y0;
  t0 = ly * w.w + lx;
  return tp.in[0] && tp.in[3] && lx >= 0 && ly >= 0 && lx + 1 < w.w && ly + 1 < w.h;
}

// Visit the square's taps in the image: f(k, pointer to its C channels,
// from device memory?) for each, from the window where it holds them.
// n counts the texels read from the window and from device memory.
template <typename T, int C, typename F>
__device__ __forceinline__ void for_taps(const effi::Taps& tp, const Window& win, const T* wb,
                                         const T* s, unsigned (&n)[2], F&& f) {
  constexpr int CP = window_stride<T, C>();
  int t0;
  if (square_in_window(tp, win, t0)) {
    const int ts[4] = {t0, t0 + 1, t0 + win.w, t0 + win.w + 1};
#pragma unroll
    for (int k = 0; k < 4; ++k) f(k, wb + ts[k] * CP, false);
    n[0] += 4;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int t;
    if (!tp.in[k]) continue;
    if (effi::in_window(win, tp.x0 + (k & 1), tp.y0 + (k >> 1), t)) {
      f(k, wb + t * CP, false);
      ++n[0];
    } else {
      f(k, s + (long long)tp.idx[k] * C, true);
      ++n[1];
    }
  }
}

// The windowed kernel: each thread keeps the products of its last square
// (see above).
template <typename T, int C>
__global__ void __launch_bounds__(TILE_N)
warp_correlate_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                      const float* __restrict__ rot, const float* __restrict__ trans,
                      const float* __restrict__ depth, T* __restrict__ out,
                      int V, int D, int Hr, int Hs, int W, int y0,
                      long long ref_bstride, long long src_bstride,
                      long long dep_sb, long long dep_sd, long long dep_sh,
                      long long dep_sw, int dc, int cap, int items_per_block,
                      unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[TILE_WARPS][4];
  __shared__ Window wins[2];
  constexpr int CP = window_stride<T, C>();
  T* const bufs = reinterpret_cast<T*>(smem);  // two of cap * CP

  const int HW = Hr * W;  // ref and output pixels
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int tiles = tiles_x * ((Hr + effi::TILE_H - 1) / effi::TILE_H);
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const float* R = rot + (b * V + v) * 9;
  const float* tr = trans + (b * V + v) * 3;
  const float* depth_b = depth + b * dep_sb;
  const T* s = src + b * src_bstride + (long long)v * Hs * W * C;
  const float inv_c = 1.0f / (float)C;
  // the block's work: items (tile, chunk) item0 .. item0 + items - 1 of
  // the (b, v) in order, the chunks of a tile in a row
  const int nch = (D + dc - 1) / dc;
  const int item0 = blockIdx.x * items_per_block;
  const int items = min(tiles * nch, item0 + items_per_block) - item0;

  // the window of item i, found by the block and written to wins[slot]
  auto item_window = [&](int i, int slot) {
    const int ch = (item0 + i) % nch;
    const Pixel p = pixel_of((item0 + i) / nch, tiles_x, Hr, W, y0, R, tr, depth_b, dep_sh,
                             dep_sw);
    effi::Box box = effi::empty_box();
    if (p.inside)
      effi::box_add_span(box, p.ray, __ldg(p.dep + ch * dc * dep_sd),
                         __ldg(p.dep + (min(D, (ch + 1) * dc) - 1) * dep_sd), Hs, W);
    return effi::block_window(box, cap, red, &wins[slot]);
  };

  unsigned n[2] = {0u, 0u};  // texels read from the window, from device memory
  Pixel px{};
  int tile = -1;
  float r[C];
  // the products of the last square, at corner (cx, cy), where `have`
  bool have = false;
  int cx = 0, cy = 0;
  float dk[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  stage_window<T, C>(bufs, s, item_window(0, 0), W);
  effi::cp_async_commit();
  for (int i = 0; i < items; ++i) {
    const int cur = i & 1;
    if (i + 1 < items) {
      stage_window<T, C>(bufs + (cur ^ 1) * cap * CP, s, item_window(i + 1, cur ^ 1), W);
      effi::cp_async_commit();
      effi::cp_async_wait<1>();
    } else {
      effi::cp_async_wait<0>();
    }
    if (tile != (item0 + i) / nch) {  // a new tile: its pixel, ray and ref vector
      tile = (item0 + i) / nch;
      px = pixel_of(tile, tiles_x, Hr, W, y0, R, tr, depth_b, dep_sh, dep_sw);
      if (px.inside) {
        load_vec<C>(ref + b * ref_bstride + ((long long)px.y * W + px.x) * C, r);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) r[c] = 0.0f;
      }
      have = false;
    }
    __syncthreads();
    const Window win = wins[cur];
    const T* wb = bufs + cur * cap * CP;
    if (px.inside) {
      const int ch = (item0 + i) % nch;
      const int d1 = min(D, (ch + 1) * dc);
      T* o = out + ((long long)(b * V + v) * D) * HW + px.y * W + px.x;
      for (int d = ch * dc; d < d1; ++d) {
        const effi::Taps tp = effi::taps_at(px.ray, __ldg(px.dep + d * dep_sd), Hs, W);
        if (!tp.any) {
          have = false;
        } else if (!have || tp.x0 != cx || tp.y0 != cy) {
          have = true;
          cx = tp.x0;
          cy = tp.y0;
#pragma unroll
          for (int k = 0; k < 4; ++k) dk[k] = 0.0f;
          for_taps<T, C>(tp, win, wb, s, n, [&](int k, const T* p, bool global) {
            float t[C];
            if (global) load_texel<C, true>(p, t); else load_texel<C, false>(p, t);
            float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int c = 0; c < C; ++c) a[c & 3] += r[c] * t[c];
            dk[k] = (a[0] + a[1]) + (a[2] + a[3]);
          });
        }
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc += tp.in[k] ? tp.w[k] * dk[k] : 0.0f;
        from_f(acc * inv_c, o + (long long)d * HW);
      }
    }
    __syncthreads();  // wins[cur] and its buffer are free for item i + 2
  }
  effi::add_stats<2>(stats, n);
}

// The same function without windows, for texels under 64 bytes: one
// thread a pixel of 128 consecutive pixels a block, its ref C-vector in
// registers; each (pixel, hypothesis) gathers its four taps through the
// read-only cache, where 16- to 32-byte texels gather well, and sums its
// bilinear sample over C channels.  n counts the texels read, all from
// device memory.
template <typename T, int C>
__global__ void __launch_bounds__(TILE_N)
warp_correlate_direct_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                             const float* __restrict__ rot, const float* __restrict__ trans,
                             const float* __restrict__ depth, T* __restrict__ out,
                             int V, int D, int Hr, int Hs, int W, int y0, long long ref_bstride,
                             long long src_bstride, long long dep_sb, long long dep_sd,
                             long long dep_sh, long long dep_sw,
                             unsigned long long* __restrict__ stats) {
  const int HW = Hr * W;  // ref and output pixels
  const int pix = blockIdx.x * TILE_N + threadIdx.x;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  unsigned n[2] = {0u, 0u};
  if (pix < HW) {
    const int y = pix / W;
    const int x = pix - y * W;
    float r[C];
    load_vec<C>(ref + b * ref_bstride + (long long)pix * C, r);
    const effi::Ray ray =
        effi::make_ray(rot + (b * V + v) * 9, trans + (b * V + v) * 3, x, y0 + y);
    const T* s = src + b * src_bstride + (long long)v * Hs * W * C;
    const float* dep = depth + b * dep_sb + y * dep_sh + x * dep_sw;
    T* o = out + ((long long)(b * V + v) * D) * HW + pix;
    const float inv_c = 1.0f / (float)C;
    for (int d = 0; d < D; ++d) {
      const effi::Taps tp = effi::taps_at(ray, __ldg(dep + d * dep_sd), Hs, W);
      float smp[C];
#pragma unroll
      for (int c = 0; c < C; ++c) smp[c] = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (tp.idx[k] < 0) continue;
        float t[C];
        load_texel<C, true>(s + (long long)tp.idx[k] * C, t);
#pragma unroll
        for (int c = 0; c < C; ++c) smp[c] += t[c] * tp.w[k];
        ++n[1];
      }
      float acc = 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) acc += smp[c] * r[c];
      from_f(acc * inv_c, o + (long long)d * HW);
    }
  }
  effi::add_stats<2>(stats, n);
}

// dynamic shared memory a block: two windows
template <typename T, int C>
int smem_bytes(int cap) {
  return 2 * cap * window_stride<T, C>() * (int)sizeof(T);
}

template <typename T, int C>
cudaError_t launch_windows(const void* ref, const void* src, const void* rot,
                           const void* trans, const void* depth, void* out, int B,
                           int V, int D, int Hr, int Hs, int W, int y0, long long ref_bs,
                           long long src_bs, const long long* ds, int dc, int cap,
                           unsigned long long* stats, cudaStream_t stream) {
  const int bytes = smem_bytes<T, C>(cap);
  if (dc < 1 || cap < 1 || bytes > kMaxSmem) return cudaErrorInvalidValue;
  static unsigned sized = 0;           // devices whose attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 31) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(warp_correlate_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    sized |= 1u << (dev & 31);
  }
  // A block's items: a tile's chunks, split over blocks where the tiles
  // alone give an SM fewer than kBlocksPerSm blocks (the 64x80 training
  // maps: 640 blocks for 132 SMs).
  const int tiles = ((Hr + effi::TILE_H - 1) / effi::TILE_H) * ((W + TILE_W - 1) / TILE_W);
  const int nch = (D + dc - 1) / dc;
  static int sms = 0;
  if (sms == 0) cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)kBlocksPerSm * max(sms, 1);
  const int split = (int)min((long long)nch, max(1LL, (want + (long long)tiles * V * B - 1) /
                                                        ((long long)tiles * V * B)));
  const int per_block = (nch + split - 1) / split;
  dim3 grid((tiles * nch + per_block - 1) / per_block, V, B);
  warp_correlate_kernel<T, C><<<grid, TILE_N, bytes, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<T*>(out), V, D, Hr, Hs, W, y0,
      ref_bs, src_bs, ds[0], ds[1], ds[2], ds[3], dc, cap, per_block, stats);
  return cudaGetLastError();
}

template <typename T, int C>
cudaError_t launch(const void* ref, const void* src, const void* rot,
                   const void* trans, const void* depth, void* out, int B,
                   int V, int D, int Hr, int Hs, int W, int y0, long long ref_bs,
                   long long src_bs, const long long* ds, int dc, int cap,
                   unsigned long long* stats, cudaStream_t stream) {
  if (cap == 0) {
    dim3 grid((Hr * W + TILE_N - 1) / TILE_N, V, B);
    warp_correlate_direct_kernel<T, C><<<grid, TILE_N, 0, stream>>>(
        static_cast<const T*>(ref), static_cast<const T*>(src),
        static_cast<const float*>(rot), static_cast<const float*>(trans),
        static_cast<const float*>(depth), static_cast<T*>(out), V, D, Hr, Hs, W, y0,
        ref_bs, src_bs, ds[0], ds[1], ds[2], ds[3], stats);
    return cudaGetLastError();
  }
  return launch_windows<T, C>(ref, src, rot, trans, depth, out, B, V, D, Hr, Hs, W, y0, ref_bs,
                             src_bs, ds, dc, cap, stats, stream);
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, const void* src,
                       const void* rot, const void* trans, const void* depth,
                       void* out, int B, int V, int D, int Hr, int Hs, int W,
                       int y0, long long ref_bs, long long src_bs, const long long* ds,
                       int dc, int cap, unsigned long long* stats,
                       cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(ref, src, rot, trans, depth, out, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    case 16: return launch<T, 16>(ref, src, rot, trans, depth, out, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    case 32: return launch<T, 32>(ref, src, rot, trans, depth, out, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ref, depth and out hold Hr rows
// from ref row y0, src all Hs rows (all rows: y0 = 0, Hr = Hs).  Strides
// in elements; depth_strides
// holds the (b, d, y, x) strides of the depth tensor, so an expanded
// per-batch sweep (strides (D, 1, 0, 0)) is read without a copy.  dc: the
// hypotheses of a chunk; cap: the texels of a window (ops/cuda_warp.py
// `window_plan`).  stats, when not null, gains the taps read from the
// windows and from device memory.  Returns the launch's
// cudaGetLastError().
extern "C" int effi_warp_correlate(const void* ref, const void* src,
                                   const void* rot, const void* trans,
                                   const void* depth, void* out, int B,
                                   int V, int D, int Hr, int Hs, int W,
                                   int C, int y0, long long ref_bstride,
                                   long long src_bstride,
                                   long long dep_sb, long long dep_sd,
                                   long long dep_sh, long long dep_sw,
                                   int dc, int cap, void* stats,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ds[4] = {dep_sb, dep_sd, dep_sh, dep_sw};
  auto* st = static_cast<unsigned long long*>(stats);
  if (dtype == 0)
    return (int)dispatch_c<float>(C, ref, src, rot, trans, depth, out, B, V,
                                  D, Hr, Hs, W, y0, ref_bstride, src_bstride,
                                  ds, dc, cap, st, s);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(C, ref, src, rot, trans, depth,
                                          out, B, V, D, Hr, Hs, W, y0,
                                          ref_bstride, src_bstride, ds, dc,
                                          cap, st, s);
  return (int)cudaErrorInvalidValue;
}
