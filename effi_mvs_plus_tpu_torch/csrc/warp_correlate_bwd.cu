// Backward of the plane-sweep warp + correlation (kernel K3).
//
// Replaces the TPU kernel effi_mvs_plus_tpu/ops/pallas_warp.py::_bwd_kernel
// (launched by _plane_sweep_correlate_views_bwd, dispatched by the
// custom_vjp backward _views_bwd).  With g the cotangent of the
// correlations corr[b,v,d,y,x] (K1, warp_correlate.cu) it computes
//
//   d_ref[b,y,x,c] = sum_{v,d} (g[b,v,d,y,x]/C) * bilinear(src[b,v], px, py)[c]
//   d_src[b,v,q,c] = sum_{d,y,x} (g[b,v,d,y,x]/C) * ref[b,y,x,c] * w_q
//
// where q runs over the four bilinear taps of (px, py) with weights w_q,
// out-of-image taps dropped.  As in K1, the ref maps (ref, g, d_ref) hold
// Hr rows from ref row y0 and the source maps (src, d_src) all Hs rows, a
// pixel's ray is formed from its global row y0 + y, and taps and windows
// clip to Hs.  The projection grid gets no gradient (the
// rotations, translations and depths are constants of the warp), so the
// taps and weights are those of the forward, from the same code
// (warp_project.cuh): a coordinate rounded differently here would move a
// tap across a pixel boundary.
//
// Bound.  The bytes the function must move (features and depth read, g
// read once, both gradients written once) take tens of microseconds at the
// training shapes.  What sets the pace is the scatter into d_src: 4 taps x
// C adds a (b, v, d, pixel), and neighbouring hypotheses of one ray and
// neighbouring pixels land on the same source texels.
//
// Design (warp_window.cuh).  A block of 128 threads owns an 8x16 ref tile
// of one (b, v) and walks the hypotheses in chunks; blocks over (tile,
// view, batch) fill the card at the training shapes.  For each chunk:
//
// 1. each thread projects its pixel at the chunk's hypotheses and writes
//    a record a (pixel, hypothesis) to shared memory: the corner of its
//    2x2 square of taps, which of the four lie in the image, and (g/C) * w
//    for each; the block takes the chunk's window from the same taps;
// 2. the window's d_src, fp32 in shared memory, is zeroed;
// 3. each warp walks its 32 pixels with the channels across its lanes
//    (C = 32: one pixel at a time; 16 and 8: two and four), so a warp's
//    source loads and adds land on whole texels.  Along a pixel's
//    hypotheses, while its square stays the same, a lane sums
//    (g/C) * w * ref[c] for each tap in registers and accumulates
//    (g/C) * w * src[c] into the pixel's d_ref; when the square moves, it
//    adds the four sums into the window with shared-memory atomics, or,
//    for a tap outside the window, straight into d_src in device memory;
// 4. the window is added to d_src in one coalesced pass, skipping texels
//    that received nothing.
//
// d_ref is summed over d in registers, written as a per-view fp32 partial,
// and summed over the views in a fixed order by a second launch, so it is
// the same bits on every run.  d_src goes through atomics: its last bits
// vary from run to run.

#include "warp_window.cuh"

namespace {

using effi::from_f;
using effi::to_f;
using effi::TILE_N;
using effi::TILE_W;
using effi::TILE_WARPS;
using effi::Window;

// One (pixel, hypothesis): (key, mask), the corner of the square of taps
// as ((y0 + 1) << 16 | (x0 + 1)) or -1 where no tap lies in the image,
// and a bit for each tap in the image; and (g/C) * w for each tap (0 out
// of the image).
struct KeyMask {
  int key, mask;
};

// d_src += v at a 16-byte aligned fp32 address in device memory: one
// vector reduction (sm_90's REDG.ADD.F32x4)
__device__ __forceinline__ void add4_global(float* p, const float4& v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

template <typename T, int C>
__global__ void __launch_bounds__(TILE_N)
warp_correlate_bwd_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                          const float* __restrict__ rot,
                          const float* __restrict__ trans,
                          const float* __restrict__ depth,
                          const T* __restrict__ g, float* __restrict__ part,
                          float* __restrict__ d_src, int V, int D, int Hr,
                          int Hs, int W, int y0, long long ref_bstride,
                          long long src_bstride,
                          long long dep_sb, long long dep_sd,
                          long long dep_sh, long long dep_sw, int dc, int cap,
                          unsigned long long* __restrict__ stats) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[TILE_WARPS][4];
  __shared__ Window wslot;
  float4* const gws = reinterpret_cast<float4*>(smem);           // dc * TILE_N
  KeyMask* const keys = reinterpret_cast<KeyMask*>(gws + dc * TILE_N);
  float* const win = reinterpret_cast<float*>(keys + dc * TILE_N);  // cap * C

  const int HW = Hr * W;  // ref pixels
  const int tiles_x = (W + TILE_W - 1) / TILE_W;
  const int ty0 = (blockIdx.x / tiles_x) * effi::TILE_H;
  const int tx0 = (blockIdx.x % tiles_x) * TILE_W;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  const T* s = src + b * src_bstride + (long long)v * Hs * W * C;
  float* ds = d_src + (long long)(b * V + v) * Hs * W * C;
  const float inv_c = 1.0f / (float)C;

  // projection role: thread -> pixel of the tile
  const int y = ty0 + threadIdx.x / TILE_W;
  const int x = tx0 + threadIdx.x % TILE_W;
  const bool inside = y < Hr && x < W;
  const effi::Ray ray = effi::make_ray(rot + (b * V + v) * 9,
                                       trans + (b * V + v) * 3, x, y0 + y);
  const float* dep = depth + b * dep_sb + (inside ? y * dep_sh + x * dep_sw : 0);
  const T* gv = g + ((long long)(b * V + v) * D) * HW + (inside ? y * W + x : 0);

  // scatter role: lane = (pixel group, channel); the warp's pixels
  // 32 * warp + i * NP + grp, i < C, are those of its own projections
  constexpr int NP = 32 / C;
  const int warp = threadIdx.x / 32;
  const int grp = (threadIdx.x % 32) / C;
  const int c = threadIdx.x % C;
  float rr[C], dr[C];
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int p = 32 * warp + i * NP + grp;
    const int py = ty0 + p / TILE_W, px = tx0 + p % TILE_W;
    rr[i] = (py < Hr && px < W)
                ? to_f(ref[b * ref_bstride + ((long long)py * W + px) * C + c]) : 0.0f;
    dr[i] = 0.0f;
  }

  unsigned n[3] = {0u, 0u, 0u};  // adds into the window, into d_src, of the flush
  const int nch = (D + dc - 1) / dc;
  for (int ch = 0; ch < nch; ++ch) {
    const int d0 = ch * dc, nd = min(dc, D - d0);
    // 1. records and window
    effi::Box box = effi::empty_box();
#pragma unroll
    for (int dd = 0; dd < effi::MAX_CHUNK; ++dd) {
      if (dd >= nd) break;
      KeyMask km{-1, 0};
      float4 gw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (inside) {
        const int d = d0 + dd;
        const effi::Taps tp = effi::taps_at(ray, __ldg(dep + d * dep_sd), Hs, W);
        effi::box_add(box, tp, Hs, W);
        if (tp.any) {
          const float gd = to_f(gv[(long long)d * HW]) * inv_c;
          km.key = ((tp.y0 + 1) << 16) | (tp.x0 + 1);
          float* w = &gw.x;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (tp.idx[k] < 0) continue;
            km.mask |= 1 << k;
            w[k] = gd * tp.w[k];
          }
        }
      }
      keys[dd * TILE_N + threadIdx.x] = km;
      gws[dd * TILE_N + threadIdx.x] = gw;
    }
    const Window wnd = effi::block_window(box, cap, red, &wslot);
    // 2. zero the window
    const int n4 = wnd.w * wnd.h * (C / 4);
    float4* win4 = reinterpret_cast<float4*>(win);
    for (int u = threadIdx.x; u < n4; u += TILE_N) win4[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    // 3. scatter, a run of hypotheses on one square at a time
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int p = 32 * warp + i * NP + grp;
      int key = -1, mask = 0, sx = 0, sy = 0;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      auto flush = [&]() {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(mask >> k & 1)) continue;
          const int tx = sx + (k & 1), ty = sy + (k >> 1);
          int t;
          if (effi::in_window(wnd, tx, ty, t)) {
            atomicAdd(win + t * C + c, acc[k]);
            ++n[0];
          } else {
            atomicAdd(ds + ((long long)ty * W + tx) * C + c, acc[k]);
            ++n[1];
          }
        }
      };
      for (int dd = 0; dd < nd; ++dd) {
        const KeyMask km = keys[dd * TILE_N + p];
        if (km.key != key) {
          flush();
          key = km.key;
          mask = km.mask;
          sx = (key & 0xffff) - 1;
          sy = (key >> 16) - 1;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            acc[k] = 0.0f;
            sv[k] = (mask >> k & 1)
                        ? to_f(s[((long long)(sy + (k >> 1)) * W + sx + (k & 1)) * C + c]) : 0.0f;
          }
        }
        const float4 g4 = gws[dd * TILE_N + p];
        const float gw[4] = {g4.x, g4.y, g4.z, g4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc[k] += gw[k] * rr[i];
          dr[i] += gw[k] * sv[k];
        }
      }
      flush();
    }
    __syncthreads();
    // 4. flush the window
    for (int u = threadIdx.x; u < n4; u += TILE_N) {
      const float4 a = win4[u];
      if (a.x == 0.0f && a.y == 0.0f && a.z == 0.0f && a.w == 0.0f) continue;
      const int t = u / (C / 4), k4 = u - t * (C / 4);
      const int ly = t / wnd.w, lx = t - ly * wnd.w;
      add4_global(ds + ((long long)(wnd.y0 + ly) * W + (wnd.x0 + lx)) * C + 4 * k4, a);
      n[2] += 4;
    }
    __syncthreads();          // records and window are free for the next chunk
  }

  // per-view d_ref partial (B, V, H, W, C)
  float* pv = part + (long long)(b * V + v) * HW * C;
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int p = 32 * warp + i * NP + grp;
    const int py = ty0 + p / TILE_W, px = tx0 + p % TILE_W;
    if (py < Hr && px < W) pv[((long long)py * W + px) * C + c] = dr[i];
  }
  effi::add_stats<3>(stats, n);
}

// d_ref[b] = sum over v of part[b, v], in order, in the features' dtype;
// n = H * W * C elements a view, four a thread.
template <typename T>
__global__ void __launch_bounds__(256)
dref_sum_kernel(const float* __restrict__ part, T* __restrict__ d_ref, int V, long long n) {
  const long long i = ((long long)blockIdx.x * 256 + threadIdx.x) * 4;
  if (i >= n) return;
  const int b = blockIdx.y;
  const float* p = part + (long long)b * V * n + i;
  float4 acc = *reinterpret_cast<const float4*>(p);
  for (int v = 1; v < V; ++v) {
    const float4 a = *reinterpret_cast<const float4*>(p + (long long)v * n);
    acc.x += a.x; acc.y += a.y; acc.z += a.z; acc.w += a.w;
  }
  T* o = d_ref + (long long)b * n + i;
  from_f(acc.x, o); from_f(acc.y, o + 1); from_f(acc.z, o + 2); from_f(acc.w, o + 3);
}

// dynamic shared memory a block: the records and the window
int smem_bytes(int C, int dc, int cap) {
  return dc * TILE_N * (int)(sizeof(float4) + sizeof(KeyMask)) + cap * C * (int)sizeof(float);
}

constexpr int kMaxSmem = 200 * 1024;

template <typename T, int C>
cudaError_t launch(const void* ref, const void* src, const void* rot,
                   const void* trans, const void* depth, const void* g,
                   void* d_ref, void* part, void* d_src, int B, int V, int D,
                   int Hr, int Hs, int W, int y0, long long ref_bs, long long src_bs,
                   const long long* ds, int dc, int cap,
                   unsigned long long* stats, cudaStream_t stream) {
  const int bytes = smem_bytes(C, dc, cap);
  if (dc < 1 || dc > effi::MAX_CHUNK || cap < 1 || bytes > kMaxSmem) return cudaErrorInvalidValue;
  static unsigned sized = 0;           // devices whose attribute is set
  int dev = 0;
  cudaGetDevice(&dev);
  if (!(sized >> (dev & 31) & 1u)) {
    cudaError_t e = cudaFuncSetAttribute(warp_correlate_bwd_kernel<T, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e != cudaSuccess) return e;
    sized |= 1u << (dev & 31);
  }
  const int tiles = ((Hr + effi::TILE_H - 1) / effi::TILE_H) * ((W + TILE_W - 1) / TILE_W);
  dim3 grid(tiles, V, B);
  warp_correlate_bwd_kernel<T, C><<<grid, TILE_N, bytes, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<const T*>(g),
      static_cast<float*>(part), static_cast<float*>(d_src), V, D, Hr, Hs, W, y0,
      ref_bs, src_bs, ds[0], ds[1], ds[2], ds[3], dc, cap, stats);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long n = (long long)Hr * W * C;
  dim3 sgrid((unsigned)((n / 4 + 255) / 256), B);
  dref_sum_kernel<T><<<sgrid, 256, 0, stream>>>(static_cast<const float*>(part),
                                                static_cast<T*>(d_ref), V, n);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, const void* src,
                       const void* rot, const void* trans, const void* depth,
                       const void* g, void* d_ref, void* part, void* d_src,
                       int B, int V, int D, int Hr, int Hs, int W, int y0,
                       long long ref_bs, long long src_bs, const long long* ds, int dc, int cap,
                       unsigned long long* stats, cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(ref, src, rot, trans, depth, g, d_ref, part, d_src, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    case 16: return launch<T, 16>(ref, src, rot, trans, depth, g, d_ref, part, d_src, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    case 32: return launch<T, 32>(ref, src, rot, trans, depth, g, d_ref, part, d_src, B, V, D, Hr, Hs, W, y0, ref_bs, src_bs, ds, dc, cap, stats, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (ref, src, g and d_ref).  g is a
// contiguous (B,V,D,Hr,W) cotangent, d_ref a contiguous (B,Hr,W,C) output,
// part a (B,V,Hr,W,C) fp32 scratch that the kernel fills, d_src a
// (B,V,Hs,W,C) fp32 buffer zeroed by the caller; the ref rows start at
// row y0 (all rows: y0 = 0, Hr = Hs).  Strides in elements;
// depth strides, dc and cap as for effi_warp_correlate.  stats, when not
// null, gains the adds into the windows, into d_src directly, and of the
// windows' flush.  Two launches on the stream; returns the first
// nonzero cudaGetLastError().
extern "C" int effi_warp_correlate_bwd(const void* ref, const void* src,
                                       const void* rot, const void* trans,
                                       const void* depth, const void* g,
                                       void* d_ref, void* part, void* d_src,
                                       int B, int V, int D, int Hr, int Hs,
                                       int W, int C, int y0,
                                       long long ref_bstride,
                                       long long src_bstride,
                                       long long dep_sb, long long dep_sd,
                                       long long dep_sh, long long dep_sw,
                                       int dc, int cap, void* stats,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ds[4] = {dep_sb, dep_sd, dep_sh, dep_sw};
  auto* st = static_cast<unsigned long long*>(stats);
  if (dtype == 0)
    return (int)dispatch_c<float>(C, ref, src, rot, trans, depth, g, d_ref,
                                  part, d_src, B, V, D, Hr, Hs, W, y0,
                                  ref_bstride, src_bstride, ds, dc, cap, st, s);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(C, ref, src, rot, trans, depth, g,
                                          d_ref, part, d_src, B, V, D, Hr, Hs,
                                          W, y0, ref_bstride, src_bstride, ds,
                                          dc, cap, st, s);
  return (int)cudaErrorInvalidValue;
}
