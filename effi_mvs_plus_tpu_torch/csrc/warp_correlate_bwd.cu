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
// out-of-image taps dropped.  The projection grid gets no gradient (the
// rotations, translations and depths are constants of the warp), so the
// taps and weights are those of the forward, from the same code
// (warp_project.cuh): a coordinate rounded differently here would move a
// tap across a pixel boundary.
//
// Design.  One thread owns one ref pixel of one batch item and loops over
// the views and hypotheses, so d_ref (C <= 32 floats) accumulates in
// registers and is written once, with no atomics.  Per (v, d) the thread
// recomputes the projection, reads g, gathers the in-image taps for d_ref
// and scatters (g/C) * w * ref[c] into d_src with fp32 atomicAdd, into an
// fp32 buffer the wrapper zeroes and casts to the features' dtype.  The
// TPU kernel's region window, run-length flush and rung ladder exist only
// because it accumulates a fixed VMEM window; nothing here needs them.
//
// Bound.  The bytes the function must move (features and depth read, g
// read once, both gradients written once) take tens of microseconds at the
// training shapes.  What sets the pace is the scatter: 4 taps x C atomic
// adds per (b, v, d, pixel), and neighbouring hypotheses of one ray and
// neighbouring pixels land on the same source texels, so the adds contend.
// Atomics also make d_src's summation order, and its last bits, vary from
// run to run.

#include "warp_project.cuh"

namespace {

using effi::from_f;
using effi::load_vec;
using effi::to_f;

template <typename T, int C>
__global__ void __launch_bounds__(128)
warp_correlate_bwd_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                          const float* __restrict__ rot,
                          const float* __restrict__ trans,
                          const float* __restrict__ depth,
                          const T* __restrict__ g, T* __restrict__ d_ref,
                          float* __restrict__ d_src, int V, int D, int H,
                          int W, long long ref_bstride, long long src_bstride,
                          long long dep_sb, long long dep_sd,
                          long long dep_sh, long long dep_sw) {
  const int HW = H * W;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (pix >= HW) return;
  const int y = pix / W;
  const int x = pix - y * W;

  float r[C];
  load_vec<C>(ref + b * ref_bstride + (long long)pix * C, r);
  float dr[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dr[c] = 0.0f;

  const float* dep = depth + b * dep_sb + y * dep_sh + x * dep_sw;
  const float inv_c = 1.0f / (float)C;

  for (int v = 0; v < V; ++v) {
    const effi::Ray ray = effi::make_ray(rot + (b * V + v) * 9,
                                         trans + (b * V + v) * 3, x, y);
    const T* s = src + b * src_bstride + (long long)v * HW * C;
    float* ds = d_src + (long long)(b * V + v) * HW * C;
    const T* gv = g + ((long long)(b * V + v) * D) * HW + pix;
    for (int d = 0; d < D; ++d) {
      const float gd = to_f(gv[(long long)d * HW]) * inv_c;
      if (gd == 0.0f) continue;
      const effi::Taps tp = effi::taps_at(ray, __ldg(dep + d * dep_sd), H, W);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (tp.idx[k] < 0) continue;
        const float gw = gd * tp.w[k];
        float tap[C];
        load_vec<C>(s + (long long)tp.idx[k] * C, tap);
        float* q = ds + (long long)tp.idx[k] * C;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dr[c] += gw * tap[c];
          atomicAdd(q + c, gw * r[c]);
        }
      }
    }
  }

  T* o = d_ref + b * (long long)HW * C + (long long)pix * C;
#pragma unroll
  for (int c = 0; c < C; ++c) from_f(dr[c], o + c);
}

template <typename T, int C>
cudaError_t launch(const void* ref, const void* src, const void* rot,
                   const void* trans, const void* depth, const void* g,
                   void* d_ref, void* d_src, int B, int V, int D, int H,
                   int W, long long ref_bs, long long src_bs,
                   const long long* ds, cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((H * W + 127) / 128, B);
  warp_correlate_bwd_kernel<T, C><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<const T*>(g),
      static_cast<T*>(d_ref), static_cast<float*>(d_src), V, D, H, W,
      ref_bs, src_bs, ds[0], ds[1], ds[2], ds[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, const void* src,
                       const void* rot, const void* trans, const void* depth,
                       const void* g, void* d_ref, void* d_src, int B, int V,
                       int D, int H, int W, long long ref_bs,
                       long long src_bs, const long long* ds,
                       cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(ref, src, rot, trans, depth, g, d_ref, d_src, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    case 16: return launch<T, 16>(ref, src, rot, trans, depth, g, d_ref, d_src, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    case 32: return launch<T, 32>(ref, src, rot, trans, depth, g, d_ref, d_src, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (ref, src, g and d_ref; d_src is
// always an fp32 buffer, zeroed by the caller).  g is a contiguous
// (B,V,D,H,W) cotangent, d_ref a contiguous (B,H,W,C) output.  Strides in
// elements; depth_strides as for effi_warp_correlate.  Returns the
// launch's cudaGetLastError().
extern "C" int effi_warp_correlate_bwd(const void* ref, const void* src,
                                       const void* rot, const void* trans,
                                       const void* depth, const void* g,
                                       void* d_ref, void* d_src, int B,
                                       int V, int D, int H, int W, int C,
                                       long long ref_bstride,
                                       long long src_bstride,
                                       long long dep_sb, long long dep_sd,
                                       long long dep_sh, long long dep_sw,
                                       int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ds[4] = {dep_sb, dep_sd, dep_sh, dep_sw};
  if (dtype == 0)
    return (int)dispatch_c<float>(C, ref, src, rot, trans, depth, g, d_ref,
                                  d_src, B, V, D, H, W, ref_bstride,
                                  src_bstride, ds, s);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(C, ref, src, rot, trans, depth, g,
                                          d_ref, d_src, B, V, D, H, W,
                                          ref_bstride, src_bstride, ds, s);
  return (int)cudaErrorInvalidValue;
}
