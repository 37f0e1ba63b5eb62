// Plane-sweep warp + correlation over all source views (kernel K1).
//
// Replaces the TPU kernel effi_mvs_plus_tpu/ops/pallas_warp.py::_kernel
// (launched by _plane_sweep_correlate_views, dispatched by
// warp_correlate_views_fused / _views_fwd_impl).  It computes
//
//   corr[b,v,d,y,x] = (1/C) * sum_c ref[b,y,x,c] * bilinear(src[b,v], px, py)[c]
//
// where (px, py) projects ref pixel (x, y) at depth[b,d,y,x] through
// rot[b,v] and trans[b,v]: ray = rot.[x,y,1], xyz = ray*depth + trans, the
// z==0 -> z+1e-8 guard, px = xyz.x/z, py = xyz.y/z.  Bilinear sampling is
// grid_sample's align_corners=True / zeros padding: each out-of-image tap
// contributes 0, weights are not renormalised.  The projection and taps
// are those of warp_project.cuh, which the backward (K3) shares.
//
// Design.  One thread per output pixel of one (b, v); the thread keeps the
// ref C-vector (C <= 32) in registers and loops over the D hypotheses, so
// the projection ray is formed once per pixel and each hypothesis costs
// one depth load, four C-vector taps read as 16-byte vectors from the
// channels-last source map, and one coalesced store.  The TPU kernel's
// region window, rung ladder, fit predicates and overflow patch exist only
// because it copies a static window of the source into VMEM; a gather from
// global memory is exact, so there is one path here.
//
// Bound.  At every stage shape the function is bound by bytes: it must
// read ref, src and depth and write B*V*D*H*W outputs, about 10*C + 20
// flops per output against 4-8 bytes written.  The taps themselves are
// re-read from L1/L2 (neighbouring pixels sample neighbouring source
// pixels); device memory sees each source map roughly once per hypothesis
// sweep.  Arithmetic is fp32 for fp32 and bf16 features alike; the output
// is stored in the features' dtype.

#include "warp_project.cuh"

namespace {

using effi::from_f;
using effi::load_vec;

// smp += w * src[idx, 0:C]
template <int C, typename T>
__device__ __forceinline__ void add_tap(const T* s, int idx, float w,
                                        float (&smp)[C]) {
  float tap[C];
  load_vec<C>(s + (long long)idx * C, tap);
#pragma unroll
  for (int c = 0; c < C; ++c) smp[c] += tap[c] * w;
}

template <typename T, int C>
__global__ void __launch_bounds__(128)
warp_correlate_kernel(const T* __restrict__ ref, const T* __restrict__ src,
                      const float* __restrict__ rot, const float* __restrict__ trans,
                      const float* __restrict__ depth, T* __restrict__ out,
                      int V, int D, int H, int W,
                      long long ref_bstride, long long src_bstride,
                      long long dep_sb, long long dep_sd, long long dep_sh,
                      long long dep_sw) {
  const int HW = H * W;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y;
  const int b = blockIdx.z;
  if (pix >= HW) return;
  const int y = pix / W;
  const int x = pix - y * W;

  float r[C];
  load_vec<C>(ref + b * ref_bstride + (long long)pix * C, r);

  const effi::Ray ray = effi::make_ray(rot + (b * V + v) * 9,
                                       trans + (b * V + v) * 3, x, y);

  const T* s = src + b * src_bstride + (long long)v * HW * C;
  const float* dep = depth + b * dep_sb + y * dep_sh + x * dep_sw;
  T* o = out + ((long long)(b * V + v) * D) * HW + pix;
  const float inv_c = 1.0f / (float)C;

  for (int d = 0; d < D; ++d) {
    const effi::Taps tp = effi::taps_at(ray, __ldg(dep + d * dep_sd), H, W);
    float smp[C];
#pragma unroll
    for (int c = 0; c < C; ++c) smp[c] = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (tp.idx[k] >= 0) add_tap<C>(s, tp.idx[k], tp.w[k], smp);
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc += smp[c] * r[c];
    from_f(acc * inv_c, o + (long long)d * HW);
  }
}

template <typename T, int C>
cudaError_t launch(const void* ref, const void* src, const void* rot,
                   const void* trans, const void* depth, void* out, int B,
                   int V, int D, int H, int W, long long ref_bs,
                   long long src_bs, const long long* ds,
                   cudaStream_t stream) {
  dim3 block(128);
  dim3 grid((H * W + 127) / 128, V, B);
  warp_correlate_kernel<T, C><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ref), static_cast<const T*>(src),
      static_cast<const float*>(rot), static_cast<const float*>(trans),
      static_cast<const float*>(depth), static_cast<T*>(out), V, D, H, W,
      ref_bs, src_bs, ds[0], ds[1], ds[2], ds[3]);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int C, const void* ref, const void* src,
                       const void* rot, const void* trans, const void* depth,
                       void* out, int B, int V, int D, int H, int W,
                       long long ref_bs, long long src_bs, const long long* ds,
                       cudaStream_t stream) {
  switch (C) {
    case 8: return launch<T, 8>(ref, src, rot, trans, depth, out, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    case 16: return launch<T, 16>(ref, src, rot, trans, depth, out, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    case 32: return launch<T, 32>(ref, src, rot, trans, depth, out, B, V, D, H, W, ref_bs, src_bs, ds, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides in elements; depth_strides
// holds the (b, d, y, x) strides of the depth tensor, so an expanded
// per-batch sweep (strides (D, 1, 0, 0)) is read without a copy.  Returns
// the launch's cudaGetLastError().
extern "C" int effi_warp_correlate(const void* ref, const void* src,
                                   const void* rot, const void* trans,
                                   const void* depth, void* out, int B,
                                   int V, int D, int H, int W, int C,
                                   long long ref_bstride,
                                   long long src_bstride,
                                   long long dep_sb, long long dep_sd,
                                   long long dep_sh, long long dep_sw,
                                   int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long ds[4] = {dep_sb, dep_sd, dep_sh, dep_sw};
  if (dtype == 0)
    return (int)dispatch_c<float>(C, ref, src, rot, trans, depth, out, B, V,
                                  D, H, W, ref_bstride, src_bstride, ds, s);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(C, ref, src, rot, trans, depth,
                                          out, B, V, D, H, W, ref_bstride,
                                          src_bstride, ds, s);
  return (int)cudaErrorInvalidValue;
}
