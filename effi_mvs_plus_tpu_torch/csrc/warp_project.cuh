// Projection and bilinear taps shared by the warp + correlation forward
// (warp_correlate.cu, K1) and its backward (warp_correlate_bwd.cu, K3).
//
// Both kernels must find the same four taps with the same weights at every
// (pixel, hypothesis): a coordinate rounded differently in the backward
// would move a tap across a pixel boundary and send its gradient to the
// wrong source texel.  So the arithmetic lives here once, in the order of
// the reference: ray = rot.[x,y,1], xyz = ray*depth + trans, the z==0 ->
// z+1e-8 guard, px = X/Z, py = Y/Z, all fp32; grid_sample's
// align_corners=True / zeros padding, each out-of-image tap dropped and the
// weights not renormalised.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace effi {

__device__ __forceinline__ void from_f(float v, float* p) { *p = v; }
__device__ __forceinline__ void from_f(float v, __nv_bfloat16* p) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Load C consecutive channels (16-byte aligned) into fp32 registers.
template <int C>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[C]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < C / 4; ++i) {
    float4 v = __ldg(q + i);
    out[4 * i] = v.x; out[4 * i + 1] = v.y; out[4 * i + 2] = v.z; out[4 * i + 3] = v.w;
  }
}

template <int C>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&out)[C]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < C / 8; ++i) {
    uint4 v = __ldg(q + i);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float2 f = __bfloat1622float2(h[j]);
      out[8 * i + 2 * j] = f.x;
      out[8 * i + 2 * j + 1] = f.y;
    }
  }
}

// The ray of ref pixel (x, y) in one source view, formed once per pixel;
// y is the pixel's row in the whole reference (a row block's kernels pass
// y0 + their row, so the ray is the whole image's, bit for bit).
struct Ray {
  float x, y, z, t0, t1, t2;
};

__device__ __forceinline__ Ray make_ray(const float* R, const float* t,
                                        int x, int y) {
  const float fx = (float)x, fy = (float)y;
  Ray r;
  r.x = R[0] * fx + R[1] * fy + R[2];
  r.y = R[3] * fx + R[4] * fy + R[5];
  r.z = R[6] * fx + R[7] * fy + R[8];
  r.t0 = t[0]; r.t1 = t[1]; r.t2 = t[2];
  return r;
}

// The four bilinear taps at one hypothesis, in the reference order
// (x0,y0), (x1,y0), (x0,y1), (x1,y1): flat pixel index (-1 outside the
// image; an int is formed only for a tap inside) and weight; and the
// corner (x0, y0) of the 2x2 square, formed only where one of its taps
// lies in the image (`any`; then x0 >= -1 and y0 >= -1), and whether
// each tap lies in the image (`in`, the same test as idx >= 0).
struct Taps {
  int idx[4];
  float w[4];
  int x0, y0;
  bool any;
  bool in[4];
};

// The source pixel coordinates of the ray at depth z_d.
__device__ __forceinline__ void project(const Ray& r, float z_d, float& px,
                                        float& py) {
  const float X = r.x * z_d + r.t0;
  const float Y = r.y * z_d + r.t1;
  float Z = r.z * z_d + r.t2;
  if (Z == 0.0f) Z = Z + 1e-8f;
  px = X / Z;
  py = Y / Z;
}

__device__ __forceinline__ Taps taps_at(const Ray& r, float z_d, int H,
                                        int W) {
  float px, py;
  project(r, z_d, px, py);
  const float x0f = floorf(px), y0f = floorf(py);
  const float wx = px - x0f, wy = py - y0f;
  // bounds on the float coordinates: no int overflow for far taps
  const bool vx0 = (x0f >= 0.0f) && (x0f < (float)W);
  const bool vx1 = (x0f + 1.0f >= 0.0f) && (x0f + 1.0f < (float)W);
  const bool vy0 = (y0f >= 0.0f) && (y0f < (float)H);
  const bool vy1 = (y0f + 1.0f >= 0.0f) && (y0f + 1.0f < (float)H);
  Taps tp;
  tp.w[0] = (1.0f - wx) * (1.0f - wy);
  tp.w[1] = wx * (1.0f - wy);
  tp.w[2] = (1.0f - wx) * wy;
  tp.w[3] = wx * wy;
  tp.idx[0] = (vx0 && vy0) ? (int)y0f * W + (int)x0f : -1;
  tp.idx[1] = (vx1 && vy0) ? (int)y0f * W + (int)(x0f + 1.0f) : -1;
  tp.idx[2] = (vx0 && vy1) ? (int)(y0f + 1.0f) * W + (int)x0f : -1;
  tp.idx[3] = (vx1 && vy1) ? (int)(y0f + 1.0f) * W + (int)(x0f + 1.0f) : -1;
  tp.in[0] = vx0 && vy0;
  tp.in[1] = vx1 && vy0;
  tp.in[2] = vx0 && vy1;
  tp.in[3] = vx1 && vy1;
  tp.any = (vx0 || vx1) && (vy0 || vy1);
  tp.x0 = tp.any ? (int)x0f : 0;
  tp.y0 = tp.any ? (int)y0f : 0;
  return tp;
}

}  // namespace effi
