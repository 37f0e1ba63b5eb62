// Tiles, hypothesis chunks and the shared-memory source window of the
// warp + correlation forward (K1, warp_correlate.cu) and its backward (K3,
// warp_correlate_bwd.cu).  ops/cuda_warp.py plans the chunk and the window
// budget for both launches; ops/warp_window.py emulates this decomposition
// in plain PyTorch for the CPU tests.
//
// A block owns one TILE_H x TILE_W tile of ref pixels of one (batch,
// view) at a time and walks the hypotheses in chunks of `dc`.  For each
// chunk it takes the bounding box of the in-image taps of its pixels (K3:
// of every tap, which it projects anyway; K1: of the span of each ray's
// first and last hypothesis, `box_add_span`) with a block-wide min/max,
// and clips that box to `cap` texels around its centre, keeping its
// aspect: the chunk's window.  The box lies in the image, so the window
// needs no zero fill.  A tap inside the window is served from shared
// memory; a tap outside it (where the box was clipped, or missed a tap)
// from device memory, so no tap is dropped and the result does not depend on
// the window.  This stands in for the TPU kernel's static VMEM region
// (pallas_warp.py:441-476, 798-812): there a tap outside the region was
// lost, and a rung ladder, fit predicates and an overflow patch kept the
// region large enough.

#pragma once

#include <climits>

#include "warp_project.cuh"

namespace effi {

constexpr int TILE_H = 8;
constexpr int TILE_W = 16;
constexpr int TILE_N = TILE_H * TILE_W;   // threads a block, one a pixel
constexpr int TILE_WARPS = TILE_N / 32;
constexpr int MAX_CHUNK = 8;              // K3's hypotheses a chunk at most (ops/cuda_warp.py K3_CHUNK)

// Inclusive bounding box of texel coordinates; empty while x1 < x0.
struct Box {
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Box empty_box() { return Box{INT_MAX, INT_MAX, -1, -1}; }

// Grow the box by the in-image taps of one (pixel, hypothesis): the taps
// of the 2x2 square at (x0, y0) that lie in the image span
// [max(x0, 0), min(x0 + 1, W - 1)] x [max(y0, 0), min(y0 + 1, H - 1)].
__device__ __forceinline__ void box_add(Box& b, const Taps& tp, int H, int W) {
  if (!tp.any) return;
  b.x0 = min(b.x0, max(tp.x0, 0));
  b.y0 = min(b.y0, max(tp.y0, 0));
  b.x1 = max(b.x1, min(tp.x0 + 1, W - 1));
  b.y1 = max(b.y1, min(tp.y0 + 1, H - 1));
}

// Grow the box by the taps of one ray over a chunk from its first and
// last hypotheses (K1): along a ray px and py are monotonic in the depth
// wherever z keeps its sign, so for sorted depths the squares of the two
// ends span those between.  The span is clamped to the image in floats (a
// far or behind-camera end may lie anywhere).  Where the depths are not
// sorted or z changes sign within the chunk, a tap may fall outside the
// box; it is then read from device memory.
__device__ __forceinline__ void box_add_span(Box& b, const Ray& r, float za, float zb, int H,
                                             int W) {
  float xa, ya, xb, yb;
  project(r, za, xa, ya);
  project(r, zb, xb, yb);
  xa = floorf(xa); xb = floorf(xb); ya = floorf(ya); yb = floorf(yb);
  const float x0 = fminf(xa, xb), x1 = fmaxf(xa, xb) + 1.0f;
  const float y0 = fminf(ya, yb), y1 = fmaxf(ya, yb) + 1.0f;
  if (!(x1 >= 0.0f && x0 <= (float)(W - 1) && y1 >= 0.0f && y0 <= (float)(H - 1))) return;
  b.x0 = min(b.x0, (int)fmaxf(x0, 0.0f));
  b.y0 = min(b.y0, (int)fmaxf(y0, 0.0f));
  b.x1 = max(b.x1, (int)fminf(x1, (float)(W - 1)));
  b.y1 = max(b.y1, (int)fminf(y1, (float)(H - 1)));
}

// A window of w x h texels at (x0, y0), in the image.
struct Window {
  int x0, y0, w, h;
};

// The box, or where it holds more than `cap` texels, the centred box of
// the same aspect that holds at most `cap` (fp32 arithmetic, IEEE division
// and square root: ops/cuda_warp.py repeats it bit for bit).
__device__ __forceinline__ Window clip_window(const Box& b, int cap) {
  if (b.x1 < b.x0) return Window{0, 0, 0, 0};
  const int bw = b.x1 - b.x0 + 1, bh = b.y1 - b.y0 + 1;
  int ww = bw, wh = bh;
  if (bw * bh > cap) {
    const float s = __fsqrt_rn(__fdiv_rn((float)cap, (float)(bw * bh)));
    ww = max(1, min(bw, (int)__fmul_rn((float)bw, s)));
    wh = max(1, min(bh, cap / ww));
  }
  return Window{b.x0 + (bw - ww) / 2, b.y0 + (bh - wh) / 2, ww, wh};
}

// Is texel (x, y) in the window; t is its index there, row-major.
__device__ __forceinline__ bool in_window(const Window& w, int x, int y, int& t) {
  const int lx = x - w.x0, ly = y - w.y0;
  t = ly * w.w + lx;
  return (unsigned)lx < (unsigned)w.w && (unsigned)ly < (unsigned)w.h;
}

// Block-wide: the window of the union of the threads' boxes, written to
// *slot and returned to every thread.  Every thread of the block calls
// it; `red` is scratch of TILE_WARPS x 4 ints.  Ends with a barrier, so
// shared memory written before the call is visible after it.
__device__ __forceinline__ Window block_window(Box b, int cap, int (*red)[4], Window* slot) {
  const unsigned all = 0xffffffffu;
  const int x0 = __reduce_min_sync(all, b.x0), y0 = __reduce_min_sync(all, b.y0);
  const int x1 = __reduce_max_sync(all, b.x1), y1 = __reduce_max_sync(all, b.y1);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp][0] = x0; red[warp][1] = y0; red[warp][2] = x1; red[warp][3] = y1;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    Box u = empty_box();
#pragma unroll
    for (int i = 0; i < TILE_WARPS; ++i) {
      u.x0 = min(u.x0, red[i][0]); u.y0 = min(u.y0, red[i][1]);
      u.x1 = max(u.x1, red[i][2]); u.y1 = max(u.y1, red[i][3]);
    }
    *slot = clip_window(u, cap);
  }
  __syncthreads();
  return *slot;
}

// Add the block's counts to stats[0..n) (one atomic a warp); stats may be
// null, and then nothing is counted.
template <int N>
__device__ __forceinline__ void add_stats(unsigned long long* stats, const unsigned (&n)[N]) {
  if (stats == nullptr) return;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const unsigned s = __reduce_add_sync(0xffffffffu, n[i]);
    if (threadIdx.x % 32 == 0 && s) atomicAdd(stats + i, (unsigned long long)s);
  }
}

// ---- asynchronous copies (as conv3x3_tile.cuh) ----
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace effi
