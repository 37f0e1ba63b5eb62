// Native data plane of the port: PFM codec, bilinear/nearest resize
// (cv2's INTER_LINEAR / INTER_NEAREST rules), binary-PLY writing, with a
// C interface that effi_mvs_plus_tpu_torch/native/__init__.py loads with
// ctypes after building it with g++ at first use.
//
// A copy of effi_mvs_plus_tpu/native/src/effi_native.cc: everything
// below this header is that file's code, unchanged.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <thread>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

// Parse header; returns 0 on success. channels: 1 or 3.
// data_offset = byte offset of the raster; little = raster endianness.
int effi_pfm_header(const char* path, int* width, int* height, int* channels,
                    int* little, long* data_offset, float* scale) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0, 0, 0};
  if (std::fread(magic, 1, 2, f) != 2) { std::fclose(f); return -2; }
  int c;
  if (magic[0] != 'P' || (magic[1] != 'F' && magic[1] != 'f')) {
    std::fclose(f); return -3;
  }
  *channels = magic[1] == 'F' ? 3 : 1;
  // consume single whitespace after magic
  c = std::fgetc(f);
  if (c != '\n' && c != ' ' && c != '\r' && c != '\t') { std::fclose(f); return -4; }
  int w = 0, h = 0;
  double sc = 0.0;
  if (std::fscanf(f, "%d %d", &w, &h) != 2) { std::fclose(f); return -5; }
  if (std::fscanf(f, "%lf", &sc) != 1) { std::fclose(f); return -6; }
  c = std::fgetc(f);  // single whitespace before raster (spec)
  (void)c;
  *width = w;
  *height = h;
  *little = sc < 0 ? 1 : 0;
  *scale = static_cast<float>(sc < 0 ? -sc : sc);
  *data_offset = std::ftell(f);
  std::fclose(f);
  return 0;
}

static inline uint32_t bswap32(uint32_t v) {
#if defined(__GNUC__)
  return __builtin_bswap32(v);
#else
  return ((v & 0xff) << 24) | ((v & 0xff00) << 8) | ((v >> 8) & 0xff00) |
         (v >> 24);
#endif
}

// Read raster into out (H*W*C floats), flipping rows so row 0 = top
// (PFM stores bottom-up) and byteswapping to host order if needed.
int effi_pfm_read(const char* path, float* out) {
  int w, h, ch, little;
  long off;
  float scale;
  int rc = effi_pfm_header(path, &w, &h, &ch, &little, &off, &scale);
  if (rc != 0) return rc;
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, off, SEEK_SET) != 0) { std::fclose(f); return -7; }
  const size_t row = static_cast<size_t>(w) * ch;
  // PFM rows are bottom-up: read row r of the file into out row h-1-r.
  for (int r = 0; r < h; ++r) {
    float* dst = out + static_cast<size_t>(h - 1 - r) * row;
    if (std::fread(dst, 4, row, f) != row) { std::fclose(f); return -8; }
  }
  std::fclose(f);
  const bool host_little = [] {
    uint16_t x = 1;
    return *reinterpret_cast<uint8_t*>(&x) == 1;
  }();
  if (static_cast<bool>(little) != host_little) {
    uint32_t* p = reinterpret_cast<uint32_t*>(out);
    const size_t n = static_cast<size_t>(w) * h * ch;
    for (size_t i = 0; i < n; ++i) p[i] = bswap32(p[i]);
  }
  return 0;
}

// Write little-endian PFM (scale sign encodes endianness), flipping rows.
int effi_pfm_write(const char* path, const float* data, int width, int height,
                   int channels, float scale) {
  if (channels != 1 && channels != 3) return -3;
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f, "%s\n%d %d\n%f\n", channels == 3 ? "PF" : "Pf", width,
               height, -scale);
  const size_t row = static_cast<size_t>(width) * channels;
  for (int r = height - 1; r >= 0; --r) {
    if (std::fwrite(data + static_cast<size_t>(r) * row, 4, row, f) != row) {
      std::fclose(f);
      return -8;
    }
  }
  std::fclose(f);
  return 0;
}

// ---------------------------------------------------------------------------
// Resize (float32, channels-last) — cv2-compatible semantics
// ---------------------------------------------------------------------------

// cv2.INTER_LINEAR: src coordinate = (dst + 0.5) * scale - 0.5, edge clamp.
void effi_resize_bilinear_f32(const float* src, int sh, int sw, int ch,
                              float* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2 >= 0 ? sh - 2 : 0;
    double wy = fy - y0;
    if (wy < 0) wy = 0;
    if (wy > 1) wy = 1;
    const float* r0 = src + static_cast<size_t>(y0) * sw * ch;
    const float* r1 = src + static_cast<size_t>(y0 + (sh > 1 ? 1 : 0)) * sw * ch;
    float* out_row = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2 >= 0 ? sw - 2 : 0;
      double wx = fx - x0;
      if (wx < 0) wx = 0;
      if (wx > 1) wx = 1;
      const int x1 = x0 + (sw > 1 ? 1 : 0);
      for (int c = 0; c < ch; ++c) {
        const double a = r0[x0 * ch + c] * (1 - wx) + r0[x1 * ch + c] * wx;
        const double b = r1[x0 * ch + c] * (1 - wx) + r1[x1 * ch + c] * wx;
        out_row[x * ch + c] = static_cast<float>(a * (1 - wy) + b * wy);
      }
    }
  }
}

// cv2.INTER_NEAREST: src index = floor(dst * scale) (cv2 uses
// (dst+0.5)*scale truncated; match cv2's actual: floor((dst + 0.5) * scale))
void effi_resize_nearest_f32(const float* src, int sh, int sw, int ch,
                             float* dst, int dh, int dw) {
  const double sy = static_cast<double>(sh) / dh;
  const double sx = static_cast<double>(sw) / dw;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < dh; ++y) {
    int ys = static_cast<int>(y * sy);  // cv2 nearest truncates dst*scale
    if (ys > sh - 1) ys = sh - 1;
    const float* srow = src + static_cast<size_t>(ys) * sw * ch;
    float* drow = dst + static_cast<size_t>(y) * dw * ch;
    for (int x = 0; x < dw; ++x) {
      int xs = static_cast<int>(x * sx);
      if (xs > sw - 1) xs = sw - 1;
      std::memcpy(drow + static_cast<size_t>(x) * ch,
                  srow + static_cast<size_t>(xs) * ch, sizeof(float) * ch);
    }
  }
}

// ---------------------------------------------------------------------------
// Binary PLY writer (little-endian, x/y/z float + optional r/g/b uchar)
// ---------------------------------------------------------------------------

int effi_ply_write(const char* path, const float* xyz, const uint8_t* rgb,
                   long n) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  std::fprintf(f,
               "ply\nformat binary_little_endian 1.0\nelement vertex %ld\n"
               "property float x\nproperty float y\nproperty float z\n",
               n);
  if (rgb)
    std::fprintf(f,
                 "property uchar red\nproperty uchar green\nproperty uchar "
                 "blue\n");
  std::fprintf(f, "end_header\n");
  const long CHUNK = 1 << 20;
  if (rgb) {
    std::vector<uint8_t> buf(static_cast<size_t>(CHUNK) * 15);
    for (long i = 0; i < n; i += CHUNK) {
      const long m = n - i < CHUNK ? n - i : CHUNK;
      uint8_t* p = buf.data();
      for (long j = 0; j < m; ++j) {
        std::memcpy(p, xyz + (i + j) * 3, 12);
        p += 12;
        std::memcpy(p, rgb + (i + j) * 3, 3);
        p += 3;
      }
      if (std::fwrite(buf.data(), 1, static_cast<size_t>(m) * 15, f) !=
          static_cast<size_t>(m) * 15) {
        std::fclose(f);
        return -8;
      }
    }
  } else {
    if (std::fwrite(xyz, 12, n, f) != static_cast<size_t>(n)) {
      std::fclose(f);
      return -8;
    }
  }
  std::fclose(f);
  return 0;
}

int effi_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return static_cast<int>(std::thread::hardware_concurrency());
#endif
}

}  // extern "C"
