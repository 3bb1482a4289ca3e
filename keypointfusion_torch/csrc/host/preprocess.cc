// Native host-side preprocessing core for the RGB-D data loader.
//
// The reference leans on cv2's C++ kernels for its crop/resize chain
// (reference dataloader/loader.py:659-710) plus several numpy passes for
// normalization and depth→point-cloud back-projection (loader.py:595-602,
// 843-893). This library fuses the whole per-sample chain into single C++
// passes so loader workers spend less time in Python/numpy:
//   * crop_normalize: cube bounds → nearest-resize letterbox crop →
//     z-threshold → [-1,1] normalization, one pass, emits the 3x3 crop M.
//   * depth_to_pcl: valid crop pixels → normalized camera xyz.
// Exposed via ctypes (keypointfusion_torch/data/native.py); numerics
// mirror data/preprocessing.py (parity-tested).

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// depth: [H, W] float32 (mm). center_uvd: (u, v, z_mm). cube: (cx, cy, cz)
// mm. cam: (fx, fy, fu, fv). Outputs: out_crop [S, S] normalized to [-1,1],
// out_M row-major 3x3.
// Returns 0 on success.
int crop_normalize(const float* depth, int height, int width,
                   const float* center_uvd, const float* cube,
                   const float* cam, int img_size,
                   float* out_crop, float* out_M) {
  const double fx = cam[0], fy = cam[1];
  const double cu = center_uvd[0], cv = center_uvd[1], cz = center_uvd[2];
  if (cz == 0.0) return 1;

  // comToBounds (loader.py:291-301) — computed in float32 with numpy's op
  // order: the python path runs on float32 arrays, and boundary pixels
  // (floor at integer crossings) depend on that rounding
  const double zstart = cz - cube[2] / 2.0;
  const double zend = cz + cube[2] / 2.0;
  const float cuf = center_uvd[0], cvf = center_uvd[1], czf0 = center_uvd[2];
  const float fxf = cam[0], fyf = cam[1];
  const float hx = cube[0] / 2.f, hy = cube[1] / 2.f;
  const long xstart = (long)std::floor((cuf * czf0 / fxf - hx) / czf0 * fxf + 0.5f);
  const long xend = (long)std::floor((cuf * czf0 / fxf + hx) / czf0 * fxf + 0.5f);
  const long ystart = (long)std::floor((cvf * czf0 / fyf - hy) / czf0 * fyf + 0.5f);
  const long yend = (long)std::floor((cvf * czf0 / fyf + hy) / czf0 * fyf + 0.5f);
  const long wb = xend - xstart, hb = yend - ystart;
  if (wb <= 0 || hb <= 0) return 2;

  // letterbox geometry (loader.py:677-704)
  long sz_x, sz_y;
  if (wb > hb) {
    sz_x = img_size;
    sz_y = (long)((double)hb * img_size / wb);
  } else {
    sz_x = (long)((double)wb * img_size / hb);
    sz_y = img_size;
  }
  const double scale = (hb > wb) ? (double)sz_y / hb : (double)sz_x / wb;
  const long pad_x = (long)std::floor(img_size / 2. - sz_x / 2.);
  const long pad_y = (long)std::floor(img_size / 2. - sz_y / 2.);

  // crop matrix M = off * scale * trans (loader.py:685-710)
  for (int i = 0; i < 9; ++i) out_M[i] = 0.f;
  out_M[0] = (float)scale;
  out_M[4] = (float)scale;
  out_M[8] = 1.f;
  out_M[2] = (float)(pad_x - scale * xstart);
  out_M[5] = (float)(pad_y - scale * ystart);

  // one fused pass: nearest gather + z-threshold; track premax like the
  // python path (normalize uses the crop's max, loader.py:595-596).
  // cv2 INTER_NEAREST maps dst→src as floor(dst * (1.0/inv_scale)) where
  // inv_scale = (double)dst/src — the double-rounding of the reciprocal
  // differs from floor(dst*src/dst) at exact integer crossings (e.g.
  // src=246,dst=128: 64*(1/(128/246.)) = 122.9999... → 122, while
  // 64*246/128 = 123). Replicate cv2's arithmetic exactly.
  const double inv_sx = 1.0 / ((double)sz_x / (double)wb);
  const double inv_sy = 1.0 / ((double)sz_y / (double)hb);
  float premax = -1e30f;
  for (int oy = 0; oy < img_size; ++oy) {
    for (int ox = 0; ox < img_size; ++ox) {
      float v = 0.f;
      const long ry = oy - pad_y, rx = ox - pad_x;
      if (ry >= 0 && ry < sz_y && rx >= 0 && rx < sz_x) {
        // cv2 clamps the source index to the crop extent (resizeNN)
        const long sy = ystart + std::min((long)std::floor(ry * inv_sy),
                                          hb - 1);
        const long sx = xstart + std::min((long)std::floor(rx * inv_sx),
                                          wb - 1);
        if (sy >= 0 && sy < height && sx >= 0 && sx < width) {
          v = depth[sy * width + sx];
        }
        // getCrop z-threshold (loader.py:745-749)
        if (v < zstart && v != 0.f) v = (float)zstart;
        if (v > zend && v != 0.f) v = 0.f;
      }
      out_crop[oy * img_size + ox] = v;
      premax = std::max(premax, v);
    }
  }

  // normalize_img (loader.py:595-602)
  const float zmaxf = (float)zend, zminf = (float)zstart;
  const float czf = (float)cz, half = (float)(cube[2] / 2.0);
  const int n = img_size * img_size;
  for (int i = 0; i < n; ++i) {
    float v = out_crop[i];
    if (v == premax || v == 0.f) v = zmaxf;
    if (v >= zmaxf) v = zmaxf;
    if (v <= zminf) v = zminf;
    out_crop[i] = (v - czf) / half;
  }
  return 0;
}

// crop_nl: [S, S] normalized depth. M row-major 3x3 (crop transform),
// com3d: crop center camera xyz (mm), cube mm, cam intrinsics, flip ±1.
// out_pcl: [S*S, 3]; returns the number of valid points (>=0) or -1.
int depth_to_pcl(const float* crop_nl, int img_size, const float* M,
                 const float* cam, const float* com3d, const float* cube,
                 float flip, float* out_pcl) {
  const double fx = cam[0], fy = cam[1], fu = cam[2], fv = cam[3];
  // inverse of the affine M (scale + translation only)
  const double s = M[0];
  if (s == 0.0) return -1;
  const double inv_s = 1.0 / s;
  const double tu = M[2], tv = M[5];
  const float half_z = (float)(cube[2] / 2.0);

  int count = 0;
  for (int y = 0; y < img_size; ++y) {
    for (int x = 0; x < img_size; ++x) {
      const float dnl = crop_nl[y * img_size + x];
      const float d_mm = dnl * half_z + (float)com3d[2];
      // valid = not background (normalized 1.0 → d_mm == com_z + half)
      if (std::fabs(dnl - 1.0f) <= 1.0001e-5f) continue;  // np.isclose(x, 1)
      if (d_mm == 0.f) continue;
      const double u = ((double)x + 0.5 - tu) * inv_s;
      const double v = ((double)y + 0.5 - tv) * inv_s;
      const double X = (u - fu) / fx * d_mm;
      const double Y = flip * (v - fv) / fy * d_mm;
      out_pcl[count * 3 + 0] = (float)((X - com3d[0]) / (cube[0] / 2.0));
      out_pcl[count * 3 + 1] = (float)((Y - com3d[1]) / (cube[1] / 2.0));
      out_pcl[count * 3 + 2] = (float)((d_mm - com3d[2]) / half_z);
      ++count;
    }
  }
  return count;
}

}  // extern "C"
