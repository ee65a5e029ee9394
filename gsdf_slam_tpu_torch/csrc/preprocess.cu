// preprocess_fwd and preprocess_bwd: the per-Gaussian preprocess of a render
// (cull, EWA projection, opacity-tight tile rect, SH colour) and its
// backward, one thread a Gaussian.
//
// Replaces no Pallas kernel: the JAX package leaves the preprocess
// (gsdf_slam_tpu/ops/projection.py, transforms.py::build_cov3d,
// sh.py::eval_sh_color) to XLA's fusion. Written as plain torch ops, the
// port issued ~380 launches a render forward and ~610 backward, each over
// a full [P] column; these two kernels do the same work in one launch
// each (the reference's preprocessCUDA, forward.cu:198-312, and
// BACKWARD::preprocess with computeCov2DCUDA, backward.cu).
//
// Bound: bytes. Forward: ~236 bytes a Gaussian read at SH degree 3 (means,
// scales, quaternion, opacity, 16 x 3 coefficients), 60 written. Backward:
// the same inputs but the opacity, the cotangents of means2d, conics and
// colours (32), and 232 bytes of gradients written. At 2.0M Gaussians that
// is >= 0.18 ms forward and >= 0.30 ms backward at 3.35 TB/s. The backward
// saves nothing of the forward: it recomputes the forward's intermediates
// in registers. A Gaussian's sh_rest row (180 bytes at degree 3) is the
// widest: one float a thread at that stride touches a 32-byte sector a
// float, so the backward stages its block's rows in shared memory, read
// together, each thread's row read and overwritten with its gradient
// there, and written back together.
//
// Numerics. The library is built with --fmad=false and every formula is
// written in the order of ops/projection.py's plain version, so that the
// cull, depths, means2d, conics, radii, rects and tiles_touched are bit-equal
// to it on the card: torch rounds each op's result to float32, and a / x by
// a Python scalar x on the left (`1.0 / t`, `width / t`) is reciprocal(t) * x.
// The colours may differ in the last bits: torch sums the 16 coefficient
// products in its own reduction order. Each gradient gate follows the
// predicate of torch's backward for the op the plain version uses:
// clamp_min passes where x >= min, clamp where lo <= x <= hi, the where on
// |tz| < 0.1 and on det == 0 pass where their condition is false.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kSH_C0 = 0.28209479177387814f;
constexpr float kSH_C1 = 0.4886025119029199f;
constexpr float kSH_C2_0 = 1.0925484305920792f;
constexpr float kSH_C2_1 = -1.0925484305920792f;
constexpr float kSH_C2_2 = 0.31539156525252005f;
constexpr float kSH_C2_3 = -1.0925484305920792f;
constexpr float kSH_C2_4 = 0.5462742152960396f;
constexpr float kSH_C3_0 = -0.5900435899266435f;
constexpr float kSH_C3_1 = 2.890611442640554f;
constexpr float kSH_C3_2 = -0.4570457994644658f;
constexpr float kSH_C3_3 = 0.3731763325901154f;
constexpr float kSH_C3_4 = -0.4570457994644658f;
constexpr float kSH_C3_5 = 1.445305721320277f;
constexpr float kSH_C3_6 = -0.5900435899266435f;
constexpr int kMaxCoeffs = 16;  // SH degree 3

// torch's elementwise semantics on float32: NaN propagates through
// clamp_min, clamp and minimum
__device__ __forceinline__ float clamp_min_t(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float minimum_t(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ int clip_grid(int x, int g) { return min(max(x, 0), g); }

struct Camera {
  const float* view;       // [4, 4] W2C
  const float* full_proj;  // [4, 4]
  const float* campos;     // [3]
  const float* tanfovx;    // [] tan(fov_x / 2)
  const float* tanfovy;
  int width, height;
};

// What both kernels compute from a Gaussian's geometry, in the plain
// version's op order (projection.py::preprocess and compute_cov2d,
// transforms.py::build_cov3d).
struct Geom {
  float p_view_z;
  float ph0, ph1, ph3, p_w, pp0, pp1;
  float rot[3][3], s[3], mrow[3][3];  // R, modified scales, M = R S (rows)
  float c[6];                         // cov3d (xx, xy, xz, yy, yz, zz)
  float t0, t1, tz, u, v, ux, uy;     // u = t0 / tz, ux = clamp(u); v, uy for y
  float fx, fy, limx, limy, inv_tz;
  float j00, j02, j11, j12;
  float a[3], b[3];                   // rows of J W
  float sa[3], sb[3];                 // C a and C b (s00.., r00..)
  float cxx, cxy, cyy, det, inv_det;
};

__device__ __forceinline__ void geometry(const float* __restrict__ means3d, const float* __restrict__ scales,
                                         const float* __restrict__ quats, long long i, const Camera& cam,
                                         float scale_modifier, Geom& g) {
  const float* V = cam.view;
  const float* F = cam.full_proj;
  const float m0 = means3d[3 * i], m1 = means3d[3 * i + 1], m2 = means3d[3 * i + 2];
  g.p_view_z = V[8] * m0 + V[9] * m1 + V[10] * m2 + V[11];
  g.ph0 = F[0] * m0 + F[1] * m1 + F[2] * m2 + F[3];
  g.ph1 = F[4] * m0 + F[5] * m1 + F[6] * m2 + F[7];
  g.ph3 = F[12] * m0 + F[13] * m1 + F[14] * m2 + F[15];
  g.p_w = (1.0f / (g.ph3 + 1e-7f)) * 1.0f;
  g.pp0 = g.ph0 * g.p_w;
  g.pp1 = g.ph1 * g.p_w;

  // build_cov3d
  const float w = quats[4 * i], x = quats[4 * i + 1], y = quats[4 * i + 2], z = quats[4 * i + 3];
  for (int k = 0; k < 3; ++k) g.s[k] = scales[3 * i + k] * scale_modifier;
  g.rot[0][0] = 1.0f - 2.0f * (y * y + z * z);
  g.rot[0][1] = 2.0f * (x * y - w * z);
  g.rot[0][2] = 2.0f * (x * z + w * y);
  g.rot[1][0] = 2.0f * (x * y + w * z);
  g.rot[1][1] = 1.0f - 2.0f * (x * x + z * z);
  g.rot[1][2] = 2.0f * (y * z - w * x);
  g.rot[2][0] = 2.0f * (x * z - w * y);
  g.rot[2][1] = 2.0f * (y * z + w * x);
  g.rot[2][2] = 1.0f - 2.0f * (x * x + y * y);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) g.mrow[r][k] = g.rot[r][k] * g.s[k];
  const float(*M)[3] = g.mrow;
  g.c[0] = M[0][0] * M[0][0] + M[0][1] * M[0][1] + M[0][2] * M[0][2];
  g.c[1] = M[0][0] * M[1][0] + M[0][1] * M[1][1] + M[0][2] * M[1][2];
  g.c[2] = M[0][0] * M[2][0] + M[0][1] * M[2][1] + M[0][2] * M[2][2];
  g.c[3] = M[1][0] * M[1][0] + M[1][1] * M[1][1] + M[1][2] * M[1][2];
  g.c[4] = M[1][0] * M[2][0] + M[1][1] * M[2][1] + M[1][2] * M[2][2];
  g.c[5] = M[2][0] * M[2][0] + M[2][1] * M[2][1] + M[2][2] * M[2][2];

  // compute_cov2d: focal = width / (2 tanfov) is reciprocal(2 tanfov) * width
  const float tfx = *cam.tanfovx, tfy = *cam.tanfovy;
  g.fx = (1.0f / (2.0f * tfx)) * (float)cam.width;
  g.fy = (1.0f / (2.0f * tfy)) * (float)cam.height;
  g.t0 = V[0] * m0 + V[1] * m1 + V[2] * m2 + V[3];
  g.t1 = V[4] * m0 + V[5] * m1 + V[6] * m2 + V[7];
  g.tz = fabsf(g.p_view_z) < 0.1f ? 0.1f : g.p_view_z;
  g.limx = 1.3f * tfx;
  g.limy = 1.3f * tfy;
  g.u = g.t0 / g.tz;
  g.v = g.t1 / g.tz;
  g.ux = clamp_t(g.u, -g.limx, g.limx);
  g.uy = clamp_t(g.v, -g.limy, g.limy);
  const float tx = g.ux * g.tz;
  const float ty = g.uy * g.tz;
  g.inv_tz = (1.0f / g.tz) * 1.0f;
  g.j00 = g.fx * g.inv_tz;
  g.j02 = -(g.fx * tx) * g.inv_tz * g.inv_tz;
  g.j11 = g.fy * g.inv_tz;
  g.j12 = -(g.fy * ty) * g.inv_tz * g.inv_tz;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g.a[k] = g.j00 * V[k] + g.j02 * V[8 + k];
    g.b[k] = g.j11 * V[4 + k] + g.j12 * V[8 + k];
  }
  const float* c = g.c;
  const float* a = g.a;
  const float* b = g.b;
  g.sa[0] = a[0] * c[0] + a[1] * c[1] + a[2] * c[2];
  g.sa[1] = a[0] * c[1] + a[1] * c[3] + a[2] * c[4];
  g.sa[2] = a[0] * c[2] + a[1] * c[4] + a[2] * c[5];
  g.sb[0] = b[0] * c[0] + b[1] * c[1] + b[2] * c[2];
  g.sb[1] = b[0] * c[1] + b[1] * c[3] + b[2] * c[4];
  g.sb[2] = b[0] * c[2] + b[1] * c[4] + b[2] * c[5];
  g.cxx = g.sa[0] * a[0] + g.sa[1] * a[1] + g.sa[2] * a[2] + 0.3f;
  g.cxy = g.sa[0] * b[0] + g.sa[1] * b[1] + g.sa[2] * b[2];
  g.cyy = g.sb[0] * b[0] + g.sb[1] * b[1] + g.sb[2] * b[2] + 0.3f;
  g.det = g.cxx * g.cyy - g.cxy * g.cxy;
  g.inv_det = (1.0f / (g.det == 0.0f ? 1.0f : g.det)) * 1.0f;
}

// The real SH basis of sh.py::sh_basis for a unit direction, degree <= 3.
__device__ __forceinline__ void sh_basis(float x, float y, float z, float* B) {
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, yz = y * z, xz = x * z;
  B[0] = kSH_C0;
  B[1] = -kSH_C1 * y;
  B[2] = kSH_C1 * z;
  B[3] = -kSH_C1 * x;
  B[4] = kSH_C2_0 * xy;
  B[5] = kSH_C2_1 * yz;
  B[6] = kSH_C2_2 * (2.0f * zz - xx - yy);
  B[7] = kSH_C2_3 * xz;
  B[8] = kSH_C2_4 * (xx - yy);
  B[9] = kSH_C3_0 * y * (3.0f * xx - yy);
  B[10] = kSH_C3_1 * xy * z;
  B[11] = kSH_C3_2 * y * (4.0f * zz - xx - yy);
  B[12] = kSH_C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
  B[13] = kSH_C3_4 * x * (4.0f * zz - xx - yy);
  B[14] = kSH_C3_5 * z * (xx - yy);
  B[15] = kSH_C3_6 * x * (xx - 3.0f * yy);
}

// d B_j / d(x, y, z) of the basis above, as polynomials in the direction.
__device__ __forceinline__ void sh_basis_grad(int j, float x, float y, float z, float& dx, float& dy, float& dz) {
  const float xx = x * x, yy = y * y, zz = z * z;
  dx = dy = dz = 0.0f;
  switch (j) {
    case 1: dy = -kSH_C1; break;
    case 2: dz = kSH_C1; break;
    case 3: dx = -kSH_C1; break;
    case 4: dx = kSH_C2_0 * y; dy = kSH_C2_0 * x; break;
    case 5: dy = kSH_C2_1 * z; dz = kSH_C2_1 * y; break;
    case 6: dx = -2.0f * kSH_C2_2 * x; dy = -2.0f * kSH_C2_2 * y; dz = 4.0f * kSH_C2_2 * z; break;
    case 7: dx = kSH_C2_3 * z; dz = kSH_C2_3 * x; break;
    case 8: dx = 2.0f * kSH_C2_4 * x; dy = -2.0f * kSH_C2_4 * y; break;
    case 9: dx = 6.0f * kSH_C3_0 * x * y; dy = kSH_C3_0 * (3.0f * xx - 3.0f * yy); break;
    case 10: dx = kSH_C3_1 * y * z; dy = kSH_C3_1 * x * z; dz = kSH_C3_1 * x * y; break;
    case 11:
      dx = -2.0f * kSH_C3_2 * x * y;
      dy = kSH_C3_2 * (4.0f * zz - xx - 3.0f * yy);
      dz = 8.0f * kSH_C3_2 * y * z;
      break;
    case 12:
      dx = -6.0f * kSH_C3_3 * x * z;
      dy = -6.0f * kSH_C3_3 * y * z;
      dz = kSH_C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy);
      break;
    case 13:
      dx = kSH_C3_4 * (4.0f * zz - 3.0f * xx - yy);
      dy = -2.0f * kSH_C3_4 * x * y;
      dz = 8.0f * kSH_C3_4 * x * z;
      break;
    case 14: dx = 2.0f * kSH_C3_5 * x * z; dy = -2.0f * kSH_C3_5 * y * z; dz = kSH_C3_5 * (xx - yy); break;
    case 15: dx = kSH_C3_6 * (3.0f * xx - 3.0f * yy); dy = -6.0f * kSH_C3_6 * x * y; break;
    default: break;
  }
}

// The view direction of sh.py::eval_sh_color: d = mean - campos, scaled by
// rsqrt(|d|^2 + 1e-24).
struct ViewDir {
  float d[3], r, dir[3];
};

__device__ __forceinline__ void view_dir(const float* __restrict__ means3d, long long i, const float* campos,
                                         ViewDir& vd) {
#pragma unroll
  for (int k = 0; k < 3; ++k) vd.d[k] = means3d[3 * i + k] - campos[k];
  vd.r = rsqrtf(vd.d[0] * vd.d[0] + vd.d[1] * vd.d[1] + vd.d[2] * vd.d[2] + 1e-24f);
#pragma unroll
  for (int k = 0; k < 3; ++k) vd.dir[k] = vd.d[k] * vd.r;
}

// coefficient j, channel ch: dc [P, 1, 3] for j == 0, then the Gaussian's
// own sh_rest row [R, 3]
__device__ __forceinline__ float coeff(const float* __restrict__ dc, const float* rest_row, long long i, int j,
                                       int ch) {
  return j == 0 ? dc[3 * i + ch] : rest_row[(j - 1) * 3 + ch];
}

__global__ void preprocess_fwd_kernel(const float* __restrict__ means3d, const float* __restrict__ scales,
                                      const float* __restrict__ quats, const float* __restrict__ opacities,
                                      const float* __restrict__ dc, const float* __restrict__ rest, int n_rest,
                                      const float* __restrict__ offset, const float* __restrict__ colors_precomp,
                                      long long cp_s0, long long cp_s1, Camera cam, long long P, int grid_w,
                                      int grid_h, int n_coeffs, float scale_modifier, float* __restrict__ means2d,
                                      float* __restrict__ depths, float* __restrict__ conics,
                                      float* __restrict__ colors, int* __restrict__ radii,
                                      int* __restrict__ rect_min, int* __restrict__ rect_max,
                                      int* __restrict__ tiles_touched) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P) return;
  Geom g;
  geometry(means3d, scales, quats, i, cam, scale_modifier, g);
  bool valid = g.p_view_z > 0.2f;
  valid = valid && (g.det != 0.0f);

  const float mid = 0.5f * (g.cxx + g.cyy);
  const float lambda1 = mid + sqrtf(clamp_min_t(mid * mid - g.det, 0.1f));
  const float rf = ceilf(3.0f * sqrtf(lambda1));

  float mx = ((g.pp0 + 1.0f) * (float)cam.width - 1.0f) * 0.5f;
  float my = ((g.pp1 + 1.0f) * (float)cam.height - 1.0f) * 0.5f;
  if (offset != nullptr) {
    mx = mx + offset[2 * i];
    my = my + offset[2 * i + 1];
  }

  // the opacity-tight rect (PARITY.md D7), capped at the 3-sigma rect
  const float op = opacities[i];
  const float power_cap = clamp_min_t(2.0f * logf(clamp_min_t(op, 1e-30f) * 255.0f), 0.0f);
  const float ext_x = minimum_t(ceilf(sqrtf(power_cap * clamp_min_t(g.cxx, 0.0f))), rf);
  const float ext_y = minimum_t(ceilf(sqrtf(power_cap * clamp_min_t(g.cyy, 0.0f))), rf);
  const int rmin3_x = clip_grid((int)((mx - rf) / 16.0f), grid_w);
  const int rmin3_y = clip_grid((int)((my - rf) / 16.0f), grid_h);
  const int rmax3_x = min((int)clamp_min_t((mx + rf + 16.0f - 1.0f) / 16.0f, 0.0f), grid_w);
  const int rmax3_y = min((int)clamp_min_t((my + rf + 16.0f - 1.0f) / 16.0f, 0.0f), grid_h);
  const int area3 = (rmax3_x - rmin3_x) * (rmax3_y - rmin3_y);
  const int rmin_x = clip_grid((int)((mx - ext_x) / 16.0f), grid_w);
  const int rmin_y = clip_grid((int)((my - ext_y) / 16.0f), grid_h);
  const int rmax_x = min(min((int)clamp_min_t(floorf(mx + ext_x) / 16.0f + 1.0f, 0.0f), rmax3_x), grid_w);
  const int rmax_y = min(min((int)clamp_min_t(floorf(my + ext_y) / 16.0f + 1.0f, 0.0f), rmax3_y), grid_h);
  const int area = op * 255.0f < 1.0f ? 0 : (rmax_x - rmin_x) * (rmax_y - rmin_y);
  const bool valid_radii = valid && area3 > 0;
  valid = valid && area > 0;

  means2d[2 * i] = mx;
  means2d[2 * i + 1] = my;
  depths[i] = g.p_view_z;
  conics[3 * i] = g.cyy * g.inv_det;
  conics[3 * i + 1] = -g.cxy * g.inv_det;
  conics[3 * i + 2] = g.cxx * g.inv_det;
  radii[i] = (int)(valid_radii ? rf : 0.0f);
  rect_min[2 * i] = rmin_x;
  rect_min[2 * i + 1] = rmin_y;
  rect_max[2 * i] = rmax_x;
  rect_max[2 * i + 1] = rmax_y;
  tiles_touched[i] = valid ? area : 0;

  if (colors_precomp != nullptr) {
    for (int ch = 0; ch < 3; ++ch) colors[3 * i + ch] = colors_precomp[i * cp_s0 + ch * cp_s1];
    return;
  }
  ViewDir vd;
  view_dir(means3d, i, cam.campos, vd);
  float B[kMaxCoeffs];
  sh_basis(vd.dir[0], vd.dir[1], vd.dir[2], B);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxCoeffs; ++j)
      if (j < n_coeffs) acc = acc + B[j] * coeff(dc, rest + i * n_rest * 3, i, j, ch);
    colors[3 * i + ch] = clamp_min_t(acc + 0.5f, 0.0f);
  }
}

// Cotangent element (row i, column k) through row and column strides; a
// null cotangent reads as zero.
__device__ __forceinline__ float ct(const float* __restrict__ t, long long s0, long long s1, long long i, int k) {
  return t == nullptr ? 0.0f : t[i * s0 + k * s1];
}

// Gaussian i's gradients. rest_row is its sh_rest row in shared memory,
// overwritten with that row's gradient; a null g_dc skips the colours
// (given, not from SH).
__device__ __forceinline__ void grads_of(
    const float* __restrict__ means3d, const float* __restrict__ scales, const float* __restrict__ quats,
    const float* __restrict__ dc, float* rest_row, int n_rest, const Camera& cam, long long i, int n_coeffs,
    float scale_modifier, const float* __restrict__ g_m2d, long long gm_s0, long long gm_s1,
    const float* __restrict__ g_dep, long long gd_s0, const float* __restrict__ g_con, long long gk_s0,
    long long gk_s1, const float* __restrict__ g_col, long long gc_s0, long long gc_s1,
    float* __restrict__ g_means, float* __restrict__ g_scales, float* __restrict__ g_quats,
    float* __restrict__ g_dc) {
  const float* V = cam.view;
  const float* F = cam.full_proj;
  Geom g;
  geometry(means3d, scales, quats, i, cam, scale_modifier, g);
  float gm[3] = {0.0f, 0.0f, 0.0f};

  // means2d = ((p_hom.xy * p_w + 1) * size - 1) * 0.5 (+ offset)
  const float g_pp0 = ct(g_m2d, gm_s0, gm_s1, i, 0) * 0.5f * (float)cam.width;
  const float g_pp1 = ct(g_m2d, gm_s0, gm_s1, i, 1) * 0.5f * (float)cam.height;
  const float g_ph0 = g_pp0 * g.p_w;
  const float g_ph1 = g_pp1 * g.p_w;
  const float g_ph3 = (g_pp0 * g.ph0 + g_pp1 * g.ph1) * -(g.p_w * g.p_w);
  const float g_depth = g_dep == nullptr ? 0.0f : g_dep[i * gd_s0];
#pragma unroll
  for (int k = 0; k < 3; ++k) gm[k] = g_ph0 * F[k] + g_ph1 * F[4 + k] + g_ph3 * F[12 + k] + g_depth * V[8 + k];

  // conics = (cyy, -cxy, cxx) / det, det == 0 passing nothing
  const float gk0 = ct(g_con, gk_s0, gk_s1, i, 0), gk1 = ct(g_con, gk_s0, gk_s1, i, 1),
              gk2 = ct(g_con, gk_s0, gk_s1, i, 2);
  float gxx = gk2 * g.inv_det, gyy = gk0 * g.inv_det, gxy = -gk1 * g.inv_det;
  const float g_inv = gk0 * g.cyy - gk1 * g.cxy + gk2 * g.cxx;
  const float g_det = g.det != 0.0f ? g_inv * -(g.inv_det * g.inv_det) : 0.0f;
  gxx += g_det * g.cyy;
  gyy += g_det * g.cxx;
  gxy -= 2.0f * g_det * g.cxy;

  // cov2d = (a C a + 0.3, a C b, b C b + 0.3) with the packed symmetric C
  const float* a = g.a;
  const float* b = g.b;
  float gc[6];
  gc[0] = gxx * a[0] * a[0] + gxy * a[0] * b[0] + gyy * b[0] * b[0];
  gc[1] = 2.0f * gxx * a[0] * a[1] + gxy * (a[0] * b[1] + a[1] * b[0]) + 2.0f * gyy * b[0] * b[1];
  gc[2] = 2.0f * gxx * a[0] * a[2] + gxy * (a[0] * b[2] + a[2] * b[0]) + 2.0f * gyy * b[0] * b[2];
  gc[3] = gxx * a[1] * a[1] + gxy * a[1] * b[1] + gyy * b[1] * b[1];
  gc[4] = 2.0f * gxx * a[1] * a[2] + gxy * (a[1] * b[2] + a[2] * b[1]) + 2.0f * gyy * b[1] * b[2];
  gc[5] = gxx * a[2] * a[2] + gxy * a[2] * b[2] + gyy * b[2] * b[2];
  float ga[3], gb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ga[k] = 2.0f * gxx * g.sa[k] + gxy * g.sb[k];
    gb[k] = gxy * g.sa[k] + 2.0f * gyy * g.sb[k];
  }

  // a = j00 W0 + j02 W2, b = j11 W1 + j12 W2
  const float g_j00 = ga[0] * V[0] + ga[1] * V[1] + ga[2] * V[2];
  const float g_j02 = ga[0] * V[8] + ga[1] * V[9] + ga[2] * V[10];
  const float g_j11 = gb[0] * V[4] + gb[1] * V[5] + gb[2] * V[6];
  const float g_j12 = gb[0] * V[8] + gb[1] * V[9] + gb[2] * V[10];
  const float tx = g.ux * g.tz, ty = g.uy * g.tz;
  const float inv_tz2 = g.inv_tz * g.inv_tz;
  const float g_inv_tz = g_j00 * g.fx + g_j11 * g.fy + g_j02 * -(g.fx * tx) * 2.0f * g.inv_tz +
                         g_j12 * -(g.fy * ty) * 2.0f * g.inv_tz;
  const float g_tx = -g_j02 * g.fx * inv_tz2;
  const float g_ty = -g_j12 * g.fy * inv_tz2;
  float g_tz = -g_inv_tz * inv_tz2;
  // tx = clamp(t0 / tz, +-1.3 tanfovx) * tz; the clamp passes where inside
  g_tz += g_tx * g.ux + g_ty * g.uy;
  const float g_u = (g.u >= -g.limx && g.u <= g.limx) ? g_tx * g.tz : 0.0f;
  const float g_v = (g.v >= -g.limy && g.v <= g.limy) ? g_ty * g.tz : 0.0f;
  const float g_t0 = g_u / g.tz;
  const float g_t1 = g_v / g.tz;
  g_tz += -g_u * g.t0 / (g.tz * g.tz) - g_v * g.t1 / (g.tz * g.tz);
  // tz = where(|z| < 0.1, 0.1, z)
  const float g_t2 = fabsf(g.p_view_z) < 0.1f ? 0.0f : g_tz;
#pragma unroll
  for (int k = 0; k < 3; ++k) gm[k] += g_t0 * V[k] + g_t1 * V[4 + k] + g_t2 * V[8 + k];

  // cov3d = M M^T, M = R diag(s)
  const float(*M)[3] = g.mrow;
  float gM[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gM[0][k] = 2.0f * gc[0] * M[0][k] + gc[1] * M[1][k] + gc[2] * M[2][k];
    gM[1][k] = gc[1] * M[0][k] + 2.0f * gc[3] * M[1][k] + gc[4] * M[2][k];
    gM[2][k] = gc[2] * M[0][k] + gc[4] * M[1][k] + 2.0f * gc[5] * M[2][k];
  }
  float gR[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    g_scales[3 * i + k] =
        (gM[0][k] * g.rot[0][k] + gM[1][k] * g.rot[1][k] + gM[2][k] * g.rot[2][k]) * scale_modifier;
#pragma unroll
    for (int r = 0; r < 3; ++r) gR[r][k] = gM[r][k] * g.s[k];
  }
  const float w = quats[4 * i], x = quats[4 * i + 1], y = quats[4 * i + 2], z = quats[4 * i + 3];
  g_quats[4 * i] =
      2.0f * (-z * gR[0][1] + y * gR[0][2] + z * gR[1][0] - x * gR[1][2] - y * gR[2][0] + x * gR[2][1]);
  g_quats[4 * i + 1] = 2.0f * (y * gR[0][1] + z * gR[0][2] + y * gR[1][0] - 2.0f * x * gR[1][1] - w * gR[1][2] +
                               z * gR[2][0] + w * gR[2][1] - 2.0f * x * gR[2][2]);
  g_quats[4 * i + 2] = 2.0f * (-2.0f * y * gR[0][0] + x * gR[0][1] + w * gR[0][2] + x * gR[1][0] + z * gR[1][2] -
                               w * gR[2][0] + z * gR[2][1] - 2.0f * y * gR[2][2]);
  g_quats[4 * i + 3] = 2.0f * (-2.0f * z * gR[0][0] - w * gR[0][1] + x * gR[0][2] + w * gR[1][0] -
                               2.0f * z * gR[1][1] + y * gR[1][2] + x * gR[2][0] + y * gR[2][1]);

  if (g_dc != nullptr) {
    // colours = clamp_min(sum_j B_j(dir) coeff_j + 0.5, 0)
    ViewDir vd;
    view_dir(means3d, i, cam.campos, vd);
    float B[kMaxCoeffs];
    sh_basis(vd.dir[0], vd.dir[1], vd.dir[2], B);
    float gcol[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxCoeffs; ++j)
        if (j < n_coeffs) acc = acc + B[j] * coeff(dc, rest_row, i, j, ch);
      gcol[ch] = acc + 0.5f >= 0.0f ? ct(g_col, gc_s0, gc_s1, i, ch) : 0.0f;
    }
    float gdir[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < kMaxCoeffs; ++j) {
      if (j >= n_coeffs) break;
      float gB = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float gco = gcol[ch] * B[j];
        gB += gcol[ch] * coeff(dc, rest_row, i, j, ch);
        if (j == 0)
          g_dc[3 * i + ch] = gco;
        else
          rest_row[(j - 1) * 3 + ch] = gco;
      }
      float dx, dy, dz;
      sh_basis_grad(j, vd.dir[0], vd.dir[1], vd.dir[2], dx, dy, dz);
      gdir[0] += gB * dx;
      gdir[1] += gB * dy;
      gdir[2] += gB * dz;
    }
    if (n_coeffs <= 0)
      for (int ch = 0; ch < 3; ++ch) g_dc[3 * i + ch] = 0.0f;
    // rows above the active degree get zeros, as autograd gives them
    for (int j = max(n_coeffs, 1); j <= n_rest; ++j)
      for (int ch = 0; ch < 3; ++ch) rest_row[(j - 1) * 3 + ch] = 0.0f;
    // dir = d * rsqrt(|d|^2 + eps)
    const float dot = gdir[0] * vd.d[0] + gdir[1] * vd.d[1] + gdir[2] * vd.d[2];
    const float r3 = vd.r * vd.r * vd.r;
#pragma unroll
    for (int k = 0; k < 3; ++k) gm[k] += gdir[k] * vd.r - dot * r3 * vd.d[k];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) g_means[3 * i + k] = gm[k];
}

__global__ void preprocess_bwd_kernel(
    const float* __restrict__ means3d, const float* __restrict__ scales, const float* __restrict__ quats,
    const float* __restrict__ dc, const float* __restrict__ rest, int n_rest, Camera cam, long long P,
    int n_coeffs, float scale_modifier, const float* __restrict__ g_m2d, long long gm_s0, long long gm_s1,
    const float* __restrict__ g_dep, long long gd_s0, const float* __restrict__ g_con, long long gk_s0,
    long long gk_s1, const float* __restrict__ g_col, long long gc_s0, long long gc_s1,
    float* __restrict__ g_means, float* __restrict__ g_scales, float* __restrict__ g_quats,
    float* __restrict__ g_dc, float* __restrict__ g_rest) {
  // the block's sh_rest rows [blockDim.x, R, 3], then their gradients
  extern __shared__ float s_rest[];
  const long long first = (long long)blockIdx.x * blockDim.x;
  const long long i = first + threadIdx.x;
  const int row = n_rest * 3;
  const long long block_floats = min((long long)blockDim.x, P - first) * row;
  const bool sh = g_dc != nullptr;
  if (sh) {
    for (long long t = threadIdx.x; t < block_floats; t += blockDim.x) s_rest[t] = rest[first * row + t];
    __syncthreads();
  }
  if (i < P)
    grads_of(means3d, scales, quats, dc, s_rest + threadIdx.x * row, n_rest, cam, i, n_coeffs, scale_modifier,
             g_m2d, gm_s0, gm_s1, g_dep, gd_s0, g_con, gk_s0, gk_s1, g_col, gc_s0, gc_s1, g_means, g_scales,
             g_quats, g_dc);
  if (sh) {
    __syncthreads();
    for (long long t = threadIdx.x; t < block_floats; t += blockDim.x) g_rest[first * row + t] = s_rest[t];
  }
}

constexpr int kThreads = 256;
// the backward's blocks hold their sh_rest rows in shared memory: 23 KB at
// 15 rows, so that several blocks share an SM
constexpr int kBwdThreads = 128;

}  // namespace

extern "C" int gsdf_preprocess_fwd(const void* means3d, const void* scales, const void* quats,
                                   const void* opacities, const void* dc, const void* sh_rest, int n_rest,
                                   const void* offset, const void* colors_precomp, long long cp_s0,
                                   long long cp_s1, const void* view, const void* full_proj, const void* campos,
                                   const void* tanfovx, const void* tanfovy, long long P, int width, int height,
                                   int grid_w, int grid_h, int n_coeffs, float scale_modifier, void* means2d,
                                   void* depths, void* conics, void* colors, void* radii, void* rect_min,
                                   void* rect_max, void* tiles_touched, void* stream) {
  if (P <= 0) return 0;
  const Camera cam{(const float*)view, (const float*)full_proj, (const float*)campos,
                   (const float*)tanfovx, (const float*)tanfovy, width, height};
  const long long blocks = (P + kThreads - 1) / kThreads;
  preprocess_fwd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means3d, (const float*)scales, (const float*)quats, (const float*)opacities,
      (const float*)dc, (const float*)sh_rest, n_rest, (const float*)offset, (const float*)colors_precomp,
      cp_s0, cp_s1, cam, P, grid_w, grid_h, n_coeffs, scale_modifier, (float*)means2d, (float*)depths,
      (float*)conics, (float*)colors, (int*)radii, (int*)rect_min, (int*)rect_max, (int*)tiles_touched);
  return (int)cudaGetLastError();
}

extern "C" int gsdf_preprocess_bwd(const void* means3d, const void* scales, const void* quats, const void* dc,
                                   const void* sh_rest, int n_rest, const void* view, const void* full_proj,
                                   const void* campos, const void* tanfovx, const void* tanfovy, long long P,
                                   int width, int height, int n_coeffs, float scale_modifier,
                                   const void* g_means2d, long long gm_s0, long long gm_s1,
                                   const void* g_depths, long long gd_s0, const void* g_conics, long long gk_s0,
                                   long long gk_s1, const void* g_colors, long long gc_s0, long long gc_s1,
                                   void* g_means3d, void* g_scales, void* g_quats, void* g_dc, void* g_rest,
                                   void* stream) {
  if (P <= 0) return 0;
  const Camera cam{(const float*)view, (const float*)full_proj, (const float*)campos,
                   (const float*)tanfovx, (const float*)tanfovy, width, height};
  const size_t smem = g_dc != nullptr ? (size_t)kBwdThreads * n_rest * 3 * sizeof(float) : 0;
  // more SH rows than a block's default shared memory holds
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long blocks = (P + kBwdThreads - 1) / kBwdThreads;
  preprocess_bwd_kernel<<<(unsigned)blocks, kBwdThreads, smem, (cudaStream_t)stream>>>(
      (const float*)means3d, (const float*)scales, (const float*)quats, (const float*)dc,
      (const float*)sh_rest, n_rest, cam, P, n_coeffs, scale_modifier, (const float*)g_means2d, gm_s0, gm_s1,
      (const float*)g_depths, gd_s0, (const float*)g_conics, gk_s0, gk_s1, (const float*)g_colors, gc_s0,
      gc_s1, (float*)g_means3d, (float*)g_scales, (float*)g_quats, (float*)g_dc, (float*)g_rest);
  return (int)cudaGetLastError();
}
