// loss_fwd and loss_bwd: the mapper's training loss, (1 - l) * L1 +
// l * (1 - mean SSIM), and its gradient with respect to the render.
//
// Replaces no Pallas kernel: the JAX package leaves the loss
// (gsdf_slam_tpu/ops/losses.py::mapper_loss) to XLA's fusion. Written as
// plain torch ops, the port issued ~256 launches for the loss and ~233 for
// its autograd backward, each over a full image: D-SSIM's five Gaussian
// filters as 2 pads and 22 scaled adds each. These kernels do the same work
// in two launches forward (the tiles, then one block that sums their
// partial sums) and one backward, the design of the public "fused-ssim"
// kernels with the L1 term and the mask fused in.
//
// Semantics (ops/losses.py::mapper_loss_plain): m = where(mask, render, 1),
// g = where(mask, gt, 1); L1 = mean |m - g|; SSIM compares m against the
// UNMASKED gt (the reference's quirk, kept). The window is the separable
// 11-tap sigma = 1.5 Gaussian with zero padding, filtered along H (dim 0)
// first, then along W, each pass accumulating taps k = 0..10 from
// taps[0] * x[0] on, as the plain version's shift-adds; C1 = 1e-4,
// C2 = 9e-4. Float32 throughout; the library is built with --fmad=false and
// each formula is written in the plain version's op order, so the filtered
// moments, the SSIM map, its derivative maps and the gradient are those of
// ops/losses.py's plain versions on the card; only the two means differ, by
// their summation order.
//
// Forward: one block of 16 x 32 threads per 16-row, 32-column tile of
// pixels. All three channels of both images (the render through its
// strides, masked) are staged into shared memory with the 5-pixel zero
// halo; per channel, a pass along H gives the five sums (x, y, x^2, y^2,
// xy) on the tile's rows and the halo's columns, a pass along W the five
// moments on the tile. Each pixel's SSIM and its partial derivatives dS /
// d mu1 (through sigma1^2 and sigma12 as well), dS / d sigma1^2 and dS /
// d sigma12 are written, planar [3 maps][3 channels][H][W], for the
// backward. Each block writes its partial sums of |m - g| and of SSIM; a
// second launch, one block, sums them in a fixed order (in double) and
// writes the loss on the device.
//
// Backward: the upstream gradient is read from the device. The three
// derivative maps are filtered again with the mirrored taps (the adjoint of
// the zero-padded filter; the window is symmetric, so the same taps, along
// H then W), and dL / d render = where(mask, (1 - l) / N * sgn(m - g) -
// l / N * [F(dmu1) + 2 m F(dsigma1^2) + gt F(dsigma12)], 0) * upstream.
//
// No float atomics: every sum has a fixed order, so a run's loss and
// gradient are repeatable bit for bit.
//
// Bound: bytes. At 1226 x 370 x 3 float32 an image is 5.44 MB. Forward:
// the two images read, the three derivative maps written: 27.2 MB, >= 8.1 us
// at 3.35 TB/s. Backward: the three maps and the two images read, the
// gradient written: 32.7 MB, >= 9.8 us. A mask adds a quarter image read
// to each. The operations (~300 a pixel-channel forward, ~200 backward) are
// under the bytes at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace {

constexpr int kTaps = 11;
constexpr int kRad = kTaps / 2;
constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kExtH = kTileH + 2 * kRad;  // 26 rows with the halo
constexpr int kExtW = kTileW + 2 * kRad;  // 42 columns with the halo
constexpr int kExt = kExtH * kExtW;
constexpr int kMid = kTileH * kExtW;      // after the pass along H
constexpr int kFinThreads = 256;
static_assert(2 * kThreads <= 5 * kMid, "the forward's block sums reuse its shared pass buffer");

struct Taps {
  float t[kTaps];
};

// An HWC image read through its strides (elements); a mask with null `p`
// keeps every pixel.
struct Image {
  const float* p;
  long long s0, s1, s2;
  __device__ __forceinline__ float at(int y, int x, int c) const {
    return p[(long long)y * s0 + (long long)x * s1 + (long long)c * s2];
  }
};

__device__ __forceinline__ bool kept(const Image& mask, int y, int x, int c) {
  return mask.p == nullptr || mask.at(y, x, c) > 0.0f;
}

__global__ void __launch_bounds__(kThreads) loss_fwd_kernel(Image img, Image gt, Image mask, int H, int W,
                                                            Taps taps, float c1, float c2, float* __restrict__ dmaps,
                                                            float* __restrict__ partials) {
  __shared__ float sx[3][kExt];  // masked render, zero outside the image
  __shared__ float sy[3][kExt];  // gt
  __shared__ float mid[5][kMid];
  const int tid = threadIdx.x;
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  for (int e = tid; e < kExtH * kExtW * 3; e += kThreads) {
    const int r = e / (kExtW * 3), k = e % (kExtW * 3);
    const int px = k / 3, c = k % 3;
    const int gy = y0 - kRad + r, gx = x0 - kRad + px;
    float v = 0.0f, w = 0.0f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = kept(mask, gy, gx, c) ? img.at(gy, gx, c) : 1.0f;
      w = gt.at(gy, gx, c);
    }
    sx[c][r * kExtW + px] = v;
    sy[c][r * kExtW + px] = w;
  }
  const int y = y0 + ty, x = x0 + tx;
  const bool inside = y < H && x < W;
  const long long plane = (long long)H * W;
  float l1 = 0.0f, ssum = 0.0f;
  for (int c = 0; c < 3; ++c) {
    __syncthreads();  // the staging, or the previous channel's pass along W
    for (int i = tid; i < kMid; i += kThreads) {
      const int r = i / kExtW, col = i % kExtW;
      const float* px = &sx[c][r * kExtW + col];
      const float* py = &sy[c][r * kExtW + col];
      float m1 = 0.0f, m2 = 0.0f, e11 = 0.0f, e22 = 0.0f, e12 = 0.0f;
#pragma unroll
      for (int k = 0; k < kTaps; ++k) {
        const float v = px[k * kExtW], w = py[k * kExtW];
        const float vv = v * v, ww = w * w, vw = v * w;
        if (k == 0) {
          m1 = taps.t[0] * v;
          m2 = taps.t[0] * w;
          e11 = taps.t[0] * vv;
          e22 = taps.t[0] * ww;
          e12 = taps.t[0] * vw;
        } else {
          m1 = m1 + taps.t[k] * v;
          m2 = m2 + taps.t[k] * w;
          e11 = e11 + taps.t[k] * vv;
          e22 = e22 + taps.t[k] * ww;
          e12 = e12 + taps.t[k] * vw;
        }
      }
      mid[0][i] = m1;
      mid[1][i] = m2;
      mid[2][i] = e11;
      mid[3][i] = e22;
      mid[4][i] = e12;
    }
    __syncthreads();
    float f[5];
#pragma unroll
    for (int q = 0; q < 5; ++q) {
      const float* row = &mid[q][ty * kExtW + tx];
      float acc = taps.t[0] * row[0];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * row[k];
      f[q] = acc;
    }
    if (inside) {
      const float mu1 = f[0], mu2 = f[1];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float sigma1_sq = f[2] - mu1_sq, sigma2_sq = f[3] - mu2_sq, sigma12 = f[4] - mu1_mu2;
      const float a1 = 2.0f * mu1_mu2 + c1, a2 = 2.0f * sigma12 + c2;
      const float b1 = mu1_sq + mu2_sq + c1, b2 = sigma1_sq + sigma2_sq + c2;
      const float den = b1 * b2;
      const float s = (a1 * a2) / den;
      const long long o = (long long)y * W + x;
      dmaps[(0 * 3 + c) * plane + o] = 2.0f * (mu2 * (a2 - a1) + mu1 * s * (b1 - b2)) / den;
      dmaps[(1 * 3 + c) * plane + o] = -s / b2;
      dmaps[(2 * 3 + c) * plane + o] = 2.0f * a1 / den;
      ssum += s;
      const float m = sx[c][(ty + kRad) * kExtW + tx + kRad];
      const float g = kept(mask, y, x, c) ? sy[c][(ty + kRad) * kExtW + tx + kRad] : 1.0f;
      l1 += fabsf(m - g);
    }
  }
  // the block's sums in a fixed order: a tree over the threads
  __syncthreads();
  float* red = &mid[0][0];  // 2 * kThreads floats of the 5 * kMid
  red[tid] = l1;
  red[kThreads + tid] = ssum;
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (tid < half) {
      red[tid] = red[tid] + red[tid + half];
      red[kThreads + tid] = red[kThreads + tid] + red[kThreads + tid + half];
    }
  }
  if (tid == 0) {
    const int b = blockIdx.y * gridDim.x + blockIdx.x;
    partials[2 * b] = red[0];
    partials[2 * b + 1] = red[kThreads];
  }
}

// One block: the tiles' partial sums in a fixed order, in double, then the
// loss (1 - l) * L1 + l * (1 - SSIM).
__global__ void __launch_bounds__(kFinThreads) loss_finalize_kernel(const float* __restrict__ partials, int n_blocks,
                                                                    double n, double lam,
                                                                    float* __restrict__ loss) {
  __shared__ double red[2][kFinThreads];
  const int tid = threadIdx.x;
  double l1 = 0.0, ssum = 0.0;
  for (int b = tid; b < n_blocks; b += kFinThreads) {
    l1 += (double)partials[2 * b];
    ssum += (double)partials[2 * b + 1];
  }
  red[0][tid] = l1;
  red[1][tid] = ssum;
  for (int half = kFinThreads / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (tid < half) {
      red[0][tid] += red[0][tid + half];
      red[1][tid] += red[1][tid + half];
    }
  }
  if (tid == 0) *loss = (float)((1.0 - lam) * (red[0][0] / n) + lam * (1.0 - red[1][0] / n));
}

__global__ void __launch_bounds__(kThreads) loss_bwd_kernel(Image img, Image gt, Image mask, int H, int W,
                                                            Taps taps, const float* __restrict__ dmaps,
                                                            const float* __restrict__ upstream, float a, float b,
                                                            float* __restrict__ grad) {
  __shared__ float sd[3][kExt];  // one channel's three derivative maps, zero outside the image
  __shared__ float mid[3][kMid];
  const int tid = threadIdx.x;
  const int tx = tid % kTileW, ty = tid / kTileW;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const long long plane = (long long)H * W;
  float fd[3][3];  // [channel][map]
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c > 0) __syncthreads();  // the previous channel's pass along W
    for (int e = tid; e < 3 * kExt; e += kThreads) {
      const int q = e / kExt, k = e % kExt;
      const int r = k / kExtW, col = k % kExtW;
      const int gy = y0 - kRad + r, gx = x0 - kRad + col;
      sd[q][k] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? dmaps[(q * 3 + c) * plane + (long long)gy * W + gx]
                                                          : 0.0f;
    }
    __syncthreads();
    for (int i = tid; i < kMid; i += kThreads) {
      const int r = i / kExtW, col = i % kExtW;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* p = &sd[q][r * kExtW + col];
        float acc = taps.t[0] * p[0];
#pragma unroll
        for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * p[k * kExtW];
        mid[q][i] = acc;
      }
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float* row = &mid[q][ty * kExtW + tx];
      float acc = taps.t[0] * row[0];
#pragma unroll
      for (int k = 1; k < kTaps; ++k) acc = acc + taps.t[k] * row[k];
      fd[c][q] = acc;
    }
  }
  const int y = y0 + ty, x = x0 + tx;
  if (y >= H || x >= W) return;
  const float up = *upstream;
  float* out = grad + ((long long)y * W + x) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = 0.0f;
    if (kept(mask, y, x, c)) {
      const float m = img.at(y, x, c), w = gt.at(y, x, c);
      const float d = m - w;
      const float sgn = (float)((d > 0.0f) - (d < 0.0f));
      v = (a * sgn - b * (fd[c][0] + 2.0f * m * fd[c][1] + w * fd[c][2])) * up;
    }
    out[c] = v;
  }
}

Taps read_taps(const void* taps_host) {
  Taps t;
  for (int k = 0; k < kTaps; ++k) t.t[k] = static_cast<const float*>(taps_host)[k];
  return t;
}

}  // namespace

// The images are HWC float32 read through their strides (elements); mask is
// null or float32 broadcast to [H, W, 3] through its strides; taps_host a
// host array of the 11 float32 taps. dmaps [3, 3, H, W] and partials
// [2 * blocks] are scratch the wrapper allocates; loss a float32 scalar.
extern "C" int gsdf_loss_fwd(const void* img, long long i0, long long i1, long long i2, const void* gt,
                             long long g0, long long g1, long long g2, const void* mask, long long m0, long long m1,
                             long long m2, int H, int W, const void* taps_host, float c1, float c2, double lam,
                             void* dmaps, void* partials, void* loss, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  loss_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Image{(const float*)img, i0, i1, i2}, Image{(const float*)gt, g0, g1, g2}, Image{(const float*)mask, m0, m1, m2},
      H, W, read_taps(taps_host), c1, c2, (float*)dmaps, (float*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  loss_finalize_kernel<<<1, kFinThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, (int)(grid.x * grid.y), 3.0 * H * W, lam, (float*)loss);
  return (int)cudaGetLastError();
}

// a = (1 - l) / N and b = l / N; upstream a float32 scalar on the device;
// grad [H, W, 3] contiguous.
extern "C" int gsdf_loss_bwd(const void* img, long long i0, long long i1, long long i2, const void* gt,
                             long long g0, long long g1, long long g2, const void* mask, long long m0, long long m1,
                             long long m2, int H, int W, const void* taps_host, const void* dmaps,
                             const void* upstream, float a, float b, void* grad, void* stream) {
  if (H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  loss_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      Image{(const float*)img, i0, i1, i2}, Image{(const float*)gt, g0, g1, g2}, Image{(const float*)mask, m0, m1, m2},
      H, W, read_taps(taps_host), (const float*)dmaps, (const float*)upstream, a, b, (float*)grad);
  return (int)cudaGetLastError();
}
