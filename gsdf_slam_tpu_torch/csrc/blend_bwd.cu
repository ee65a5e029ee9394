// K2 blend_bwd: backward alpha blend and the fold to per-Gaussian gradients.
//
// Replaces gsdf_slam_tpu/ops/pallas_blend_grouped.py::_bwd_kernel
// (launched by _run_bwd) and the XLA fold _fold_pair_grads. The TPU kernel
// walks each 8-tile group's chunks in reverse from the raw log T, rebuilds
// T in the log domain, carries the suffix sum of w * (c . ct) and writes
// per-pair gradients into a [16, MPA] buffer, which a sort-based fold then
// sums per Gaussian.
//
// Here: the per-Gaussian backward of the reference (PerGaussianRenderCUDA,
// backward.cu:464-654). The unit of work is a bucket, 32 consecutive pairs
// of one tile, held by one warp with lane l owning pair j = 32b + l. The
// warp sweeps the tile's 256 pixels diagonally: at step s lane l handles
// pixel s - l. Lane 0 takes the pixel's checkpoint for the bucket from K1
// (log T and the colour sums c0, c1, c2 at pair 32b), and each lane hands
// the pixel's running (log T, C) to lane l + 1 with __shfl_up_sync. Where
// j < n_contrib[p] and the pair is live at p, the lane rebuilds the
// forward's step with the forward's own operations, T = expf(log T),
// w = alpha * T, C += w * c_j, log T += log1pf(-alpha), so T and C are
// bit-equal to K1's running values, and takes the suffix of later colour
// as ct . (accum - C), the float32 difference of two values of that same
// sequence: exact where they are close, so its error is the rounding of
// the forward's later additions, a few ulps of |accum| (the wall, at T
// down to 1e-4 and alpha 0.9, holds it to the 2e-5 bar). Conventions
// (backward.cu:598-640, ops/blend.py): dL/dalpha = T * (c . ct) -
// (suffix + ct_eff) / (1 - alpha); the 0.99 clamp is not gated, dL/dG =
// opacity * dL/dalpha. Each lane sums its pair's nine gradients (mean x,
// y; conic a, b, c; opacity; rgb) over the pixels in registers and adds
// them to the per-Gaussian buffer [P, 9] with nine atomicAdds, if some
// pixel took the pair. Atomics change the summation order from run to run;
// the JAX sorted fold is itself only good to about 3e-4 absolute at 1.2M
// pairs (pallas_blend_grouped.py:611-614), so this is the same numeric
// class.
//
// The grid: one block of 8 warps per tile. The per-pixel constants the
// sweep reads at every step (ct_accum, ct_log_t_eff, accum, n_contrib) are
// staged once per tile in shared memory (8 KB), pixel-major, so a step's
// 32 lanes read 32 consecutive 16-byte words without a bank conflict, and
// each warp stages its bucket's 256 checkpoints (4 KB) once per bucket.
// The warps take the tile's live buckets in turn; a bucket that starts at
// or past the tile's largest n_contrib (derived here from n_contrib) is
// skipped. A tile has 5.1 live buckets on average at the headline and at
// most 12, so most tiles take one round; a flat grid of warps over bucket
// slots would balance better but read every constant from L1 once per
// bucket instead of once per tile.
//
// Bound: the per-(pixel, pair) instruction stream: the exponent and live
// test on every swept (pair, pixel) below n_contrib, expf twice, log1pf
// and a reciprocal on every applied one, and the nine gradients. Design:
// no per-field warp reductions across pixels and one atomicAdd per (pair,
// field), where the per-pixel design it replaces ran 9 five-step shuffle
// sums and 9 atomics per (pair, warp) that touched the pair; the hand-off
// costs 4 shuffles a step. The live threshold of common.cuh skips expf on
// certainly dead (pair, pixel)s, as in K1.
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kWarps = kPix / 32;
constexpr int kSteps = kPix + kBucket - 1;  // the diagonal sweep
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix) blend_bwd_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload,
    const int* __restrict__ gid, long long m, int grid_w,
    const float* __restrict__ accum, const int* __restrict__ n_contrib,
    const float4* __restrict__ ckpt, const float* __restrict__ ct_accum,
    const float* __restrict__ ct_log_t_eff, float* __restrict__ grads) {
  __shared__ float4 s_ct[kPix];   // ct0, ct1, ct2, ct_eff
  __shared__ float4 s_acc[kPix];  // accum0, accum1, accum2, n_contrib (int bits)
  __shared__ float4 s_ck[kWarps][kPix];
  __shared__ int s_max_n;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  {
    const long long pix = (long long)tile * kPix + tid;
    const int nc = n_contrib[pix];
    s_ct[tid] = make_float4(ct_accum[3 * pix + 0], ct_accum[3 * pix + 1], ct_accum[3 * pix + 2],
                            ct_log_t_eff[pix]);
    s_acc[tid] = make_float4(accum[3 * pix + 0], accum[3 * pix + 1], accum[3 * pix + 2],
                             __int_as_float(nc));
    if (tid == 0) s_max_n = 0;
    __syncthreads();
    atomicMax(&s_max_n, nc);
    __syncthreads();
  }
  const int n_buckets = (s_max_n + kBucket - 1) / kBucket;
  const int tx = (tile % grid_w) * kTile;
  const int ty = (tile / grid_w) * kTile;
  const float4* ck_tile = ckpt + ((long long)tile + start / kBucket) * kPix;

  for (int b = warp; b < n_buckets; b += kWarps) {
#pragma unroll
    for (int i = lane; i < kPix; i += 32) s_ck[warp][i] = ck_tile[(long long)b * kPix + i];
    __syncwarp();
    const int jl = b * kBucket + lane;  // this lane's pair, local to the tile
    const long long j = (long long)start + jl;
    float mx = 0.0f, my = 0.0f, ca = 0.0f, cb = 0.0f, cc = 0.0f, op = 0.0f;
    float cr = 0.0f, cg = 0.0f, cbl = 0.0f, thr = 0.0f;
    if (j < end) {
      mx = payload[0 * m + j];
      my = payload[1 * m + j];
      ca = payload[2 * m + j];
      cb = payload[3 * m + j];
      cc = payload[4 * m + j];
      op = payload[5 * m + j];
      cr = payload[6 * m + j];
      cg = payload[7 * m + j];
      cbl = payload[8 * m + j];
      thr = live_threshold(op);
    }
    float g[kRows];
#pragma unroll
    for (int f = 0; f < kRows; ++f) g[f] = 0.0f;
    bool took = false;
    float log_t = 0.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int s = 0; s < kSteps; ++s) {
      // pixel s - lane's running state, from the lane that held it last step
      log_t = __shfl_up_sync(kFull, log_t, 1);
      c0 = __shfl_up_sync(kFull, c0, 1);
      c1 = __shfl_up_sync(kFull, c1, 1);
      c2 = __shfl_up_sync(kFull, c2, 1);
      if (lane == 0 && s < kPix) {
        const float4 k = s_ck[warp][s];
        log_t = k.x;
        c0 = k.y;
        c1 = k.z;
        c2 = k.w;
      }
      const int p = s - lane;
      if (p < 0 || p >= kPix) continue;
      const float4 pa = s_acc[p];
      if (jl >= __float_as_int(pa.w)) continue;  // past n_contrib (and past the tile's end)
      PairGeom q = pair_power(mx, my, ca, cb, cc, (float)(tx + (p % kTile)), (float)(ty + (p / kTile)));
      if (q.power < thr) continue;  // certainly dead
      pair_alpha(q, op);
      if (!is_live(q)) continue;
      took = true;
      const float4 pc = s_ct[p];
      const float l1m = log1pf(-q.alpha);
      const float t_excl = expf(log_t);
      const float w = q.alpha * t_excl;
      const float n0 = c0 + w * cr;
      const float n1 = c1 + w * cg;
      const float n2 = c2 + w * cbl;
      const float dot = cr * pc.x + cg * pc.y + cbl * pc.z;
      const float suffix = pc.x * (pa.x - n0) + pc.y * (pa.y - n1) + pc.z * (pa.z - n2);
      const float inv_1m = 1.0f / (1.0f - q.alpha);
      const float dl_dalpha = t_excl * dot - (suffix + pc.w) * inv_1m;
      const float dl_dg = op * dl_dalpha;
      const float gdx = q.g * q.dx;
      const float gdy = q.g * q.dy;
      g[0] += dl_dg * (-gdx * ca - gdy * cb);
      g[1] += dl_dg * (-gdy * cc - gdx * cb);
      g[2] += dl_dg * (-0.5f * q.g * q.dx * q.dx);
      g[3] += dl_dg * (-q.g * q.dx * q.dy);
      g[4] += dl_dg * (-0.5f * q.g * q.dy * q.dy);
      g[5] += q.g * dl_dalpha;
      g[6] += w * pc.x;
      g[7] += w * pc.y;
      g[8] += w * pc.z;
      c0 = n0;
      c1 = n1;
      c2 = n2;
      log_t = log_t + l1m;
    }
    if (took) {
      float* dst = grads + (long long)gid[j] * kRows;
#pragma unroll
      for (int f = 0; f < kRows; ++f) atomicAdd(dst + f, g[f]);
    }
    __syncwarp();  // every lane is done with s_ck[warp] before the next bucket fills it
  }
}

}  // namespace

// ckpt: K1's or K4's checkpoints [T + M / 32, 256] float4 for this binning.
extern "C" int gsdf_blend_bwd(const void* ranges, const void* payload, const void* gid,
                              long long m, int num_tiles, int grid_w, const void* accum,
                              const void* n_contrib, const void* ckpt, const void* ct_accum,
                              const void* ct_log_t_eff, void* grads, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_bwd_kernel<<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, (const int*)gid, m, grid_w,
      (const float*)accum, (const int*)n_contrib, (const float4*)ckpt, (const float*)ct_accum,
      (const float*)ct_log_t_eff, (float*)grads);
  return (int)cudaGetLastError();
}
