// K2 blend_bwd: backward alpha blend and the fold to per-Gaussian gradients.
//
// Replaces gsdf_slam_tpu/ops/pallas_blend_grouped.py::_bwd_kernel
// (launched by _run_bwd) and the XLA fold _fold_pair_grads. The TPU kernel
// walks each 8-tile group's chunks in reverse from the raw log T, rebuilds
// T in the log domain, carries the suffix sum of w * (c . ct) and writes
// per-pair gradients into a [16, MPA] buffer, which a sort-based fold then
// sums per Gaussian.
//
// Here: one block per tile, one thread per pixel, as the reference's
// backward (backward.cu:464-654) but per pixel. Each pixel walks back from
// its n_contrib (the last applied pair, from K1) over the tile's pairs,
// staged in shared memory in batches of 256; the block starts at the
// largest n_contrib of its pixels. It rebuilds log T_start = log T_end -
// log1p(-alpha), starting from K1's log_t_eff, and carries the suffix sum
// of w * (c . ct_pix) as _bwd_kernel does (:329-365). Conventions
// (backward.cu:598-640): dL/dalpha = T * (c . ct) - (suffix + ct_eff) /
// (1 - alpha); the 0.99 clamp is not gated, dL/dG = opacity * dL/dalpha.
// Each pair's nine gradients (mean x, y; conic a, b, c; opacity; rgb) are
// summed over the warp with shuffles and added to the per-Gaussian buffer
// [P, 9] with atomicAdd by lane 0; a warp where no pixel took the pair
// skips it. Atomics change the summation order from run to run; the JAX
// sorted fold is itself only good to about 3e-4 absolute at 1.2M pairs
// (pallas_blend_grouped.py:611-614), so this is the same numeric class.
//
// Bound: the serial per-pixel walk with its transcendentals (expf twice,
// log1pf) and the warp reductions plus 9 atomics per (pair, warp) that
// touched the pair, 8 warps per tile. Design: walks start at each block's
// frontier, so pairs no pixel applied cost nothing; warps with no
// contribution skip their shuffles and atomics.
#include "common.cuh"

namespace {

using namespace gsdf;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kPix) blend_bwd_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload,
    const int* __restrict__ gid, long long m, int grid_w,
    const float* __restrict__ log_t_eff, const int* __restrict__ n_contrib,
    const float* __restrict__ ct_accum, const float* __restrict__ ct_log_t_eff,
    float* __restrict__ grads) {
  __shared__ float s[kRows][kBatch];
  __shared__ int s_gid[kBatch];
  __shared__ int s_max_n;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int start = ranges[2 * tile];
  const long long pix = (long long)tile * kPix + tid;
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));

  const int nc = n_contrib[pix];
  if (tid == 0) s_max_n = 0;
  __syncthreads();
  atomicMax(&s_max_n, nc);
  __syncthreads();
  const int n = s_max_n;

  float log_t = log_t_eff[pix];
  const float ct0 = ct_accum[3 * pix + 0];
  const float ct1 = ct_accum[3 * pix + 1];
  const float ct2 = ct_accum[3 * pix + 2];
  const float ct_eff = ct_log_t_eff[pix];
  float suffix = 0.0f;

  for (int b_end = n; b_end > 0; b_end -= kBatch) {
    const int b0 = max(0, b_end - kBatch);
    __syncthreads();  // every thread is done with the previous batch
    if (tid < b_end - b0) {
      const long long j = (long long)start + b0 + tid;
#pragma unroll
      for (int f = 0; f < kRows; ++f) s[f][tid] = payload[f * m + j];
      s_gid[tid] = gid[j];
    }
    __syncthreads();
    for (int k = b_end - b0 - 1; k >= 0; --k) {
      float g[kRows];
#pragma unroll
      for (int f = 0; f < kRows; ++f) g[f] = 0.0f;
      bool took = false;
      if (b0 + k < nc) {
        const float a = s[2][k], b = s[3][k], c = s[4][k], op = s[5][k];
        const PairGeom q = pair_geom(s[0][k], s[1][k], a, b, c, op, px, py);
        if (is_live(q)) {
          took = true;
          const float l1m = log1pf(-q.alpha);
          const float log_start = log_t - l1m;
          const float t_excl = expf(log_start);
          const float w = q.alpha * t_excl;
          const float dot = s[6][k] * ct0 + s[7][k] * ct1 + s[8][k] * ct2;
          const float inv_1m = 1.0f / (1.0f - q.alpha);
          const float dl_dalpha = t_excl * dot - (suffix + ct_eff) * inv_1m;
          suffix = suffix + w * dot;
          log_t = log_start;
          const float dl_dg = op * dl_dalpha;
          const float gdx = q.g * q.dx;
          const float gdy = q.g * q.dy;
          g[0] = dl_dg * (-gdx * a - gdy * b);
          g[1] = dl_dg * (-gdy * c - gdx * b);
          g[2] = dl_dg * (-0.5f * q.g * q.dx * q.dx);
          g[3] = dl_dg * (-q.g * q.dx * q.dy);
          g[4] = dl_dg * (-0.5f * q.g * q.dy * q.dy);
          g[5] = q.g * dl_dalpha;
          g[6] = w * ct0;
          g[7] = w * ct1;
          g[8] = w * ct2;
        }
      }
      if (__any_sync(0xffffffffu, took)) {
        float* dst = grads + (long long)s_gid[k] * kRows;
#pragma unroll
        for (int f = 0; f < kRows; ++f) {
          const float v = warp_sum(g[f]);
          if (lane == 0) atomicAdd(dst + f, v);
        }
      }
    }
  }
}

}  // namespace

extern "C" int gsdf_blend_bwd(const void* ranges, const void* payload, const void* gid,
                              long long m, int num_tiles, int grid_w, const void* log_t_eff,
                              const void* n_contrib, const void* ct_accum,
                              const void* ct_log_t_eff, void* grads, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_bwd_kernel<<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, (const int*)gid, m, grid_w,
      (const float*)log_t_eff, (const int*)n_contrib, (const float*)ct_accum,
      (const float*)ct_log_t_eff, (float*)grads);
  return (int)cudaGetLastError();
}
