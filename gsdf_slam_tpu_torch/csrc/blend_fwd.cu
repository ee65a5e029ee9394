// K1 blend_fwd: forward alpha blend of every 16x16 tile.
//
// Replaces gsdf_slam_tpu/ops/pallas_blend_grouped.py::_fwd_kernel as
// launched by _run_fwd with keep_margin=None. The TPU kernel walks groups
// of 8 tiles in 128-pair chunks, turns the per-tile segmentation into
// one-hot MXU contractions, carries the raw log T and tests every pair in
// closed form; the group exits once every pixel is past the frontier.
//
// Here: one block per tile, one thread per pixel (forward.cu:317-477).
// The tile's depth-sorted pairs pass through shared memory in batches of
// 256, one pair loaded per thread, field-major so the loads coalesce. Each
// pixel carries its log transmittance (the log-domain carry of the TPU
// kernel) and stops at the first live pair whose inclusive log T falls
// below log(1e-4): raw T never increases, so the applied set is exactly
// the TPU kernel's (PARITY.md D9). __syncthreads_count ends the block once
// every pixel has stopped. Pixels of edge tiles outside the image are
// computed like the others; assemble_image crops them.
//
// Outputs: accum [T,256,3], log_t_eff [T,256] (log T after the last
// applied pair) and n_contrib [T,256] int32, the index within the tile of
// the last applied live pair plus one. K2 starts its walk back there.
//
// Bound: the per-pair arithmetic (two transcendentals per live pixel-pair:
// expf for the Gaussian and log1pf for the carry, plus expf of the carry
// for the weight) and the serial walk of each tile's pairs; the payload
// read is 36 bytes per pair per tile. Design: the early exit skips the
// pairs behind every pixel's frontier; the shared-memory batch makes one
// global read of a pair serve the tile's 256 pixels.
#include "common.cuh"

namespace {

using namespace gsdf;

__global__ void __launch_bounds__(kPix) blend_fwd_kernel(const int* __restrict__ ranges,
                                                        const float* __restrict__ payload,
                                                        long long m, int grid_w,
                                                        float* __restrict__ accum,
                                                        float* __restrict__ log_t_eff,
                                                        int* __restrict__ n_contrib) {
  __shared__ float s[kRows][kBatch];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));

  float log_t = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int last = 0;
  bool done = false;
  for (int b0 = start; b0 < end; b0 += kBatch) {
    // barrier: every thread is past the previous batch before it is replaced
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + tid;
    if (j < end) {
#pragma unroll
      for (int f = 0; f < kRows; ++f) s[f][tid] = payload[f * m + j];
    }
    __syncthreads();
    const int nb = min(kBatch, end - b0);
    for (int k = 0; k < nb && !done; ++k) {
      const PairGeom q = pair_geom(s[0][k], s[1][k], s[2][k], s[3][k], s[4][k], s[5][k], px, py);
      if (!is_live(q)) continue;
      const float l1m = log1pf(-q.alpha);
      const float incl = log_t + l1m;
      if (incl < kLogTEps) {
        done = true;
        break;
      }
      const float w = q.alpha * expf(log_t);
      c0 = c0 + w * s[6][k];
      c1 = c1 + w * s[7][k];
      c2 = c2 + w * s[8][k];
      log_t = incl;
      last = b0 - start + k + 1;
    }
  }
  const long long pix = (long long)tile * kPix + tid;
  accum[3 * pix + 0] = c0;
  accum[3 * pix + 1] = c1;
  accum[3 * pix + 2] = c2;
  log_t_eff[pix] = log_t;
  n_contrib[pix] = last;
}

}  // namespace

extern "C" int gsdf_blend_fwd(const void* ranges, const void* payload, long long m,
                              int num_tiles, int grid_w, void* accum, void* log_t_eff,
                              void* n_contrib, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_fwd_kernel<<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, grid_w, (float*)accum,
      (float*)log_t_eff, (int*)n_contrib);
  return (int)cudaGetLastError();
}
