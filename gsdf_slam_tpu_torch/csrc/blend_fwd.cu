// K1 blend_fwd: forward alpha blend of every 16x16 tile.
// K4 blend_fwd_export: K1 plus a per-pair liveness flag for the pruned
// binning cache.
//
// K1 replaces gsdf_slam_tpu/ops/pallas_blend_grouped.py::_fwd_kernel as
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
// K4 replaces the same _fwd_kernel launched with keep_margin (the export
// variant, pallas_blend_grouped.py:100-109, 173-184). It also writes
// keep[j] = 1 for every pair j that some pixel sees live (alpha > 0) while
// that pixel's EXCLUSIVE raw log T is still >= log_exit = log(1e-4) -
// log(margin). It carries two logs per pixel: the raw log T, which
// advances on every live pair, and K1's applied log T, which advances, with
// the colour and n_contrib, only on pairs whose inclusive raw log T is
// still >= log(1e-4). While a pixel applies, the two are the same value,
// so accum, log_t_eff and n_contrib are bit-equal to K1's (the same
// products in the same order). The pixel keeps walking past the T = 1e-4
// frontier until its raw log T drops below log_exit: that is the TPU
// kernel's relaxed exit, which lets the margin band be observed. Raw T
// never increases, so no later pair of that pixel can pass the keep test,
// and a per-pixel exit gives exactly the TPU kernel's keep set (the
// argument of PARITY.md D9). Every writer of keep[j] stores the same 1, so
// a plain store is enough; the wrapper zero-fills keep, so a pair that no
// pixel reached stays 0, like the aliased zero row of _run_fwd.
//
// Bound: the per-pair arithmetic (two transcendentals per live pixel-pair:
// expf for the Gaussian and log1pf for the carry, plus expf of the carry
// for the weight) and the serial walk of each tile's pairs; the payload
// read is 36 bytes per pair per tile. Design: the early exit skips the
// pairs behind every pixel's frontier; the shared-memory batch makes one
// global read of a pair serve the tile's 256 pixels. K4 walks further, to
// the margin band, which costs it the pairs between the two frontiers.
#include "common.cuh"

namespace {

using namespace gsdf;

template <bool kExport>
__global__ void __launch_bounds__(kPix) blend_fwd_kernel(const int* __restrict__ ranges,
                                                        const float* __restrict__ payload,
                                                        long long m, int grid_w,
                                                        float log_exit,
                                                        float* __restrict__ accum,
                                                        float* __restrict__ log_t_eff,
                                                        int* __restrict__ n_contrib,
                                                        unsigned char* __restrict__ keep) {
  __shared__ float s[kRows][kBatch];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));

  float log_t = 0.0f;
  float log_raw = 0.0f;  // K4: raw log T over every live pair
  bool applying = true;  // K4: log_raw is still >= log(1e-4), log_t == log_raw
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
      if constexpr (kExport) {
        if (log_raw >= log_exit) keep[b0 + k] = 1;
        const float incl = log_raw + l1m;
        if (applying) {
          if (incl < kLogTEps) {
            applying = false;
          } else {
            const float w = q.alpha * expf(log_t);
            c0 = c0 + w * s[6][k];
            c1 = c1 + w * s[7][k];
            c2 = c2 + w * s[8][k];
            log_t = incl;
            last = b0 - start + k + 1;
          }
        }
        log_raw = incl;
        if (log_raw < log_exit) {
          done = true;
          break;
        }
      } else {
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
  blend_fwd_kernel<false><<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, grid_w, gsdf::kLogTEps, (float*)accum,
      (float*)log_t_eff, (int*)n_contrib, nullptr);
  return (int)cudaGetLastError();
}

// keep: [M] bytes, zero-filled by the caller.
extern "C" int gsdf_blend_fwd_export(const void* ranges, const void* payload, long long m,
                                     int num_tiles, int grid_w, float log_exit, void* accum,
                                     void* log_t_eff, void* n_contrib, void* keep,
                                     void* stream) {
  if (num_tiles <= 0) return 0;
  blend_fwd_kernel<true><<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, grid_w, log_exit, (float*)accum,
      (float*)log_t_eff, (int*)n_contrib, (unsigned char*)keep);
  return (int)cudaGetLastError();
}
