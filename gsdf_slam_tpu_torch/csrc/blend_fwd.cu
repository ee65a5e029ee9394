// K1 blend_fwd: forward alpha blend of every 16x16 tile, with the bucket
// checkpoints that K2 starts from. K4 (blend_fwd_export.cu) computes the
// same outputs, bit for bit, beside its keep flags.
//
// K1 replaces gsdf_slam_tpu/ops/pallas_blend_grouped.py::_fwd_kernel as
// launched by _run_fwd with keep_margin=None. The TPU kernel walks groups
// of 8 tiles in 128-pair chunks, turns the per-tile segmentation into
// one-hot MXU contractions, carries the raw log T and tests every pair in
// closed form; the group exits once every pixel is past the frontier.
//
// Here: one block per tile, one thread per pixel (forward.cu:317-477).
// Each pixel carries its log transmittance (the log-domain carry of the TPU
// kernel) and stops at the first live pair whose inclusive log T falls
// below log(1e-4): raw T never increases, so the applied set is exactly
// the TPU kernel's (PARITY.md D9). The block ends once every pixel has
// stopped. Pixels of edge tiles outside the image are computed like the
// others; assemble_image crops them.
//
// Outputs: accum [T,256,3], log_t_eff [T,256] (log T after the last
// applied pair), n_contrib [T,256] int32 (the index within the tile of the
// last applied live pair plus one), and the checkpoints [S,256] float4.
// The checkpoint of bucket b (local pairs 32b .. 32b + 31) is the pixel's
// (log T, c0, c1, c2) at local pair 32b, one 16-byte word in slot tile +
// start / 32 + b (forward.cu:405-415): the slot is injective because a
// tile's buckets end before the next tile's start, so S = T + M / 32 slots
// suffice, sized on the host from shapes alone. A pixel writes it when it
// applies its first pair at or past 32b, holding until then the state it
// had at 32b (nothing was applied in between), so it writes exactly the
// words K2 reads, those with 32b < n_contrib, and a pixel whose n_contrib
// ends before 32b stores nothing there. K2 derives each tile's largest
// n_contrib itself.
//
// Bound: the per-pixel-pair instruction stream (the exponent and live test
// on every walked pixel-pair; its expf and the opacity product on every
// live one; log1pf and expf of the carry on every applied one), of which
// the special functions are a third; the payload read is 36 bytes per pair
// per tile and the checkpoints 16 bytes per (pixel, bucket) below
// n_contrib. Design, against that stream:
// - the batch of 256 pairs is staged pair-major, 9 payload words padded to
//   12, so a pixel reads a pair with three 16-byte broadcast loads from
//   shared memory instead of nine 4-byte ones;
// - the next batch is filled with cp.async while the current one is
//   computed, into the other of two buffers, behind one barrier a batch
//   that also carries the block's exit vote;
// - at staging each pair gets its live threshold log(1/255 / op) less a
//   guard (common.cuh), and a pixel whose power is below it skips expf and
//   the rest of the pair; every other pixel computes exactly as before, so
//   the applied set and every output are unchanged, and a warp in which no
//   pixel passes skips the pair's special functions altogether;
// - the early exit skips the pairs behind every pixel's frontier.
#include "common.cuh"

namespace {

using namespace gsdf;

__global__ void __launch_bounds__(kPix) blend_fwd_kernel(const int* __restrict__ ranges,
                                                        const float* __restrict__ payload,
                                                        long long m, int grid_w,
                                                        float* __restrict__ accum,
                                                        float* __restrict__ log_t_eff,
                                                        int* __restrict__ n_contrib,
                                                        float4* __restrict__ ckpt) {
  __shared__ float4 s[2][kBatch][kStagedWords / 4];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));
  // this pixel's word of the tile's first bucket; bucket b is kPix words on
  float4* ck = ckpt + ((long long)tile + start / kBucket) * kPix + tid;
  // the start of the first bucket whose checkpoint this pixel has not
  // written, as a local pair index
  int ck_next = 0;
  // before applying local pair jl: the state now is the state at the start
  // of every bucket from ck_next's through jl's; one compare on the hot path
  auto checkpoint = [&](int jl, float lt, float a0, float a1, float a2) {
    if (jl >= ck_next) {
      float4* dst = ck + (long long)(ck_next / kBucket) * kPix;
      const float4 val = make_float4(lt, a0, a1, a2);
      do {
        *dst = val;
        dst += kPix;
        ck_next += kBucket;
      } while (ck_next <= jl);
    }
  };

  // each thread copies its own pair of the batch at b0
  auto stage = [&](int buf, int b0) {
    const int j = b0 + tid;
    if (j < end) {
      float* dst = reinterpret_cast<float*>(&s[buf][tid][0]);
#pragma unroll
      for (int f = 0; f < kRows; ++f) cp_async4(dst + f, payload + f * m + j);
    }
    cp_async_commit();
  };

  float log_t = 0.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int last = 0;
  bool done = false;
  if (start < end) stage(0, start);
  int buf = 0;
  for (int b0 = start; b0 < end; b0 += kBatch, buf ^= 1) {
    cp_async_wait_all();
    if (b0 + tid < end) {
      float* own = reinterpret_cast<float*>(&s[buf][tid][0]);
      own[kRows] = live_threshold(own[5]);
    }
    // the one barrier of the batch: it is staged and visible, and every
    // thread is past the previous batch, whose buffer the next copy fills
    if (__syncthreads_count(done) == kPix) break;
    if (b0 + kBatch < end) stage(buf ^ 1, b0 + kBatch);
    const int nb = min(kBatch, end - b0);
    for (int k = 0; k < nb && !done; ++k) {
      const float4 u = s[buf][k][0];
      const float4 v = s[buf][k][1];
      const float4 w3 = s[buf][k][2];
      PairGeom q = pair_power(u.x, u.y, u.z, u.w, v.x, px, py);
      if (q.power < w3.y) continue;  // certainly dead
      pair_alpha(q, v.y);
      if (!is_live(q)) continue;
      const float l1m = log1pf(-q.alpha);
      const float incl = log_t + l1m;
      if (incl < kLogTEps) {
        done = true;
        break;
      }
      checkpoint(b0 - start + k, log_t, c0, c1, c2);
      const float w = q.alpha * expf(log_t);
      c0 = c0 + w * v.z;
      c1 = c1 + w * v.w;
      c2 = c2 + w * w3.x;
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

// ckpt: [T + M / 32, 256] float4, written only where 32b < n_contrib.
extern "C" int gsdf_blend_fwd(const void* ranges, const void* payload, long long m,
                              int num_tiles, int grid_w, void* accum, void* log_t_eff,
                              void* n_contrib, void* ckpt, void* stream) {
  if (num_tiles <= 0) return 0;
  blend_fwd_kernel<<<num_tiles, gsdf::kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, grid_w, (float*)accum, (float*)log_t_eff,
      (int*)n_contrib, (float4*)ckpt);
  return (int)cudaGetLastError();
}
