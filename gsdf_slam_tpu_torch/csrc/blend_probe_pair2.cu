// blend_probe_fwd_pair2: two tiles walked in lock step by one block.
//
// Replaces benchmarks/kernel_probe.py::run_fwd_pair2 (the pallas_call at
// :995, body _fwd_kernel_pair2 at :852) at group=1: tiles 2h and 2h+1 run
// in one block, each thread carrying one pixel of each as two independent
// chains. Each tile's accum, log_t_eff and log_t_raw are those of
// blend_probe_fwd's `chunk_exit` mode (blend_probe.cu), bit for bit: the
// tile walks its chunks while some pixel's raw log T is >= log(1e-4) at the
// chunk boundary. Both tiles get the pair's common loop count as n_done (the
// larger of the two walks); the partner of an odd last tile is empty.
//
// Bound: the per-pixel-pair instruction stream of chunk_exit's walk (the
// offsets, exponent and live test on every walked pixel-pair, expf, the
// clamp and log1p on the live ones, expf(log T) on the applied ones), of
// which the special functions bind; the card runs it bound by instruction
// issue, as K1 and K4 are (PERF.md). The TPU body's lock step costs
// instructions here, so the design removes what its layout added:
// - one barrier a chunk carries both tiles' exit votes: each warp ORs its
//   pixels' two vote bits (__reduce_or_sync), lane 0 parks them in a word
//   of shared memory, and after the barrier every thread ORs the 8 words;
//   the TPU body needs two __syncthreads_or and a staging barrier;
// - a tile whose walk is done does no pair work: its outputs cannot change,
//   so the block walks its partner alone (the TPU body re-reads the done
//   tile's last chunk and masks the result);
// - both tiles' chunks are staged pair-major, 12 words a pair with the live
//   threshold of common.cuh (three 16-byte broadcast loads a pair, expf and
//   the rest skipped on certainly dead pixel-pairs, exactly), the row
//   pointers are set once a chunk, and log1p is log1p_live (common.cuh),
//   bit-equal to log1pf on every live alpha;
// - the next chunk is copied by cp.async into the other of two buffers as
//   soon as the chunk's vote is in, and lands while this chunk is walked; a
//   tile that is done loads nothing. Against one synchronous load behind
//   the barrier it was timed in turns on the card (PERF.md).
// Registers and spills: chip_smoke.py phase 2 prints them (PERF.md).
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kMaxChunk = 128;
constexpr int kWarps = kPix / 32;
constexpr int kStaged = kStagedWords / 4;  // float4 words of a staged pair

struct Pix {
  float log_raw, log_eff, c0, c1, c2;
};

// One staged pair for one pixel: chunk_exit's step (pair_step<kChunkExit> of
// blend_probe.cu) with the same products and sums in the same order.
__device__ __forceinline__ void pair_step(const float4* row, float px, float py, Pix& p) {
  const float4 u = row[0];
  const float4 v = row[1];
  const float4 w3 = row[2];
  PairGeom q = pair_power(u.x, u.y, u.z, u.w, v.x, px, py);
  if (q.power < w3.y) return;  // certainly dead
  pair_alpha(q, v.y);
  if (!is_live(q)) return;  // alpha 0: log1p(-0) = 0 and a zero weight change nothing
  const float incl = p.log_raw + log1p_live(q.alpha);
  if (incl >= kLogTEps) {
    const float w = q.alpha * expf(p.log_raw);
    p.c0 = p.c0 + w * v.z;
    p.c1 = p.c1 + w * v.w;
    p.c2 = p.c2 + w * w3.x;
    p.log_eff = incl;
  }
  p.log_raw = incl;
}

__device__ __forceinline__ void write_pixel(const Pix& p, long long pix, float* __restrict__ accum,
                                            float* __restrict__ log_t_eff, float* __restrict__ log_t_raw) {
  accum[3 * pix + 0] = p.c0;
  accum[3 * pix + 1] = p.c1;
  accum[3 * pix + 2] = p.c2;
  log_t_eff[pix] = p.log_eff;
  log_t_raw[pix] = p.log_raw;
}

__global__ void __launch_bounds__(kPix) probe_fwd_pair2_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload, long long m, int num_tiles,
    int grid_w, int chunk, float* __restrict__ accum, float* __restrict__ log_t_eff,
    float* __restrict__ log_t_raw, int* __restrict__ n_done) {
  // s[buffer][tile of the pair][pair of the chunk]
  __shared__ float4 s[2][2][kMaxChunk][kStaged];
  // votes[buffer][warp]: bit 0, some pixel of tile 2h still has raw log T
  // >= log(1e-4); bit 1, the same for tile 2h + 1
  __shared__ unsigned votes[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ta = 2 * blockIdx.x;
  const int tb = ta + 1;
  const bool has_b = tb < num_tiles;  // the partner of an odd last tile is empty
  const int start_a = ranges[2 * ta], end_a = ranges[2 * ta + 1];
  const int start_b = has_b ? ranges[2 * tb] : 0, end_b = has_b ? ranges[2 * tb + 1] : 0;
  const int nc_a = (end_a - start_a + chunk - 1) / chunk;
  const int nc_b = (end_b - start_b + chunk - 1) / chunk;
  const int nc = max(nc_a, nc_b);
  const float px_a = (float)((ta % grid_w) * kTile + (tid % kTile));
  const float py_a = (float)((ta / grid_w) * kTile + (tid / kTile));
  const float px_b = (float)((tb % grid_w) * kTile + (tid % kTile));
  const float py_b = (float)((tb / grid_w) * kTile + (tid / kTile));
  // thread tid stages pair `slot` of its side's chunk (side 0: tile 2h)
  const int side = tid / kMaxChunk;
  const int slot = tid % kMaxChunk;
  const int own_start = side ? start_b : start_a;
  const int own_end = side ? end_b : end_a;
  Pix a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  Pix b = a;
  // as of the last vote: the tile may still walk
  bool live_a = true, live_b = true;
  // chunk cc of each tile still walking (as of the last vote) into buffer
  // cc & 1, by cp.async; one commit group per call
  auto issue = [&](int cc) {
    const int j = own_start + cc * chunk + slot;
    if ((side ? live_b : live_a) && slot < chunk && j < own_end) {
      float* dst = reinterpret_cast<float*>(s[cc & 1][side][slot]);
#pragma unroll
      for (int f = 0; f < kRows; ++f) cp_async4(dst + f, payload + f * m + j);
    }
    cp_async_commit();
  };
  issue(0);
  int c = 0;
  for (; c < nc; ++c) {
    const int buf = c & 1;
    cp_async_wait_all();
    {
      const int j = own_start + c * chunk + slot;
      if ((side ? live_b : live_a) && slot < chunk && j < own_end) {
        float* own = reinterpret_cast<float*>(s[buf][side][slot]);
        own[kRows] = live_threshold(own[5]);
      }
    }
    const unsigned bits = (a.log_raw >= kLogTEps ? 1u : 0u) | (b.log_raw >= kLogTEps ? 2u : 0u);
    const unsigned warp_bits = __reduce_or_sync(0xffffffffu, bits);
    if (lane == 0) votes[buf][warp] = warp_bits;
    // the one barrier of the chunk: it is staged and visible, the votes are
    // in, and every thread is past the previous chunk, whose buffers the
    // next chunk's copy fills (and whose vote words the chunk after it)
    __syncthreads();
    unsigned v = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v |= votes[buf][w];
    live_a = (v & 1u) && c < nc_a;
    live_b = (v & 2u) && c < nc_b;
    if (!live_a && !live_b) break;
    issue(c + 1);  // into the other buffer: every thread is past chunk c - 1
    const int nb_a = live_a ? min(chunk, end_a - (start_a + c * chunk)) : 0;
    const int nb_b = live_b ? min(chunk, end_b - (start_b + c * chunk)) : 0;
    // the chunk's rows, addressed once a chunk
    const float4* row_a = s[buf][0][0];
    const float4* row_b = s[buf][1][0];
    const int both = min(nb_a, nb_b);
    int k = 0;
    for (; k < both; ++k, row_a += kStaged, row_b += kStaged) {
      pair_step(row_a, px_a, py_a, a);
      pair_step(row_b, px_b, py_b, b);
    }
    for (; k < nb_a; ++k, row_a += kStaged) pair_step(row_a, px_a, py_a, a);
    for (; k < nb_b; ++k, row_b += kStaged) pair_step(row_b, px_b, py_b, b);
  }
  write_pixel(a, (long long)ta * kPix + tid, accum, log_t_eff, log_t_raw);
  if (tid == 0) n_done[ta] = c;
  if (has_b) {
    write_pixel(b, (long long)tb * kPix + tid, accum, log_t_eff, log_t_raw);
    if (tid == 0) n_done[tb] = c;
  }
}

}  // namespace

extern "C" int gsdf_blend_probe_fwd_pair2(const void* ranges, const void* payload, long long m,
                                          int num_tiles, int grid_w, int chunk, void* accum,
                                          void* log_t_eff, void* log_t_raw, void* n_done,
                                          void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return 0;
  probe_fwd_pair2_kernel<<<(num_tiles + 1) / 2, kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, num_tiles, grid_w, chunk, (float*)accum,
      (float*)log_t_eff, (float*)log_t_raw, (int*)n_done);
  return (int)cudaGetLastError();
}
