// blend_probe_bwd: the backward blend from the raw log T, per-pair gradients
// without the fold.
//
// Replaces benchmarks/kernel_probe.py::run_bwd_variant (the pallas_call at
// :567) with its body _bwd_kernel_opt (:417), at group=1. Each tile walks
// its pairs [start, start + min(n_done * chunk, count)) in reverse, chunk by
// chunk, from the raw log T, and every pixel walks all of them. A pair
// applies where its inclusive raw log T >= log(1e-4) and alpha > 0; the 0.99
// clamp is not gated (K2's conventions, blend_bwd.cu). The output is the
// TPU's [16, MPA] buffer, rows 0-8: per-pair gradients [9, M] (mean x, y;
// conic a, b, c; opacity; rgb), each summed over the tile's 256 pixels and
// not folded per Gaussian, zero past the walk (the wrapper zero-fills).
//
// Bound: the per-pixel-pair instruction stream: the offsets, exponent and
// live test on every walked pixel-pair; expf, the clamp and log1p on the
// live ones; expf(log T), a reciprocal and the nine gradients on the applied
// ones. The special functions and the float32 work bind, not the 72 bytes a
// pair; the card runs it bound by instruction issue. One thread per pixel
// (a warp holds a 2x16 strip of the tile, so a pair that misses the strip
// is skipped by the whole warp at once), one 8-warp block per tile. The
// design cuts the instructions of a pair-step:
// - the nine gradients of a pair-step that some lane of the warp took are
//   summed over the warp by one recursive-halving exchange: at offsets 16,
//   8, 4 and 2 each lane keeps half of its fields and adds the other lane's
//   half of them (5, 3, 2 and 1 shuffles), then offset 1 adds the lane pair
//   (1): 12 shuffles and adds, where nine butterfly sums took 45 and nine
//   serial stores; the nine sums end on distinct lanes, which store them at
//   once;
// - the live threshold of common.cuh, staged with the pair, skips expf and
//   the rest of a certainly dead pixel-pair, exactly (a dead pair adds
//   log1p(-0) = 0 to the raw log T), and log1p is log1p_live (common.cuh);
// - the chunk is staged pair-major, 12 words a pair (three 16-byte
//   broadcast loads), its row pointer set once a chunk, and the next chunk
//   is copied by cp.async into the other of two buffers while this one is
//   walked: two barriers a chunk, where a synchronous stage took three.
// After each chunk one thread per (pair, field) adds the 8 warps' partials
// in a fixed order and writes once, field-major: no atomics, and the
// result is deterministic.
//
// A pixel ring (lane l applying pair 32g + l to the pixels of its warp in
// turn, each lane summing its pair's gradients in registers) was timed in
// turns against this design and ran slower even than nine butterflies: its
// 32 lanes hold 32 pairs, so nearly every step some lane takes the applied
// path and the warp skips no pair (PERF.md).
//
// The walk starts from the raw log T, which an opaque tile takes to -300
// and below: float32 subtraction pair by pair would carry ~1e-4 of rounding
// into the applied pairs at the front (ulp(300) = 3e-5 a step), where the
// TPU body rounds once per chunk (log_end - chunk total). The carry is
// float64 and each pair's inclusive log T is rounded from it once.
// Registers and spills: chip_smoke.py phase 2 prints them (PERF.md).
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kMaxChunk = 128;
constexpr int kWarps = kPix / 32;
constexpr int kStaged = kStagedWords / 4;  // float4 words of a staged pair
constexpr unsigned kFull = 0xffffffffu;

// One halving step: this lane keeps `keep_hi` if `hi` else `keep_lo`, sends
// the other to the lane `off` away and adds what that lane sends.
__device__ __forceinline__ float halve(bool hi, float keep_lo, float keep_hi, int off) {
  return (hi ? keep_hi : keep_lo) + __shfl_xor_sync(kFull, hi ? keep_lo : keep_hi, off);
}

// The field whose warp sum warp_fields leaves on `lane` (on both lanes of
// the pair 2f, 2f + 1), -1 for none. Bit 4 of the lane splits the fields
// 0-4 | 5-8, bit 3 the first three | the rest, bit 2 the first two | the
// rest, bit 1 the first | the second.
__device__ __forceinline__ int field_of_lane(int lane) {
  // nibble i, most significant first: the field of lane bits 4..1 = i
  constexpr unsigned long long kTable = 0x012f34ff567f8fffull;
  const int nib = (int)((kTable >> (4 * (15 - (lane >> 1)))) & 0xf);
  return nib == 0xf ? -1 : nib;
}

__device__ __forceinline__ float warp_fields(const float (&g)[kRows], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
  float v[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = halve(b4, g[k], k < 4 ? g[5 + k] : 0.0f, 16);
  float w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) w[k] = halve(b3, v[k], k < 2 ? v[3 + k] : 0.0f, 8);
  float x[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) x[k] = halve(b2, w[k], k < 1 ? w[2 + k] : 0.0f, 4);
  const float y = halve(b1, x[0], x[1], 2);
  return y + __shfl_xor_sync(kFull, y, 1);
}

__global__ void __launch_bounds__(kPix) probe_bwd_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload, long long m, int grid_w,
    int chunk, const int* __restrict__ n_done, const float* __restrict__ log_t_raw,
    const float* __restrict__ ct_accum, const float* __restrict__ ct_log_t_eff,
    float* __restrict__ grads) {
  __shared__ float4 s[2][kMaxChunk][kStaged];
  __shared__ float part[kMaxChunk][kRows][kWarps];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const long long pix = (long long)tile * kPix + tid;
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));
  double log_t = log_t_raw[pix];
  const float ct0 = ct_accum[3 * pix + 0];
  const float ct1 = ct_accum[3 * pix + 1];
  const float ct2 = ct_accum[3 * pix + 2];
  const float ct_eff = ct_log_t_eff[pix];
  float suffix = 0.0f;
  // the field this lane stores after the exchange, on even lanes
  const int field = (lane & 1) ? -1 : field_of_lane(lane);

  const int c_top = n_done[tile] - 1;
  // chunk c into buffer `buf`: thread tid copies pair tid of it
  auto issue = [&](int c, int buf) {
    if (c >= 0) {
      const int b0 = start + c * chunk;
      if (tid < min(chunk, end - b0)) {
        float* dst = reinterpret_cast<float*>(s[buf][tid]);
#pragma unroll
        for (int f = 0; f < kRows; ++f) cp_async4(dst + f, payload + f * m + b0 + tid);
      }
    }
    cp_async_commit();
  };
  issue(c_top, 0);
  int buf = 0;
  for (int c = c_top; c >= 0; --c, buf ^= 1) {
    const int b0 = start + c * chunk;
    const int nb = min(chunk, end - b0);
    cp_async_wait_all();
    if (tid < nb) {
      float* own = reinterpret_cast<float*>(s[buf][tid]);
      own[kRows] = live_threshold(own[5]);
    }
    // the chunk is staged and visible; every thread is past the previous
    // chunk's walk (whose buffer the next copy fills) and its partials' sums
    __syncthreads();
    issue(c - 1, buf ^ 1);
    // the chunk's rows, addressed once a chunk, walked back
    const float4* row = s[buf][0] + (nb - 1) * kStaged;
    for (int k = nb - 1; k >= 0; --k, row -= kStaged) {
      float g[kRows];
#pragma unroll
      for (int f = 0; f < kRows; ++f) g[f] = 0.0f;
      bool took = false;
      const float4 u = row[0];
      const float4 v = row[1];
      const float4 w3 = row[2];
      const float a = u.z, b = u.w, cc = v.x, op = v.y;
      PairGeom q = pair_power(u.x, u.y, a, b, cc, px, py);
      if (q.power >= w3.y) {  // else certainly dead
        pair_alpha(q, op);
        if (is_live(q)) {
          const float l1m = log1p_live(q.alpha);
          const float incl = (float)log_t;  // raw log T after this pair
          log_t = log_t - (double)l1m;
          if (incl >= kLogTEps) {
            took = true;
            const float t_excl = expf(incl - l1m);
            const float w = q.alpha * t_excl;
            const float dot = v.z * ct0 + v.w * ct1 + w3.x * ct2;
            const float inv_1m = 1.0f / (1.0f - q.alpha);
            const float dl_dalpha = t_excl * dot - (suffix + ct_eff) * inv_1m;
            suffix = suffix + w * dot;
            const float dl_dg = op * dl_dalpha;
            const float gdx = q.g * q.dx;
            const float gdy = q.g * q.dy;
            g[0] = dl_dg * (-gdx * a - gdy * b);
            g[1] = dl_dg * (-gdy * cc - gdx * b);
            g[2] = dl_dg * (-0.5f * q.g * q.dx * q.dx);
            g[3] = dl_dg * (-q.g * q.dx * q.dy);
            g[4] = dl_dg * (-0.5f * q.g * q.dy * q.dy);
            g[5] = q.g * dl_dalpha;
            g[6] = w * ct0;
            g[7] = w * ct1;
            g[8] = w * ct2;
          }
        }
      }
      if (__any_sync(kFull, took)) {
        const float sum = warp_fields(g, lane);
        if (field >= 0) part[k][field][warp] = sum;
      } else if (field >= 0) {
        part[k][field][warp] = 0.0f;
      }
    }
    __syncthreads();  // the chunk's partials are in
    // field-major writes: consecutive threads take consecutive pairs of a field
    for (int i = tid; i < nb * kRows; i += kPix) {
      const int f = i / nb;
      const int k = i - f * nb;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v = v + part[k][f][w];
      grads[f * m + b0 + k] = v;
    }
  }
  cp_async_wait_all();
}

}  // namespace

// grads: [9, M], zero-filled by the caller (pairs past a tile's walk are
// never written).
extern "C" int gsdf_blend_probe_bwd(const void* ranges, const void* payload, long long m,
                                    int num_tiles, int grid_w, int chunk, const void* n_done,
                                    const void* log_t_raw, const void* ct_accum,
                                    const void* ct_log_t_eff, void* grads, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return 0;
  probe_bwd_kernel<<<num_tiles, kPix, 0, (cudaStream_t)stream>>>(
      (const int*)ranges, (const float*)payload, m, grid_w, chunk, (const int*)n_done,
      (const float*)log_t_raw, (const float*)ct_accum, (const float*)ct_log_t_eff,
      (float*)grads);
  return (int)cudaGetLastError();
}
