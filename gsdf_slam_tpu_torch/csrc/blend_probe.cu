// Blend probe kernels: stripped and restructured versions of the blend, to
// split its time into stages on the card.
//
// blend_probe_fwd replaces benchmarks/kernel_probe.py::run_fwd_variant (the
// pallas_call at :738) with each of its forward bodies; blend_probe_fwd_pair2
// replaces ::run_fwd_pair2 (:995, body _fwd_kernel_pair2); blend_probe_bwd
// replaces ::run_bwd_variant (:567, body _bwd_kernel_opt). Each computes what
// its TPU body computes at group=1, where a TPU group is one tile.
//
// Layout, as K1 (blend_fwd.cu): one 256-thread block per tile, one thread per
// pixel. The tile's depth-sorted pairs are walked in chunks of `chunk` (at
// most kMaxChunk) pairs, each staged in shared memory field-major, one pair
// loaded per thread so the loads coalesce. Each pixel carries its raw log T
// (every live pair) and applies a pair while its inclusive raw log T is still
// >= log(1e-4) (PARITY.md D9). Where the mode has an exit, the block tests it
// once per chunk, as the TPU's `cond` does: __syncthreads_or of
// log_raw >= log(1e-4) over the tile's 256 pixels, edge pixels outside the
// image included, so log_t_raw and n_done (the chunks walked) are the TPU's.
// Products and sums follow the plain versions' order (ops/blend_probe.py); the
// library is built with --fmad=false.
//
// Modes of blend_probe_fwd (TPU body, what it isolates on this card):
//   floor      _fwd_kernel_floor: staging, barriers and loop, no pair math;
//              log_t_eff = sum over chunks of 1e-30 * sum of mean x, accum
//              and log_t_raw 0, every chunk walked (the TPU writes its sum
//              into teff and zeros into traw, kernel_probe.py:620-621).
//   nocarry    _fwd_kernel_variant("nomxu"): alpha and both expf kept, the
//              carry replaced by incl = 0.5 l1m, carry = 0.25 l1m; accum
//              gets sum w col0 on all three channels. The serial carry's cost.
//   notrans    _fwd_kernel_variant("novpu"): production carry with
//              log1p(-a) -> -a and exp(log T) -> log T (the Gaussian's expf
//              stays). The special-function unit's share.
//   noexit     _fwd_kernel_noterm: production math over every chunk.
//   chunk_exit _fwd_kernel_opt / _fwd_kernel_roll: production math with the
//              chunk-granular exit. Against K1: per-chunk against per-pixel
//              exit.
//   unroll2    _fwd_kernel_unroll2 (nbuf=4): production math, two chunks per
//              iteration, exit tested every second chunk; a 4-deep cp.async
//              ring keeps two batches in flight. n_done = min(c_done,
//              n_chunks). Unlike the TPU body, it never reads a slot that no
//              copy filled: a second chunk past the tile's end is skipped.
//
// blend_probe_fwd_pair2: tiles 2h and 2h+1 in lock step, each thread carrying
// one pixel of each as two independent chains; the loop runs while either
// tile is live; a tile that is done re-reads its last chunk (its partner past
// the last tile is empty) and its updates are masked, as the TPU's selects.
// n_done of both is the common loop count.
//
// blend_probe_bwd: walks chunks [0, n_done) in reverse, pairs in reverse, from
// the raw log T (carried in float64, see the kernel); a pair is applied where
// its inclusive raw log T >= log(1e-4) and alpha > 0; the 0.99 clamp is not
// gated (K2's conventions). It writes
// per-pair gradients [9, M] (mean x, y; conic a, b, c; opacity; rgb), each
// summed over the tile's 256 pixels and not folded per Gaussian: the TPU's
// [16, MPA] buffer, rows 0-8. Each warp sums a pair's nine values with
// shuffles and parks them in shared memory; after each chunk one thread per
// (pair, field) adds the 8 warps' partials in a fixed order and writes once:
// no atomics, and the result is deterministic.
//
// Bound: as K1, the per-pair arithmetic and transcendentals of a serial walk
// (K1's per-pixel exit is replaced by the walk of whole chunks, so pixels past
// the frontier keep computing log1p for the raw log T); the staged chunk
// serves the tile's 256 pixels from one global read of each pair.
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kMaxChunk = 128;
constexpr int kRing = 4;  // unroll2: chunks in flight in shared memory
constexpr int kWarps = kPix / 32;
constexpr float kFloorScale = 1e-30f;

enum Mode : int { kFloor = 0, kNoCarry = 1, kNoTrans = 2, kNoExit = 3, kChunkExit = 4, kUnroll2 = 5 };

struct Pix {
  float log_raw, log_eff, c0, c1, c2;
};

using Chunk = float[kRows][kMaxChunk];

// cp_async4 and cp_async_commit: common.cuh
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void stage(Chunk& s, const float* __restrict__ payload, long long m,
                                      int b0, int nb, int tid) {
  if (tid < nb) {
#pragma unroll
    for (int f = 0; f < kRows; ++f) s[f][tid] = payload[f * m + b0 + tid];
  }
}

// One pair k of the staged chunk for one pixel, under the mode's math.
template <int kMode>
__device__ __forceinline__ void pair_step(const Chunk& s, int k, float px, float py, Pix& p) {
  const PairGeom q = pair_geom(s[0][k], s[1][k], s[2][k], s[3][k], s[4][k], s[5][k], px, py);
  if (!is_live(q)) return;  // alpha 0: log1p(-0) = 0 and a zero weight change nothing
  if constexpr (kMode == kNoCarry) {
    const float l1m = log1pf(-q.alpha);
    const float incl = l1m * 0.5f;
    const float carry = l1m * 0.25f;
    const float t_excl = expf(carry + (incl - l1m));
    const bool applied = (carry + incl) >= kLogTEps;
    const float w = applied ? q.alpha * t_excl : 0.0f;
    p.c0 = p.c0 + w * s[6][k];
    p.log_eff = p.log_eff + (applied ? l1m : 0.0f);
    p.log_raw = p.log_raw + l1m;
  } else {
    const float l1m = kMode == kNoTrans ? -q.alpha : log1pf(-q.alpha);
    const float incl = p.log_raw + l1m;
    if (incl >= kLogTEps) {
      const float t_excl = kMode == kNoTrans ? p.log_raw : expf(p.log_raw);
      const float w = q.alpha * t_excl;
      p.c0 = p.c0 + w * s[6][k];
      p.c1 = p.c1 + w * s[7][k];
      p.c2 = p.c2 + w * s[8][k];
      p.log_eff = incl;
    }
    p.log_raw = incl;
  }
}

template <int kMode>
__device__ __forceinline__ void apply_chunk(const Chunk& s, int nb, float px, float py, Pix& p) {
  if constexpr (kMode == kFloor) {
    float sum = 0.0f;
    for (int k = 0; k < nb; ++k) sum = sum + s[0][k];
    p.log_eff = p.log_eff + sum * kFloorScale;
  } else {
    for (int k = 0; k < nb; ++k) pair_step<kMode>(s, k, px, py, p);
  }
}

__device__ __forceinline__ void write_pixel(const Pix& p, bool one_channel, long long pix,
                                            float* __restrict__ accum, float* __restrict__ log_t_eff,
                                            float* __restrict__ log_t_raw) {
  accum[3 * pix + 0] = p.c0;
  accum[3 * pix + 1] = one_channel ? p.c0 : p.c1;
  accum[3 * pix + 2] = one_channel ? p.c0 : p.c2;
  log_t_eff[pix] = p.log_eff;
  log_t_raw[pix] = p.log_raw;
}

template <int kMode>
__global__ void __launch_bounds__(kPix) probe_fwd_kernel(const int* __restrict__ ranges,
                                                        const float* __restrict__ payload,
                                                        long long m, int grid_w, int chunk,
                                                        float* __restrict__ accum,
                                                        float* __restrict__ log_t_eff,
                                                        float* __restrict__ log_t_raw,
                                                        int* __restrict__ n_done) {
  constexpr bool kExits = kMode == kNoCarry || kMode == kNoTrans || kMode == kChunkExit;
  __shared__ Chunk s;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const int n_chunks = (end - start + chunk - 1) / chunk;
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));
  Pix p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c = 0;
  for (; c < n_chunks; ++c) {
    // the barrier also keeps the previous chunk until every thread is past it
    if constexpr (kExits) {
      if (!__syncthreads_or(p.log_raw >= kLogTEps)) break;
    } else {
      __syncthreads();
    }
    const int b0 = start + c * chunk;
    const int nb = min(chunk, end - b0);
    stage(s, payload, m, b0, nb, tid);
    __syncthreads();
    apply_chunk<kMode>(s, nb, px, py, p);
  }
  write_pixel(p, kMode == kNoCarry, (long long)tile * kPix + tid, accum, log_t_eff, log_t_raw);
  if (tid == 0) n_done[tile] = c;
}

__global__ void __launch_bounds__(kPix) probe_fwd_unroll2_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload, long long m, int grid_w,
    int chunk, float* __restrict__ accum, float* __restrict__ log_t_eff,
    float* __restrict__ log_t_raw, int* __restrict__ n_done) {
  __shared__ Chunk s[kRing];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const int n_chunks = (end - start + chunk - 1) / chunk;
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));
  // One commit group per chunk index, in order, empty past the tile's end:
  // when chunk c is consumed, groups 0 .. c + kRing - 1 are committed, so
  // waiting until at most kRing - 1 are pending completes chunk c's.
  auto issue = [&](int cc) {
    if (cc < n_chunks) {
      const int b0 = start + cc * chunk;
      if (tid < min(chunk, end - b0)) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) cp_async4(&s[cc % kRing][f][tid], payload + f * m + b0 + tid);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kRing; ++k) issue(k);
  Pix p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c0 = 0;
  while (c0 < n_chunks && __syncthreads_or(p.log_raw >= kLogTEps)) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int cc = c0 + h;
      if (cc < n_chunks) {
        cp_async_wait<kRing - 1>();
        __syncthreads();
        apply_chunk<kChunkExit>(s[cc % kRing], min(chunk, end - (start + cc * chunk)), px, py, p);
        __syncthreads();  // every thread is done with the slot before it is refilled
      }
      issue(cc + kRing);
    }
    c0 += 2;
  }
  cp_async_wait<0>();
  write_pixel(p, false, (long long)tile * kPix + tid, accum, log_t_eff, log_t_raw);
  if (tid == 0) n_done[tile] = min(c0, n_chunks);
}

__global__ void __launch_bounds__(kPix) probe_fwd_pair2_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload, long long m, int num_tiles,
    int grid_w, int chunk, float* __restrict__ accum, float* __restrict__ log_t_eff,
    float* __restrict__ log_t_raw, int* __restrict__ n_done) {
  __shared__ Chunk s[2];
  const int tid = threadIdx.x;
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
  Pix a = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  Pix b = a;
  int c = 0;
  for (; c < nc; ++c) {
    const bool live_a = __syncthreads_or(a.log_raw >= kLogTEps) && c < nc_a;
    const bool live_b = __syncthreads_or(b.log_raw >= kLogTEps) && c < nc_b;
    if (!live_a && !live_b) break;
    // a stream past its end re-reads its last chunk, as the TPU's clamp
    const int b0_a = start_a + min(c, max(nc_a - 1, 0)) * chunk;
    const int b0_b = start_b + min(c, max(nc_b - 1, 0)) * chunk;
    const int nb_a = max(0, min(chunk, end_a - b0_a));
    const int nb_b = max(0, min(chunk, end_b - b0_b));
    stage(s[0], payload, m, b0_a, nb_a, tid);
    stage(s[1], payload, m, b0_b, nb_b, tid);
    __syncthreads();
    Pix na = a, nb = b;
    for (int k = 0; k < max(nb_a, nb_b); ++k) {
      if (k < nb_a) pair_step<kChunkExit>(s[0], k, px_a, py_a, na);
      if (k < nb_b) pair_step<kChunkExit>(s[1], k, px_b, py_b, nb);
    }
    if (live_a) a = na;
    if (live_b) b = nb;
  }
  write_pixel(a, false, (long long)ta * kPix + tid, accum, log_t_eff, log_t_raw);
  if (tid == 0) n_done[ta] = c;
  if (has_b) {
    write_pixel(b, false, (long long)tb * kPix + tid, accum, log_t_eff, log_t_raw);
    if (tid == 0) n_done[tb] = c;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kPix) probe_bwd_kernel(
    const int* __restrict__ ranges, const float* __restrict__ payload, long long m, int grid_w,
    int chunk, const int* __restrict__ n_done, const float* __restrict__ log_t_raw,
    const float* __restrict__ ct_accum, const float* __restrict__ ct_log_t_eff,
    float* __restrict__ grads) {
  __shared__ Chunk s;
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
  // The walk starts from the raw log T, which an opaque tile takes to -300
  // and below: float32 subtraction pair by pair would carry ~1e-4 of rounding
  // into the applied pairs at the front (ulp(300) = 3e-5 a step), where the
  // TPU body rounds once per chunk (log_end - chunk total). The carry is
  // float64 and each pair's inclusive log T is rounded from it once.
  double log_t = log_t_raw[pix];
  const float ct0 = ct_accum[3 * pix + 0];
  const float ct1 = ct_accum[3 * pix + 1];
  const float ct2 = ct_accum[3 * pix + 2];
  const float ct_eff = ct_log_t_eff[pix];
  float suffix = 0.0f;

  for (int c = n_done[tile] - 1; c >= 0; --c) {
    const int b0 = start + c * chunk;
    const int nb = min(chunk, end - b0);
    __syncthreads();  // the previous chunk's pairs and partials are done with
    stage(s, payload, m, b0, nb, tid);
    __syncthreads();
    for (int k = nb - 1; k >= 0; --k) {
      float g[kRows];
#pragma unroll
      for (int f = 0; f < kRows; ++f) g[f] = 0.0f;
      bool took = false;
      const float a = s[2][k], b = s[3][k], cc = s[4][k], op = s[5][k];
      const PairGeom q = pair_geom(s[0][k], s[1][k], a, b, cc, op, px, py);
      if (is_live(q)) {
        const float l1m = log1pf(-q.alpha);
        const float incl = (float)log_t;  // raw log T after this pair
        log_t = log_t - (double)l1m;
        if (incl >= kLogTEps) {
          took = true;
          const float t_excl = expf(incl - l1m);
          const float w = q.alpha * t_excl;
          const float dot = s[6][k] * ct0 + s[7][k] * ct1 + s[8][k] * ct2;
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
      if (__any_sync(0xffffffffu, took)) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) {
          const float v = warp_sum(g[f]);
          if (lane == 0) part[k][f][warp] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int f = 0; f < kRows; ++f) part[k][f][warp] = 0.0f;
      }
    }
    __syncthreads();
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
}

}  // namespace

extern "C" int gsdf_blend_probe_fwd(const void* ranges, const void* payload, long long m,
                                    int num_tiles, int grid_w, int chunk, int mode, void* accum,
                                    void* log_t_eff, void* log_t_raw, void* n_done, void* stream) {
  if (chunk < 1 || chunk > kMaxChunk) return (int)cudaErrorInvalidValue;
  if (num_tiles <= 0) return 0;
  const auto r = (const int*)ranges;
  const auto pl = (const float*)payload;
  const auto cs = (cudaStream_t)stream;
  const auto a = (float*)accum;
  const auto e = (float*)log_t_eff;
  const auto w = (float*)log_t_raw;
  const auto nd = (int*)n_done;
  switch (mode) {
    case kFloor:
      probe_fwd_kernel<kFloor><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    case kNoCarry:
      probe_fwd_kernel<kNoCarry><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    case kNoTrans:
      probe_fwd_kernel<kNoTrans><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    case kNoExit:
      probe_fwd_kernel<kNoExit><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    case kChunkExit:
      probe_fwd_kernel<kChunkExit><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    case kUnroll2:
      probe_fwd_unroll2_kernel<<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

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

// grads: [9, M], zero-filled by the caller (pairs past a tile's n_done
// chunks are never written).
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
