// Blend probe kernel blend_probe_fwd: stripped and restructured versions of
// the forward blend, to split its time into stages on the card.
//
// blend_probe_fwd replaces benchmarks/kernel_probe.py::run_fwd_variant (the
// pallas_call at :738) with each of its forward bodies, computing what the
// TPU body computes at group=1, where a TPU group is one tile. The two other
// blend probes have sources of their own: blend_probe_pair2.cu
// (blend_probe_fwd_pair2) and blend_probe_bwd.cu (blend_probe_bwd).
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
// Bound: as K1, the per-pair arithmetic and transcendentals of a serial walk
// (K1's per-pixel exit is replaced by the walk of whole chunks, so pixels past
// the frontier keep computing log1p for the raw log T); the staged chunk
// serves the tile's 256 pixels from one global read of each pair.
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kMaxChunk = 128;
constexpr int kRing = 4;  // unroll2: chunks in flight in shared memory
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
