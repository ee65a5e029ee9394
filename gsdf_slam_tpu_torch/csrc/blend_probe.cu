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
// most kMaxChunk) pairs. Each pixel carries its raw log T (every live pair)
// and applies a pair while its inclusive raw log T is still >= log(1e-4)
// (PARITY.md D9). Where the mode has an exit, the block tests it at a chunk
// boundary, as the TPU's `cond` does: the OR of log_raw >= log(1e-4) over the
// tile's 256 pixels, edge pixels outside the image included, so log_t_raw and
// n_done (the chunks walked) are the TPU's. Products and sums follow the
// plain versions' order (ops/blend_probe.py); the library is built with
// --fmad=false.
//
// All six modes run one skeleton, the one K1, K4 and blend_probe_fwd_pair2
// run, and differ only in the per-pair math (unroll2 also in its ring depth
// and exit cadence), so each mode's time against chunk_exit's isolates what
// the mode strips from the kernels the port ships:
// - the chunk is staged pair-major, 12 words a pair (kStagedWords): thread
//   t copies pair t by cp.async and, once its copy is in, writes the pair's
//   live threshold (common.cuh) into word 9; a pixel reads a pair with three
//   16-byte broadcast loads from a row pointer set once a chunk, and a
//   pixel-pair whose power is below the threshold skips expf and the rest
//   (exact: such a pair is dead);
// - one barrier a chunk: it makes the staged chunk and its thresholds
//   visible, frees the slot the next copy fills and, in the exit modes,
//   carries the vote: each warp ORs its pixels' bits (__reduce_or_sync),
//   lane 0 parks the result in a word of shared memory, double buffered so
//   a fast warp's next vote cannot overwrite a word a slow warp still reads,
//   and after the barrier every thread ORs the 8 words;
// - chunk c + kRing - 1 is copied into the slot of chunk c - 1 as soon as
//   chunk c's vote is in, and lands while chunk c is walked; kRing is 2 (a
//   double buffer), 4 for unroll2;
// - log1p is log1p_live (common.cuh), bit-equal to log1pf on every live
//   alpha, so every output is the former field-major kernel's bit for bit.
//
// Modes of blend_probe_fwd (TPU body, what it isolates on this card):
//   floor      _fwd_kernel_floor: staging, thresholds, barrier and loop, no
//              pair math; log_t_eff = sum over chunks of 1e-30 * sum of mean
//              x (word 0 of each staged row), accum and log_t_raw 0, every
//              chunk walked (the TPU writes its sum into teff and zeros into
//              traw, kernel_probe.py:620-621).
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
//   unroll2    _fwd_kernel_unroll2 (nbuf=4): production math, exit tested
//              every second chunk, a 4-slot ring with three chunks in
//              flight. n_done = min(c_done, n_chunks). Unlike the TPU body,
//              it never reads a slot that no copy filled: the walk stops at
//              the tile's last chunk.
//
// Bound: as K1, the per-pair arithmetic and transcendentals of a serial walk
// (K1's per-pixel exit is replaced by the walk of whole chunks, so pixels past
// the frontier keep computing log1p for the raw log T); the staged chunk
// serves the tile's 256 pixels from one global read of each pair.
#include "common.cuh"

namespace {

using namespace gsdf;

constexpr int kMaxChunk = 128;
constexpr int kWarps = kPix / 32;
constexpr int kStaged = kStagedWords / 4;  // float4 words of a staged pair
constexpr float kFloorScale = 1e-30f;

enum Mode : int { kFloor = 0, kNoCarry = 1, kNoTrans = 2, kNoExit = 3, kChunkExit = 4, kUnroll2 = 5 };

struct Pix {
  float log_raw, log_eff, c0, c1, c2;
};

// cp.async.wait_group: at most kPending of this thread's commit groups pending
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One staged pair (mx my a b | c op r g | b thr - -) for one pixel, under
// the mode's math.
template <int kMode>
__device__ __forceinline__ void pair_step(const float4* row, float px, float py, Pix& p) {
  const float4 u = row[0];
  const float4 v = row[1];
  const float4 w3 = row[2];
  PairGeom q = pair_power(u.x, u.y, u.z, u.w, v.x, px, py);
  if (q.power < w3.y) return;  // certainly dead
  pair_alpha(q, v.y);
  if (!is_live(q)) return;  // alpha 0: log1p(-0) = 0 and a zero weight change nothing
  if constexpr (kMode == kNoCarry) {
    const float l1m = log1p_live(q.alpha);
    const float incl = l1m * 0.5f;
    const float carry = l1m * 0.25f;
    const float t_excl = expf(carry + (incl - l1m));
    const bool applied = (carry + incl) >= kLogTEps;
    const float w = applied ? q.alpha * t_excl : 0.0f;
    p.c0 = p.c0 + w * v.z;
    p.log_eff = p.log_eff + (applied ? l1m : 0.0f);
    p.log_raw = p.log_raw + l1m;
  } else {
    const float l1m = kMode == kNoTrans ? -q.alpha : log1p_live(q.alpha);
    const float incl = p.log_raw + l1m;
    if (incl >= kLogTEps) {
      const float t_excl = kMode == kNoTrans ? p.log_raw : expf(p.log_raw);
      const float w = q.alpha * t_excl;
      p.c0 = p.c0 + w * v.z;
      p.c1 = p.c1 + w * v.w;
      p.c2 = p.c2 + w * w3.x;
      p.log_eff = incl;
    }
    p.log_raw = incl;
  }
}

template <int kMode>
__global__ void __launch_bounds__(kPix) probe_fwd_kernel(const int* __restrict__ ranges,
                                                        const float* __restrict__ payload,
                                                        long long m, int grid_w, int chunk,
                                                        float* __restrict__ accum,
                                                        float* __restrict__ log_t_eff,
                                                        float* __restrict__ log_t_raw,
                                                        int* __restrict__ n_done) {
  constexpr bool kExits = kMode != kFloor && kMode != kNoExit;
  constexpr int kRing = kMode == kUnroll2 ? 4 : 2;   // slots of staged chunks
  constexpr int kEvery = kMode == kUnroll2 ? 2 : 1;  // chunks per exit test
  // s[slot][pair of the chunk]
  __shared__ float4 s[kRing][kMaxChunk][kStaged];
  // votes[test & 1][warp]: some pixel of the warp still has raw log T >= log(1e-4)
  __shared__ unsigned votes[2][kWarps];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const int n_chunks = (end - start + chunk - 1) / chunk;
  const float px = (float)((tile % grid_w) * kTile + (tid % kTile));
  const float py = (float)((tile / grid_w) * kTile + (tid / kTile));
  // chunk cc into slot cc % kRing by cp.async, thread tid copying pair tid;
  // one commit group per call, empty past the tile's end
  auto issue = [&](int cc) {
    const int j = start + cc * chunk + tid;
    if (tid < chunk && j < end) {
      float* dst = reinterpret_cast<float*>(s[cc % kRing][tid]);
#pragma unroll
      for (int f = 0; f < kRows; ++f) cp_async4(dst + f, payload + f * m + j);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kRing - 1; ++k) issue(k);
  Pix p = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int c = 0;
  for (; c < n_chunks; ++c) {
    const int slot = c % kRing;
    // groups 0 .. c + kRing - 2 are committed: at most kRing - 2 pending
    // leaves this thread's copy of chunk c complete
    cp_async_wait<kRing - 2>();
    if (tid < chunk && start + c * chunk + tid < end) {
      float* own = reinterpret_cast<float*>(s[slot][tid]);
      own[kRows] = live_threshold(own[5]);
    }
    const bool test = kExits && c % kEvery == 0;
    const int vb = (c / kEvery) & 1;
    if (test) {
      const unsigned warp_any = __reduce_or_sync(0xffffffffu, p.log_raw >= kLogTEps ? 1u : 0u);
      if (lane == 0) votes[vb][warp] = warp_any;
    }
    // the one barrier of the chunk: it is staged and visible, the votes are
    // in, and every thread is past chunk c - 1, whose slot the next copy fills
    __syncthreads();
    if (test) {
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) any |= votes[vb][w];
      if (!any) break;
    }
    issue(c + kRing - 1);
    const int nb = min(chunk, end - (start + c * chunk));
    // the chunk's rows, addressed once a chunk
    const float4* row = s[slot][0];
    if constexpr (kMode == kFloor) {
      float sum = 0.0f;
      for (int k = 0; k < nb; ++k, row += kStaged) sum = sum + row->x;
      p.log_eff = p.log_eff + sum * kFloorScale;
    } else {
      for (int k = 0; k < nb; ++k, row += kStaged) pair_step<kMode>(row, px, py, p);
    }
  }
  cp_async_wait<0>();  // unroll2 may leave copies of later chunks in flight
  const long long pix = (long long)tile * kPix + tid;
  accum[3 * pix + 0] = p.c0;
  accum[3 * pix + 1] = kMode == kNoCarry ? p.c0 : p.c1;
  accum[3 * pix + 2] = kMode == kNoCarry ? p.c0 : p.c2;
  log_t_eff[pix] = p.log_eff;
  log_t_raw[pix] = p.log_raw;
  if (tid == 0) n_done[tile] = c;
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
      probe_fwd_kernel<kUnroll2><<<num_tiles, kPix, 0, cs>>>(r, pl, m, grid_w, chunk, a, e, w, nd);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
