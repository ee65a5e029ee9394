// expand_gather: the binning expansion's monotone-rank gather
// out[f, i] = table[f, rank[i]], [16, MP], for a nondecreasing rank.
//
// Replaces benchmarks/expand_probe.py::make_expand (the pallas_call at :102;
// bodies _expand_kernel_mm :57, a windowed one-hot matmul, and
// _expand_kernel_dg :76, a lane dynamic_gather). Like them it takes the rank
// as g0, the window start of each 512-lane output cell in 128-lane blocks,
// and lr, the in-window rank of each output lane: since rank is monotone, a
// cell of 512 outputs draws from at most 640 consecutive table lanes.
//
// Here: one 512-thread block per cell. The block stages the cell's [16, 640]
// table window (40 KB) in shared memory with coalesced loads, then thread i
// writes out[f, 512 c + i] = window[f][lr] for the 16 fields, each row
// coalesced. Words move as 32-bit integers, so every bit pattern (the integer
// rows of the binning table included) is copied exactly. A lane whose lr lies
// outside the window gets all-ones bits (a NaN), so a bad rank cannot pass a
// bit-equality check.
//
// Bound: memory traffic, 64 bytes per output lane written plus 40 KB read
// per 512 lanes (1.25x the output), no arithmetic. Design: the window read is
// one contiguous burst per row, and the shared-memory lookups of a warp hit
// at most a few distinct lanes of a monotone rank (broadcasts).
#include <cuda_runtime.h>

namespace {

constexpr int kCell = 512;
constexpr int kWin = kCell + 128;
constexpr int kFields = 16;

__global__ void __launch_bounds__(kCell) expand_gather_kernel(const unsigned* __restrict__ table,
                                                             long long lanes,
                                                             const int* __restrict__ g0,
                                                             const int* __restrict__ lr,
                                                             long long mp,
                                                             unsigned* __restrict__ out) {
  __shared__ unsigned win[kFields][kWin];
  const int cell = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = (long long)g0[cell] * 128;
  for (int i = tid; i < kFields * kWin; i += kCell) {
    const int f = i / kWin;
    const long long col = base + (i - f * kWin);
    win[f][i - f * kWin] = (col >= 0 && col < lanes) ? table[f * lanes + col] : 0u;
  }
  __syncthreads();
  const long long o = (long long)cell * kCell + tid;
  const int r = lr[o];
  const bool inside = r >= 0 && r < kWin;
#pragma unroll
  for (int f = 0; f < kFields; ++f) out[f * mp + o] = inside ? win[f][r] : 0xffffffffu;
}

}  // namespace

// table [16, lanes], g0 [mp / 512], lr [mp], out [16, mp]; mp a multiple of 512.
extern "C" int gsdf_expand_gather(const void* table, long long lanes, const void* g0,
                                  const void* lr, long long mp, void* out, void* stream) {
  if (mp % kCell != 0) return (int)cudaErrorInvalidValue;
  if (mp <= 0) return 0;
  expand_gather_kernel<<<(unsigned)(mp / kCell), kCell, 0, (cudaStream_t)stream>>>(
      (const unsigned*)table, lanes, (const int*)g0, (const int*)lr, mp, (unsigned*)out);
  return (int)cudaGetLastError();
}
