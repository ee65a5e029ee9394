// K3 tile_ranges_pack: per-tile pair ranges and the sorted payload.
//
// Replaces gsdf_slam_tpu/ops/pallas_binning.py::_realign_kernel (built by
// _make_realign, called from sort_expand_pack) together with the
// searchsorted at pallas_binning.py:283-287. On the TPU the realign copies
// each 8-tile group's sorted run to a 128-lane-aligned start so that the
// blend can DMA whole chunks. On Hopper the blend reads any offset, so what
// is left of that job is (identifyTileRanges, rasterizer_impl.cu:217-246):
//   * ranges[t] = [start, end) of tile t in the sorted pair list, (0, 0)
//     for an empty tile;
//   * gid_out[i] = pair_gid[order[i]], the Gaussian of sorted pair i;
//   * payload[f][i] = table[gid_out[i]][f], the blend payload (mean x, y,
//     conic a, b, c, opacity, rgb) gathered into one contiguous field-major
//     [9, M] buffer, so that K1 and K2 read it coalesced.
// The sorted pairs come as their int32 tile ids.
//
// Bound: memory. Per pair it reads the tile id, the order and the gid
// and 36 bytes of table row, and writes 40 bytes: about 1M pairs move some
// 0.1 GB, tens of microseconds at HBM rate. The table reads are random rows
// but the table (P x 36 bytes, 14 MB at 400k Gaussians) stays in the 50 MB
// L2. Design: one thread per sorted pair; neighbouring threads write
// neighbouring addresses of every payload row.
#include <cstdint>

#include "common.cuh"

namespace {

__global__ void tile_ranges_pack_kernel(const int* __restrict__ tiles,
                                        const long long* __restrict__ order,
                                        const int* __restrict__ pair_gid,
                                        const float* __restrict__ table, long long m,
                                        int* __restrict__ ranges, int* __restrict__ gid_out,
                                        float* __restrict__ payload) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int tile = tiles[i];
  if (i == 0) {
    ranges[2 * tile] = 0;
  } else {
    const int prev = tiles[i - 1];
    if (tile != prev) {
      ranges[2 * prev + 1] = (int)i;
      ranges[2 * tile] = (int)i;
    }
  }
  if (i == m - 1) ranges[2 * tile + 1] = (int)m;

  const int g = pair_gid[order[i]];
  gid_out[i] = g;
  const float* row = table + (long long)g * gsdf::kRows;
#pragma unroll
  for (int f = 0; f < gsdf::kRows; ++f) payload[f * m + i] = row[f];
}

}  // namespace

// tiles [M] int32, sorted
extern "C" int gsdf_tile_ranges_pack(const void* tiles, const void* order, const void* pair_gid,
                                     const void* table, long long m, void* ranges,
                                     void* gid_out, void* payload, void* stream) {
  if (m <= 0) return 0;
  const int threads = 256;
  const long long blocks = (m + threads - 1) / threads;
  tile_ranges_pack_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)tiles, (const long long*)order, (const int*)pair_gid,
      (const float*)table, m, (int*)ranges, (int*)gid_out, (float*)payload);
  return (int)cudaGetLastError();
}
