// bin_count and bin_write: the binning's expansion and per-tile opacity
// cull, in two passes over the Gaussians in depth order.
//
// Replaces no Pallas kernel: the JAX package leaves the expansion, the cull
// and the sort to XLA ops (gsdf_slam_tpu/ops/binning.py::bin_gaussians,
// pallas_binning.py::sort_expand_pack); its one Pallas kernel there is the
// realign, which K3 (tile_ranges_pack.cu) replaces. The reference expands in
// one kernel, duplicateWithKeys (rasterizer_impl.cu:66-118, 186-210), into a
// buffer sized ahead with dummy keys for culled slots. The port sizes its
// pair arrays exactly, so it counts the kept pairs first (bin_count), reads
// the count back once, and then writes them (bin_write).
//
// Order. The plain route (ops/binning.py::expand_and_sort) stably sorts the
// key tile << 32 | depth bits over pairs in Gaussian order. Here the
// Gaussians are first sorted stably by their depth bits (torch.sort over P
// int32 keys, the bits with the sign flipped so that they order unsigned),
// these passes expand them in that order (`perm`), and a stable sort of the
// int32 tile id alone finishes. A Gaussian has at
// most one pair in a tile, so within a tile the pairs keep the depth order,
// ties by Gaussian index: the plain route's order, bit for bit.
//
// Design. One warp takes 32 consecutive Gaussians of the depth order: each
// lane loads one Gaussian's rect, mean, conic and log(opacity * 255) into
// shared memory, a warp scan of tiles_touched flattens the warp's (Gaussian,
// tile) pairs, and the warp walks them 32 at a time, each lane finding its
// Gaussian by a 5-step search of the scan. So the tiles of one warp's
// Gaussians are spread over all its lanes: a rect that spans the grid (1,848
// tiles at 1226x370) takes its warp 58 rounds and leaves no lane idle, and
// a warp of one-tile Gaussians takes one round. Each lane evaluates
// ops/binning.py::tile_peak_power op for op in the plain version's order
// (the library's --fmad=false), with torch.clamp's NaN propagation, and
// compares it with log(opacity * 255) computed by torch (so the log is
// torch's own). A ballot gives each kept pair its rank among the warp's:
// bin_count writes each warp's kept count (scanned by torch.cumsum) and adds
// the kept and pre-cull totals with one atomic each per block; bin_write
// walks again and writes each kept pair's tile id and Gaussian at the
// warp's offset plus its rank, in expansion order (local tile index
// ascending within a Gaussian, as the plain route's expansion).
//
// Bound: memory. A pass reads perm and tiles_touched of every Gaussian (12
// bytes), and each visible one's rect_min, rect_max's x, mean, conic and
// log(opacity * 255) through `perm` (a gather: 36 bytes over some 6
// sectors); bin_write writes 6 bytes a kept pair; the cull is ~50 float32 operations a pre-cull pair,
// ~0.4 GFLOP a pass at 7.5M pairs, some 6 us at 67 TFLOP/s. The random
// gather is the cost: the design reads each Gaussian once a pass, from one
// lane, and shares it through shared memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // warps a block
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPatch = 15.0f;  // TILE - 1

// torch.clamp(v, 0, 1): NaN stays NaN (fminf and fmaxf would drop it)
__device__ __forceinline__ float clamp01(float v) { return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f); }

// ops/binning.py::tile_peak_power of one (Gaussian, tile) <= log(op * 255),
// each product and sum in the plain version's order
__device__ __forceinline__ bool tile_keep(float mx, float my, float a, float b, float c, float log_op, int tx,
                                          int ty) {
  const float rect_min_x = (float)(tx * gsdf::kTile);
  const float rect_min_y = (float)(ty * gsdf::kTile);
  const float rect_max_x = rect_min_x + kPatch;
  const float rect_max_y = rect_min_y + kPatch;

  const float x_min_diff = rect_min_x - mx;
  const float x_left = x_min_diff > 0.0f ? 1.0f : 0.0f;
  const float not_in_x = x_left + (mx > rect_max_x ? 1.0f : 0.0f);
  const float y_min_diff = rect_min_y - my;
  const float y_above = y_min_diff > 0.0f ? 1.0f : 0.0f;
  const float not_in_y = y_above + (my > rect_max_y ? 1.0f : 0.0f);

  const float px = x_left * rect_min_x + (1.0f - x_left) * rect_max_x;
  const float py = y_above * rect_min_y + (1.0f - y_above) * rect_max_y;
  const float dx = x_min_diff > 0.0f ? kPatch : -kPatch;
  const float dy = y_min_diff > 0.0f ? kPatch : -kPatch;
  const float diffx = mx - px;
  const float diffy = my - py;

  const float txf = not_in_y * clamp01((dx * a * diffx + dx * b * diffy) / (kPatch * kPatch * a));
  const float tyf = not_in_x * clamp01((dy * b * diffx + dy * c * diffy) / (kPatch * kPatch * c));
  const float max_x = px + txf * dx;
  const float max_y = py + tyf * dy;

  const float ddx = mx - max_x;
  const float ddy = my - max_y;
  float factor = 0.5f * (a * ddx * ddx + c * ddy * ddy) + b * ddx * ddy;
  factor = (not_in_x + not_in_y) > 0.0f ? factor : 0.0f;
  return factor <= log_op;
}

struct Inputs {
  const long long* perm;  // [P] Gaussians in depth order
  long long p;
  const int* tiles_touched;  // [P]
  const int* rect_min;       // [P, 2]
  const int* rect_max;       // [P, 2]
  const float* means2d;      // [P, 2]
  const float* conics;       // [P, 3]
  const float* log_op;       // [P] log(opacity * 255)
  int grid_w;
};

// The warp's 32 Gaussians, staged by their lanes
struct Staged {
  int end[kWarps][32];  // inclusive scan of tiles_touched over the warp
  int g[kWarps][32], rx[kWarps][32], ry[kWarps][32], rw[kWarps][32];
  float mx[kWarps][32], my[kWarps][32], a[kWarps][32], b[kWarps][32], c[kWarps][32], lo[kWarps][32];
};

// Walks the warp's pairs in expansion order, 32 a round; calls
// on_round(ballot of keep, keep, tile, Gaussian) once a round on every lane.
// Returns the warp's pre-cull pairs.
template <typename F>
__device__ __forceinline__ int walk(const Inputs& in, Staged& s, F&& on_round) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i = ((long long)blockIdx.x * kWarps + w) * 32 + lane;
  int n = 0;
  if (i < in.p) {
    const int g = (int)in.perm[i];
    n = max(in.tiles_touched[g], 0);
    if (n > 0) {
      s.g[w][lane] = g;
      s.rx[w][lane] = in.rect_min[2 * g];
      s.ry[w][lane] = in.rect_min[2 * g + 1];
      s.rw[w][lane] = max(in.rect_max[2 * g] - in.rect_min[2 * g], 1);
      s.mx[w][lane] = in.means2d[2 * g];
      s.my[w][lane] = in.means2d[2 * g + 1];
      s.a[w][lane] = in.conics[3 * g];
      s.b[w][lane] = in.conics[3 * g + 1];
      s.c[w][lane] = in.conics[3 * g + 2];
      s.lo[w][lane] = in.log_op[g];
    }
  }
  int end = n;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, end, d);
    if (lane >= d) end += v;
  }
  s.end[w][lane] = end;
  const int total = __shfl_sync(kFull, end, 31);
  __syncwarp();
  for (int j0 = 0; j0 < total; j0 += 32) {
    const int j = j0 + lane;
    bool keep = false;
    int tile = 0, g = 0;
    if (j < total) {
      int k = 0;
      // the Gaussian whose pairs hold j: the first k with end[k] > j
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (s.end[w][k + step - 1] <= j) k += step;
      const int local = j - (k > 0 ? s.end[w][k - 1] : 0);
      const int rw = s.rw[w][k];
      const int tx = s.rx[w][k] + local % rw;
      const int ty = s.ry[w][k] + local / rw;
      keep = tile_keep(s.mx[w][k], s.my[w][k], s.a[w][k], s.b[w][k], s.c[w][k], s.lo[w][k], tx, ty);
      tile = ty * in.grid_w + tx;
      g = s.g[w][k];
    }
    on_round(__ballot_sync(kFull, keep), keep, tile, g);
  }
  return total;
}

__global__ void __launch_bounds__(kWarps * 32) bin_count_kernel(Inputs in, int n_warps, int* __restrict__ counts,
                                                                unsigned long long* __restrict__ totals) {
  __shared__ Staged s;
  __shared__ int block_sum[2][kWarps];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int kept = 0;
  const int total = walk(in, s, [&](unsigned mask, bool, int, int) { kept += __popc(mask); });
  const long long wid = (long long)blockIdx.x * kWarps + w;
  if (lane == 0) {
    if (wid < n_warps) counts[wid] = kept;
    block_sum[0][w] = kept;
    block_sum[1][w] = total;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    unsigned long long sum = 0;
    for (int v = 0; v < kWarps; ++v) sum += (unsigned long long)block_sum[threadIdx.x][v];
    if (sum) atomicAdd(totals + threadIdx.x, sum);
  }
}

__global__ void __launch_bounds__(kWarps * 32) bin_write_kernel(Inputs in, const long long* __restrict__ warp_end,
                                                                int* __restrict__ tiles, int* __restrict__ pair_gid) {
  __shared__ Staged s;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long wid = (long long)blockIdx.x * kWarps + w;
  if (wid * 32 >= in.p) return;  // warp-uniform: the whole warp leaves
  long long out = wid > 0 ? warp_end[wid - 1] : 0;
  const unsigned below = (1u << lane) - 1u;
  walk(in, s, [&](unsigned mask, bool keep, int tile, int g) {
    if (keep) {
      const long long pos = out + __popc(mask & below);
      tiles[pos] = tile;
      pair_gid[pos] = g;
    }
    out += __popc(mask);
  });
}

Inputs make_inputs(const void* perm, long long p, const void* tiles_touched, const void* rect_min,
                   const void* rect_max, const void* means2d, const void* conics, const void* log_op, int grid_w) {
  return Inputs{(const long long*)perm, p, (const int*)tiles_touched, (const int*)rect_min, (const int*)rect_max,
                (const float*)means2d, (const float*)conics, (const float*)log_op, grid_w};
}

unsigned blocks_for(long long p) { return (unsigned)((p + kWarps * 32 - 1) / (kWarps * 32)); }

}  // namespace

// counts [ceil(P / 32)] int32: kept pairs of each warp's 32 Gaussians of
// the depth order; totals [2] int64: (kept pairs, pre-cull pairs), zeroed
// here first
extern "C" int gsdf_bin_count(const void* perm, long long p, const void* tiles_touched, const void* rect_min,
                              const void* rect_max, const void* means2d, const void* conics, const void* log_op,
                              int grid_w, void* counts, void* totals, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(totals, 0, 2 * sizeof(long long), st);
  if (err != cudaSuccess) return (int)err;
  if (p <= 0) return 0;
  const int n_warps = (int)((p + 31) / 32);
  bin_count_kernel<<<blocks_for(p), kWarps * 32, 0, st>>>(
      make_inputs(perm, p, tiles_touched, rect_min, rect_max, means2d, conics, log_op, grid_w), n_warps,
      (int*)counts, (unsigned long long*)totals);
  return (int)cudaGetLastError();
}

// warp_end [ceil(P / 32)] int64: inclusive scan of bin_count's counts;
// tiles [M] and pair_gid [M] int32, in expansion order
extern "C" int gsdf_bin_write(const void* perm, long long p, const void* tiles_touched, const void* rect_min,
                              const void* rect_max, const void* means2d, const void* conics, const void* log_op,
                              int grid_w, const void* warp_end, void* tiles, void* pair_gid, void* stream) {
  if (p <= 0) return 0;
  bin_write_kernel<<<blocks_for(p), kWarps * 32, 0, (cudaStream_t)stream>>>(
      make_inputs(perm, p, tiles_touched, rect_min, rect_max, means2d, conics, log_op, grid_w),
      (const long long*)warp_end, (int*)tiles, (int*)pair_gid);
  return (int)cudaGetLastError();
}
