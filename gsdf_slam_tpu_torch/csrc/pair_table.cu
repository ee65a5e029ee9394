// Pair-table kernels: the realign copy, the windowed monotone-rank gather
// (two output layouts) and the transposing int32 cumsum.
//
// They replace the four Pallas kernels of benchmarks/microbench.py. Each
// moves 32-bit words or adds integers modulo 2^32, so each is bit-equal to
// its plain version in ops/pair_table.py. All four are bound by device
// memory: they do no arithmetic beyond address and integer adds, and the
// bound is the bytes read once and written once at 3.35 TB/s.
//
// realign_copy replaces bench_realign_dma (pallas_call :282, body
// _realign_kernel2 :230), which walks each of 404 groups' 128-lane chunks
// with a 2x128-lane DMA window into VMEM and a lane roll by the source's
// misalignment: dst[:, dst0 + k] = src[:, src0 + k] for k < 128 nch. Here
// the misaligned source start is only an offset, so no roll and no window.
// Output-driven: one 256-thread block per 128-lane output chunk finds the
// group that covers it by a binary search over the ascending dst0 (the
// TPU's group layout), and writes the chunk's 16 rows whether covered or
// not (0 where not), so every output word is written once and there is no
// memset. Each thread stores one 16-byte word of 4 lanes in two rows; the
// source is misaligned, so it loads those lanes as 4-byte words, which the
// warp's four loads take from the same 512 bytes through L1.
//
// window_gather_rows / _cols replace bench_windowed_gather (:345, body
// _wingather_kernel :296, a one-hot [1024, 1152] x [1152, 16] product on the
// MXU per chunk, output [MP, 16]) and bench_windowed_gather_dg (:399, body
// _wingather_dg_kernel :358, a lane take_along_axis over a 2176-lane
// window, output [16, MP]). One template, the output layout its parameter:
// one thread per output lane reads its 16 fields straight from the table.
// The TPU staged the window in VMEM; here that would take 74 or 139 KB of
// shared memory a block, and it is not needed: a dense monotone rank makes a
// warp's 32 loads of one field row fall on a few consecutive words, so the
// loads coalesce. [MP, 16] is written as four 16-byte stores per lane,
// [16, MP] as one coalesced row store per field. The one-hot product at
// Precision.HIGHEST equals this copy on finite inputs, with two exceptions
// the copy does not share: -0.0 comes out +0.0, and a NaN or inf anywhere in
// the chunk's window spreads to the chunk's lanes. Out of the window the
// rows layout writes 0 (the one-hot product's value) and the cols layout
// NaN (0x7fc00000), where take_along_axis is undefined.
//
// xpose_cumsum replaces bench_expand_xpose_cumsum_pallas (:804, body
// _xpose_cumsum_kernel :775), which transposes 512-lane blocks and carries
// the running sum in VMEM across a sequential grid. Blocks here run in no
// order, so the carry is a scan across blocks in three launches: (1) each
// 512-lane block's 16 field totals, (2) one block turns the totals into
// exclusive block offsets, (3) each block stages its [512, 16] tile
// transposed in shared memory (rows padded by 2 words, so the transposing
// stores hit 32 banks), scans each field row by warp shuffles from its
// offset and writes [16, MP] rows coalesced. Addition modulo 2^32 is
// associative, so the order of the sums changes nothing. The input is read
// twice (1.5x the bound's bytes); a single pass with a decoupled look-back
// would read it once.
#include <cuda_runtime.h>

namespace {

constexpr int kFields = 16;
constexpr int kChunk = 128;
constexpr int kRealignThreads = 256;  // 16 rows x 32 four-lane columns, two rows a thread
constexpr int kGatherThreads = 256;
constexpr int kXBlk = 512;  // lanes per xpose_cumsum block
constexpr int kXThreads = 256;
constexpr int kXPad = 2;  // row stride kXBlk + 2 = 2 mod 8: the 4 field groups x 8 lanes of a warp's stores hit 32 banks

__global__ void __launch_bounds__(kRealignThreads) realign_kernel(const int* __restrict__ tbl, int ng,
                                                                  const unsigned* __restrict__ src,
                                                                  long long lanes, long long mpa,
                                                                  unsigned* __restrict__ out) {
  const long long d0 = (long long)blockIdx.x * kChunk;
  const int* src0 = tbl;
  const int* dst0 = tbl + ng;
  const int* nch = tbl + 2 * ng;
  // the last group whose dst0 <= d0 (every thread of the block walks the
  // same addresses: broadcast loads)
  int lo = 0, hi = ng;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)dst0[mid] <= d0) lo = mid + 1;
    else hi = mid;
  }
  const int g = lo - 1;
  bool covered = false;
  long long s0 = 0;
  if (g >= 0) {
    const long long off = d0 - dst0[g];
    covered = off < (long long)nch[g] * kChunk;
    s0 = (long long)src0[g] + off;
  }
  const int col = threadIdx.x & 31;
  const long long d = d0 + 4 * col;
  if (d >= mpa) return;  // mpa % 4 == 0: a four-lane column is all in or all out
  const long long s = s0 + 4 * col;
  for (int f = threadIdx.x >> 5; f < kFields; f += kRealignThreads / 32) {
    const unsigned* row = src + f * lanes;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (covered) {
      v.x = (s >= 0 && s < lanes) ? row[s] : 0u;
      v.y = (s + 1 >= 0 && s + 1 < lanes) ? row[s + 1] : 0u;
      v.z = (s + 2 >= 0 && s + 2 < lanes) ? row[s + 2] : 0u;
      v.w = (s + 3 >= 0 && s + 3 < lanes) ? row[s + 3] : 0u;
    }
    *reinterpret_cast<uint4*>(out + f * mpa + d) = v;
  }
}

template <bool kRows>
__global__ void __launch_bounds__(kGatherThreads) window_gather_kernel(
    const int* __restrict__ ws, const unsigned* __restrict__ table, long long lanes,
    const int* __restrict__ ranks, long long mp, int win, int cpc, unsigned fill,
    unsigned* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  if (i >= mp) return;
  const long long r = ranks[i];
  const long long local = r - ws[i / cpc];
  const bool inside = local >= 0 && local < win && r >= 0 && r < lanes;
  unsigned v[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) v[f] = inside ? table[f * lanes + r] : fill;
  if (kRows) {
    uint4* o = reinterpret_cast<uint4*>(out + i * kFields);
#pragma unroll
    for (int q = 0; q < kFields / 4; ++q) o[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int f = 0; f < kFields; ++f) out[f * mp + i] = v[f];
  }
}

// (1) totals[b, f] = sum of x[lane, f] over block b's lanes. Thread t reads
// 16-byte words t + 256 k of the block's tile: always the fields 4 (t & 3)
// .. 4 (t & 3) + 3 of some lane.
__global__ void __launch_bounds__(kXThreads) xpose_totals_kernel(const uint4* __restrict__ x, long long mp,
                                                                 unsigned* __restrict__ totals) {
  __shared__ unsigned part[kXThreads / 32][kFields];
  const long long base = (long long)blockIdx.x * kXBlk;
  const int t = threadIdx.x;
  uint4 s = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int k = 0; k < kXBlk * 4 / kXThreads; ++k) {
    const int q = t + k * kXThreads;
    if (base + (q >> 2) < mp) {
      const uint4 v = x[base * 4 + q];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
  }
  for (int o = 4; o < 32; o <<= 1) {
    s.x += __shfl_xor_sync(0xffffffffu, s.x, o);
    s.y += __shfl_xor_sync(0xffffffffu, s.y, o);
    s.z += __shfl_xor_sync(0xffffffffu, s.z, o);
    s.w += __shfl_xor_sync(0xffffffffu, s.w, o);
  }
  const int w = t >> 5, l = t & 31;
  if (l < 4) {
    part[w][4 * l] = s.x;
    part[w][4 * l + 1] = s.y;
    part[w][4 * l + 2] = s.z;
    part[w][4 * l + 3] = s.w;
  }
  __syncthreads();
  if (t < kFields) {
    unsigned sum = 0u;
    for (int k = 0; k < kXThreads / 32; ++k) sum += part[k][t];
    totals[blockIdx.x * kFields + t] = sum;
  }
}

// (2) totals -> exclusive block offsets, in place: thread t sums field
// t & 15 over segment t >> 4 of the blocks, then rewrites the segment.
constexpr int kScanThreads = 512;
constexpr int kSegments = kScanThreads / kFields;

__global__ void __launch_bounds__(kScanThreads) xpose_scan_totals_kernel(unsigned* __restrict__ totals,
                                                                         long long nb) {
  __shared__ unsigned seg[kSegments][kFields];
  const int f = threadIdx.x & (kFields - 1);
  const int sg = threadIdx.x / kFields;
  const long long per = (nb + kSegments - 1) / kSegments;
  const long long lo = sg * per;
  const long long hi = lo + per < nb ? lo + per : nb;
  unsigned sum = 0u;
  for (long long b = lo; b < hi; ++b) sum += totals[b * kFields + f];
  seg[sg][f] = sum;
  __syncthreads();
  unsigned run = 0u;
  for (int k = 0; k < sg; ++k) run += seg[k][f];
  for (long long b = lo; b < hi; ++b) {
    const unsigned v = totals[b * kFields + f];
    totals[b * kFields + f] = run;
    run += v;
  }
}

// (3) each block's tile transposed into shared memory, each field row
// scanned by one warp from the block's offset, written as [16, MP].
__global__ void __launch_bounds__(kXThreads) xpose_cumsum_kernel(const uint4* __restrict__ x, long long mp,
                                                                 const unsigned* __restrict__ offsets,
                                                                 unsigned* __restrict__ out) {
  __shared__ unsigned tile[kFields][kXBlk + kXPad];
  const long long base = (long long)blockIdx.x * kXBlk;
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 0; k < kXBlk * 4 / kXThreads; ++k) {
    const int q = t + k * kXThreads;
    const int lane = q >> 2;
    const int f0 = 4 * (q & 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base + lane < mp) v = x[base * 4 + q];
    tile[f0][lane] = v.x;
    tile[f0 + 1][lane] = v.y;
    tile[f0 + 2][lane] = v.z;
    tile[f0 + 3][lane] = v.w;
  }
  __syncthreads();
  const int w = t >> 5, l = t & 31;
  for (int f = w; f < kFields; f += kXThreads / 32) {
    unsigned carry = offsets[blockIdx.x * kFields + f];
    for (int sg = 0; sg < kXBlk / 32; ++sg) {
      const int lane = sg * 32 + l;
      unsigned v = tile[f][lane];
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned u = __shfl_up_sync(0xffffffffu, v, o);
        if (l >= o) v += u;
      }
      v += carry;
      if (base + lane < mp) out[f * mp + base + lane] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

int window_gather(bool rows, const void* ws, const void* table, long long lanes, const void* ranks,
                  long long mp, int win, int cpc, void* out, void* stream) {
  if (mp <= 0) return 0;
  const unsigned blocks = (unsigned)((mp + kGatherThreads - 1) / kGatherThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (rows) {
    window_gather_kernel<true><<<blocks, kGatherThreads, 0, s>>>(
        (const int*)ws, (const unsigned*)table, lanes, (const int*)ranks, mp, win, cpc, 0u, (unsigned*)out);
  } else {
    window_gather_kernel<false><<<blocks, kGatherThreads, 0, s>>>(
        (const int*)ws, (const unsigned*)table, lanes, (const int*)ranks, mp, win, cpc, 0x7fc00000u,
        (unsigned*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// tbl [3, ng] int32 (src0, dst0, nch), src [16, lanes], out [16, mpa]; mpa % 4 == 0.
extern "C" int gsdf_realign_copy(const void* tbl, int ng, const void* src, long long lanes, long long mpa,
                                 void* out, void* stream) {
  if (mpa % 4 != 0) return (int)cudaErrorInvalidValue;
  if (mpa <= 0) return 0;
  realign_kernel<<<(unsigned)((mpa + kChunk - 1) / kChunk), kRealignThreads, 0, (cudaStream_t)stream>>>(
      (const int*)tbl, ng, (const unsigned*)src, lanes, mpa, (unsigned*)out);
  return (int)cudaGetLastError();
}

// ws [mp / cpc], table [16, lanes], ranks [mp], out [mp, 16].
extern "C" int gsdf_window_gather_rows(const void* ws, const void* table, long long lanes, const void* ranks,
                                       long long mp, int win, int cpc, void* out, void* stream) {
  return window_gather(true, ws, table, lanes, ranks, mp, win, cpc, out, stream);
}

// ws [mp / cpc], table [16, lanes], ranks [mp], out [16, mp].
extern "C" int gsdf_window_gather_cols(const void* ws, const void* table, long long lanes, const void* ranks,
                                       long long mp, int win, int cpc, void* out, void* stream) {
  return window_gather(false, ws, table, lanes, ranks, mp, win, cpc, out, stream);
}

// x [mp, 16] int32 (16-byte aligned), totals [ceil(mp / 512), 16] scratch, out [16, mp].
extern "C" int gsdf_xpose_cumsum(const void* x, long long mp, void* totals, void* out, void* stream) {
  if (mp <= 0) return 0;
  const long long nb = (mp + kXBlk - 1) / kXBlk;
  cudaStream_t s = (cudaStream_t)stream;
  xpose_totals_kernel<<<(unsigned)nb, kXThreads, 0, s>>>((const uint4*)x, mp, (unsigned*)totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xpose_scan_totals_kernel<<<1, kScanThreads, 0, s>>>((unsigned*)totals, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  xpose_cumsum_kernel<<<(unsigned)nb, kXThreads, 0, s>>>((const uint4*)x, mp, (const unsigned*)totals,
                                                         (unsigned*)out);
  return (int)cudaGetLastError();
}
