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
// window, output [16, MP]). In both, one thread per output lane reads its
// 16 fields straight from the table. The TPU staged the window in VMEM;
// here that would take 74 or 139 KB of shared memory a block, and it is not
// needed: a dense monotone rank makes a warp's 32 loads of one field row
// fall on a few consecutive words, so the loads coalesce, and neighbouring
// lanes reread the same words through L1, so the table keeps the default
// cache. The output is what costs: it is 4x the table bytes read and larger
// than L2 at the headline.
// - cols ([16, MP]) writes one coalesced 128-byte row segment a warp per
//   field.
// - rows ([MP, 16]) puts each lane's 16 fields as four 16-byte words into
//   a [256, 16] tile in shared memory (XOR-swizzled, so both the writes and
//   the reads are free of bank conflicts), and after one barrier the block
//   stores the tile as one contiguous 16 KB run of 16-byte streaming stores
//   (`__stcs`): each warp store instruction writes 512 contiguous bytes,
//   where a lane storing its own 64-byte row would spread each one over 32
//   pieces of 16 bytes across 2 KB (PERF.md prices the two). The ranks and
//   window starts are read once, with streaming loads.
// The one-hot product at Precision.HIGHEST equals this copy on finite
// inputs, with two exceptions the copy does not share: -0.0 comes out
// +0.0, and a NaN or inf anywhere in the chunk's window spreads to the
// chunk's lanes. Out of the window the rows layout writes 0 (the one-hot
// product's value) and the cols layout NaN (0x7fc00000), where
// take_along_axis is undefined.
//
// xpose_cumsum replaces bench_expand_xpose_cumsum_pallas (:804, body
// _xpose_cumsum_kernel :775), which transposes 512-lane blocks and carries
// the running sum in VMEM across a sequential grid. The card has no
// sequential grid, so the carry crosses blocks by a decoupled look-back
// (Merrill and Garland's single-pass prefix scan), in one launch after the
// scratch is zeroed, reading the input once:
// - a block takes its tile (kXBlk lanes) from an atomic ticket, not from
//   blockIdx.x, so it only ever waits on tiles whose blocks are running;
// - it loads the [kXBlk, 16] tile with 16-byte loads into shared memory,
//   transposed, each row padded with one word after every 32-lane run and
//   two at its end (stride 1058 = 2 mod 8, so a warp's transposing stores,
//   its raking reads and its row reads each hit 32 banks);
// - warp f scans field row f: lane l sums the run of lanes 32l .. 32l + 31,
//   one shuffle scan over the warp gives each run's offset and the tile's
//   aggregate;
// - lane 0 publishes the field's aggregate; the warp then looks back over
//   the predecessors' status words, a window of 32 at a time, summing
//   aggregates until an inclusive prefix appears, and lane 0 publishes the
//   tile's inclusive prefix;
//   flag and value share one 64-bit word (flag high, value low), written
//   by one atomic exchange, so a reader never sees a flag without its
//   value and no fence is needed (the value depends on no other store);
// - each lane rewrites its run as the inclusive sums from its offset, and
//   the block writes [16, MP] rows in 16-byte streaming stores (scalar
//   where a row is not 16-byte aligned), the last partial tile masked.
// Addition modulo 2^32 is associative, so the order of the sums changes
// nothing: the output is the plain version's bit for bit.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kFields = 16;
constexpr int kChunk = 128;
constexpr int kRealignThreads = 256;  // 16 rows x 32 four-lane columns, two rows a thread
constexpr int kGatherThreads = 256;
// xpose_cumsum: lanes per tile (ops/pair_table.py XPOSE_BLOCK is a copy,
// tied to this one by tests/test_torch_microbench.py), one warp per field
// row, each lane raking a run of kXRun lanes
constexpr int kXBlk = 1024;
constexpr int kXThreads = 32 * kFields;
constexpr int kXRun = kXBlk / 32;
// padded row: a word after each run, 2 more; 1058 = 2 mod 8, so the 4 field
// groups x 8 lanes of a warp's transposing stores hit 32 banks
constexpr int kXRow = kXBlk + kXBlk / kXRun + 2;
constexpr int kXSmem = kFields * kXRow * 4;
// status word flags (high half; the value is the low half)
constexpr unsigned long long kXAggregate = 1ull << 32;  // the tile's own sum
constexpr unsigned long long kXInclusive = 2ull << 32;  // the sum through the tile

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

// out [16, mp]: one thread per output lane, one coalesced row store per
// field; NaN (0x7fc00000) out of the window
__global__ void __launch_bounds__(kGatherThreads) window_gather_cols_kernel(
    const int* __restrict__ ws, const unsigned* __restrict__ table, long long lanes,
    const int* __restrict__ ranks, long long mp, int win, int cpc, unsigned* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  if (i >= mp) return;
  const long long r = ranks[i];
  const long long local = r - ws[i / cpc];
  const bool inside = local >= 0 && local < win && r >= 0 && r < lanes;
  unsigned v[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) v[f] = inside ? table[f * lanes + r] : 0x7fc00000u;
#pragma unroll
  for (int f = 0; f < kFields; ++f) out[f * mp + i] = v[f];
}

// where 16-byte word q (fields 4q .. 4q + 3) of lane l of a block sits in
// its tile: the word index XOR-swizzled by bits 1-2 of the lane, so the 8
// lanes of a quarter warp's 16-byte accesses hit the 8 four-bank groups
// both when a thread writes its lane's four words and when neighbouring
// threads read neighbouring words
__device__ __forceinline__ int gather_slot(int l, int q) { return 4 * l + (q ^ ((l >> 1) & 3)); }

// out [mp, 16] as 16-byte words: one thread per output lane loads its 16
// fields, the block's [kGatherThreads, 16] tile goes through shared memory,
// and the block writes it back as one contiguous run of streaming stores
__global__ void __launch_bounds__(kGatherThreads) window_gather_rows_kernel(
    const int* __restrict__ ws, const unsigned* __restrict__ table, long long lanes,
    const int* __restrict__ ranks, long long mp, int win, int cpc, uint4* __restrict__ out) {
  __shared__ uint4 tile[kGatherThreads * kFields / 4];
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * kGatherThreads;
  const long long i = base + t;
  long long r = 0;
  bool inside = false;
  if (i < mp) {
    r = __ldcs(ranks + i);
    const long long local = r - __ldcs(ws + i / cpc);
    inside = local >= 0 && local < win && r >= 0 && r < lanes;
  }
  unsigned v[kFields];
#pragma unroll
  for (int f = 0; f < kFields; ++f) v[f] = inside ? table[f * lanes + r] : 0u;
#pragma unroll
  for (int q = 0; q < kFields / 4; ++q)
    tile[gather_slot(t, q)] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  __syncthreads();
  // word w of the block's output: a warp stores 512 contiguous bytes
#pragma unroll
  for (int k = 0; k < kFields / 4; ++k) {
    const int w = t + k * kGatherThreads;
    const int l = w >> 2;
    if (base + l < mp) __stcs(out + base * (kFields / 4) + w, tile[gather_slot(l, w & 3)]);
  }
}

// where lane `lane` of a tile sits in its padded shared-memory row
__device__ __forceinline__ int xslot(int lane) { return lane + lane / kXRun; }

// The sum of one field over tiles 0 .. tile - 1, by one warp, from the
// field's status words: lane l reads predecessor tile - 1 - l of a window
// that moves back 32 tiles at a time until it holds an inclusive prefix
// (before tile 0, a virtual inclusive 0); a window with an unpublished word
// before its nearest inclusive prefix is read again.
__device__ __forceinline__ unsigned xpose_look_back(const unsigned long long* st, int tile, int l) {
  unsigned excl = 0;
  for (int pred = tile - 1;;) {
    const int i = pred - l;
    const unsigned long long w = i >= 0 ? *(volatile const unsigned long long*)(st + i) : kXInclusive;
    const unsigned flag = (unsigned)(w >> 32);
    const unsigned inc = __ballot_sync(0xffffffffu, flag == (unsigned)(kXInclusive >> 32));
    // the lanes up to the nearest inclusive prefix, all if there is none
    const unsigned upto = inc ? inc ^ (inc - 1) : 0xffffffffu;
    if (__ballot_sync(0xffffffffu, flag == 0u) & upto) continue;
    unsigned v = (upto >> l) & 1u ? (unsigned)w : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    excl += v;
    if (inc) return excl;
    pred -= 32;
  }
}

// out [16, MP] = inclusive cumsum of x [MP, 16] along MP, one tile a block
// in ticket order; status [16, nt] and the ticket zeroed before the launch.
__global__ void __launch_bounds__(kXThreads, 3) xpose_cumsum_kernel(const uint4* __restrict__ x, long long mp,
                                                                    int nt, unsigned long long* __restrict__ status,
                                                                    unsigned* __restrict__ ticket, bool vec,
                                                                    unsigned* __restrict__ out) {
  extern __shared__ unsigned rows[];  // [kFields][kXRow]
  __shared__ int tile_of_block;
  const int t = threadIdx.x;
  if (t == 0) tile_of_block = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = tile_of_block;
  const long long base = (long long)tile * kXBlk;
  // 16-byte word q of the tile holds fields 4 (q & 3) .. 4 (q & 3) + 3 of
  // lane q >> 2; four loads in flight a thread (eight spill at 42 registers)
#pragma unroll 4
  for (int k = 0; k < kXBlk * 4 / kXThreads; ++k) {
    const int q = t + k * kXThreads;
    const int lane = q >> 2;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base + lane < mp) v = __ldcs(x + base * 4 + q);
    unsigned* d = rows + 4 * (q & 3) * kXRow + xslot(lane);
    d[0] = v.x;
    d[kXRow] = v.y;
    d[2 * kXRow] = v.z;
    d[3 * kXRow] = v.w;
  }
  __syncthreads();
  const int f = t >> 5, l = t & 31;
  unsigned* run = rows + f * kXRow + xslot(l * kXRun);
  unsigned sum = 0u;
#pragma unroll 8
  for (int k = 0; k < kXRun; ++k) sum += run[k];
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(0xffffffffu, incl, o);
    if (l >= o) incl += u;
  }
  const unsigned agg = __shfl_sync(0xffffffffu, incl, 31);
  unsigned long long* st = status + (long long)f * nt;
  if (l == 0) atomicExch(st + tile, (tile == 0 ? kXInclusive : kXAggregate) | agg);
  unsigned acc = incl - sum;
  if (tile > 0) {
    const unsigned excl = xpose_look_back(st, tile, l);
    if (l == 0) atomicExch(st + tile, kXInclusive | (excl + agg));
    acc += excl;
  }
#pragma unroll 8
  for (int k = 0; k < kXRun; ++k) {
    acc += run[k];
    run[k] = acc;
  }
  __syncthreads();
  // word q of the output tile: lanes 4c .. 4c + 3 of row q / (kXBlk / 4)
#pragma unroll
  for (int k = 0; k < kFields * kXBlk / 4 / kXThreads; ++k) {
    const int q = t + k * kXThreads;
    const int fr = q / (kXBlk / 4);
    const int lane = 4 * (q % (kXBlk / 4));
    const unsigned* src = rows + fr * kXRow + xslot(lane);
    const long long g = base + lane;
    unsigned* dst = out + fr * mp + g;
    if (vec && g + 3 < mp) {
      __stcs(reinterpret_cast<uint4*>(dst), make_uint4(src[0], src[1], src[2], src[3]));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (g + j < mp) dst[j] = src[j];
    }
  }
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
  if (mp <= 0) return 0;
  window_gather_rows_kernel<<<(unsigned)((mp + kGatherThreads - 1) / kGatherThreads), kGatherThreads, 0,
                              (cudaStream_t)stream>>>((const int*)ws, (const unsigned*)table, lanes,
                                                      (const int*)ranks, mp, win, cpc, (uint4*)out);
  return (int)cudaGetLastError();
}

// ws [mp / cpc], table [16, lanes], ranks [mp], out [16, mp].
extern "C" int gsdf_window_gather_cols(const void* ws, const void* table, long long lanes, const void* ranks,
                                       long long mp, int win, int cpc, void* out, void* stream) {
  if (mp <= 0) return 0;
  window_gather_cols_kernel<<<(unsigned)((mp + kGatherThreads - 1) / kGatherThreads), kGatherThreads, 0,
                              (cudaStream_t)stream>>>((const int*)ws, (const unsigned*)table, lanes,
                                                      (const int*)ranks, mp, win, cpc, (unsigned*)out);
  return (int)cudaGetLastError();
}

// x [mp, 16] int32 (16-byte aligned), scratch [16 ceil(mp / kXBlk) + 1]
// 64-bit words (the status words [16, tiles] and the ticket; zeroed here on
// the stream, so a CUDA graph replays the zeroing), out [16, mp].
extern "C" int gsdf_xpose_cumsum(const void* x, long long mp, void* scratch, long long scratch_words, void* out,
                                 void* stream) {
  if (mp <= 0) return 0;
  const long long nt = (mp + kXBlk - 1) / kXBlk;
  if (nt > 0x7fffffff || scratch_words != kFields * nt + 1) return (int)cudaErrorInvalidValue;
  // the tile takes more than the 48 KB of static shared memory; set once
  static const cudaError_t attr =
      cudaFuncSetAttribute(xpose_cumsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kXSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaStream_t s = (cudaStream_t)stream;
  auto* status = (unsigned long long*)scratch;
  cudaError_t err = cudaMemsetAsync(status, 0, scratch_words * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return (int)err;
  const bool vec = mp % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  xpose_cumsum_kernel<<<(unsigned)nt, kXThreads, kXSmem, s>>>((const uint4*)x, mp, (int)nt, status,
                                                             (unsigned*)(status + kFields * nt), vec,
                                                             (unsigned*)out);
  return (int)cudaGetLastError();
}
