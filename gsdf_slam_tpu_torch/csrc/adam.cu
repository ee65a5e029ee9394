// adam_step: one torch-semantics Adam step (eps 1e-15) over the map's six
// parameter groups (xyz, f_dc, f_rest, opacity, scaling, rotation), in one
// launch.
//
// Replaces no Pallas kernel: the JAX package leaves Adam
// (gsdf_slam_tpu/models/optimizer.py::adam_step) to XLA's fusion. Written
// as plain torch ops, the port issued ~118 launches a step, most of them
// elementwise passes over a whole [N, w] tensor with new m, v and
// temporaries, and uploaded its scalars (the step count, the betas, each
// group's learning rate) from pageable host memory, which made the host wait
// for the device about ten times a step. This kernel takes every scalar as a
// launch argument, computed on the host (models/optimizer.py), and updates
// p, m and v in place: no upload, no allocation, no sync.
//
// One grid over all groups: each group's elements are cut into blocks of
// kThreads x 4, and the blocks are laid end to end by a prefix of the
// groups' block counts, so a 1-wide group (opacity) takes as few blocks as
// its own elements need. A thread updates 4 neighbouring elements with
// 16-byte loads and stores where the group's four arrays are 16-byte
// aligned, element by element at the ragged end of a group (counts not a
// multiple of 4) or where they are not.
//
// Numerics: op for op the plain version (models/optimizer.py::
// adam_step_plain), each product, sum, sqrtf and division rounded to
// float32 on its own (the library is built with --fmad=false; sqrtf and '/'
// are IEEE, nvcc's default):
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + ((1 - b2) * g) * g
//   p = p - (lr / bc1 * m) / (sqrtf(v) / sqrt(bc2) + eps)
// with the constants, lr / bc1 and sqrt(bc2) as the host rounds them to
// float32, so the kernel is bit-equal to the plain version run on the card on
// the same scalars. (On the CPU torch's sqrt is not always the correctly
// rounded one, so the CPU's plain steps may differ from the card's in the
// last bit.)
//
// Bound: bytes. Each parameter reads p, g, m and v and writes p, m and v:
// 28 bytes. At 59 parameters a Gaussian (SH degree 3) that is 1.04 GB at
// 0.63M Gaussians, >= 0.31 ms at 3.35 TB/s, and 3.30 GB at 2.0M, >= 0.99
// ms. ~10 float32 operations a parameter are far under the bytes.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxGroups = 6;
constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr long long kPerBlock = (long long)kThreads * kVec;

}  // namespace

// One group as the host passes it (ctypes mirrors this layout in
// models/optimizer.py::_Group).
struct GsdfAdamGroup {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;   // elements
  float lr_bc1;  // lr / bc1, float32
};

namespace {

struct Params {
  GsdfAdamGroup groups[kMaxGroups];
  long long block0[kMaxGroups];  // first block of each group
  int vec[kMaxGroups];           // 1: the group's four arrays are 16-byte aligned
  int n_groups;
  float b1, one_minus_b1, b2, one_minus_b2, eps, sqrt_bc2;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float lr_bc1, const Params& a) {
  m = a.b1 * m + a.one_minus_b1 * g;
  v = a.b2 * v + (a.one_minus_b2 * g) * g;
  const float denom = sqrtf(v) / a.sqrt_bc2 + a.eps;
  p = p - (lr_bc1 * m) / denom;
}

__global__ void __launch_bounds__(kThreads) adam_step_kernel(const Params a) {
  const long long b = blockIdx.x;
  int k = 0;
#pragma unroll
  for (int i = 1; i < kMaxGroups; ++i) {
    if (i < a.n_groups && b >= a.block0[i]) k = i;
  }
  const GsdfAdamGroup& gr = a.groups[k];
  const long long n = gr.n;
  const float lr_bc1 = gr.lr_bc1;
  const long long base = (b - a.block0[k]) * kPerBlock + (long long)threadIdx.x * kVec;
  if (a.vec[k] && base + kVec <= n) {
    float4 p4 = *reinterpret_cast<const float4*>(gr.p + base);
    const float4 g4 = *reinterpret_cast<const float4*>(gr.g + base);
    float4 m4 = *reinterpret_cast<const float4*>(gr.m + base);
    float4 v4 = *reinterpret_cast<const float4*>(gr.v + base);
    update(p4.x, g4.x, m4.x, v4.x, lr_bc1, a);
    update(p4.y, g4.y, m4.y, v4.y, lr_bc1, a);
    update(p4.z, g4.z, m4.z, v4.z, lr_bc1, a);
    update(p4.w, g4.w, m4.w, v4.w, lr_bc1, a);
    *reinterpret_cast<float4*>(gr.p + base) = p4;
    *reinterpret_cast<float4*>(gr.m + base) = m4;
    *reinterpret_cast<float4*>(gr.v + base) = v4;
    return;
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long i = base + j;
    if (i >= n) break;
    float p = gr.p[i], m = gr.m[i], v = gr.v[i];
    update(p, gr.g[i], m, v, lr_bc1, a);
    gr.p[i] = p;
    gr.m[i] = m;
    gr.v[i] = v;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// groups: a host array of n_groups (<= 6) groups, read here and passed to
// the kernel by value (no upload); b1, 1 - b1, b2, 1 - b2, eps and
// sqrt(bc2) as float32. Empty groups take no block; with no element at all
// nothing is launched.
extern "C" int gsdf_adam_step(const GsdfAdamGroup* groups, int n_groups, float b1, float one_minus_b1, float b2,
                              float one_minus_b2, float eps, float sqrt_bc2, void* stream) {
  if (n_groups < 1 || n_groups > kMaxGroups) return (int)cudaErrorInvalidValue;
  Params a{};
  a.n_groups = n_groups;
  a.b1 = b1;
  a.one_minus_b1 = one_minus_b1;
  a.b2 = b2;
  a.one_minus_b2 = one_minus_b2;
  a.eps = eps;
  a.sqrt_bc2 = sqrt_bc2;
  long long blocks = 0;
  for (int k = 0; k < n_groups; ++k) {
    const GsdfAdamGroup& gr = groups[k];
    if (gr.n < 0) return (int)cudaErrorInvalidValue;
    a.groups[k] = gr;
    a.block0[k] = blocks;
    a.vec[k] = aligned16(gr.p) && aligned16(gr.g) && aligned16(gr.m) && aligned16(gr.v);
    blocks += (gr.n + kPerBlock - 1) / kPerBlock;
  }
  // groups past n_groups start after the last block, so no block maps to them
  for (int k = n_groups; k < kMaxGroups; ++k) a.block0[k] = blocks;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  adam_step_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
