// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel `_rglru_kernel` of
// src/repro/kernels/rglru/rglru_scan.py (the `pl.pallas_call` in
// `rglru_scan`): h[b, t, d] = a[b, t, d] * h[b, t - 1, d] + x[b, t, d] from
// h[b, -1, d] = h0[b, d], with a and x (B, S, D) in float32 or bfloat16, h0
// (B, D) in float32, the recurrence in float32 and h written in x's dtype.
// The TPU version runs a doubling scan inside each 256-step time block in
// VMEM and chains blocks through a carry on its sequential grid axis.  Here
// blocks run in no order, so one block owns 32 channels of one batch row and
// walks the whole sequence itself, carrying h in registers from one time
// tile to the next.  Any S (1 included) and any D: loads past either edge
// read the identity (a = 1, x = 0) and their stores are skipped.
//
// A block has 8 warps; lane c owns channel d = 32 * blockIdx.x + c and warp
// j owns steps [16 j, 16 j + 16) of each 128-step tile.  Per tile each
// thread
//   1. loads its 16 a and 16 x into registers, all 32 loads issued before
//      any is used (a warp's load is one 128-byte row segment);
//   2. folds them into the chunk's (prod a, h from 0) and writes the pair to
//      shared memory (double-buffered, so one barrier a tile suffices);
//   3. after the barrier, folds the 8 chunks' pairs in order from the
//      block's carry: the value before its own chunk is its carry-in, the
//      value after the last chunk the next tile's carry;
//   4. reruns h = a * h + x over its 16 steps from the carry-in and stores h.
// Step 4 is the plain version's sequential arithmetic; only the carry-in
// composes chunks in another order (step 3), so the kernel and the plain
// version agree to rounding, not bit for bit.  Products and sums are written
// as __fmul_rn / __fadd_rn, separately rounded as the plain version's are.
//
// What bounds it: bytes.  a and x are read once and h written once, 12 bytes
// a step and channel in float32: recurrentgemma-9b's (4, 2048, 4096) is
// 402.7 MB, 0.120 ms at 3.35 TB/s; its few operations a step do not matter.
// At that shape the grid is 128 x 4 blocks of 256 threads; at about 90
// registers a thread two blocks fit an SM, so they run in about two waves,
// each block with 32 KB of loads in flight per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" {

// Kernel arguments; mirrored field by field by a ctypes.Structure in
// repro_torch/kernels/rglru/rglru_scan.py (pointers, then ints).
struct RglruArgs {
  const void* a;    // (B, S, D), contiguous
  const void* x;    // (B, S, D), contiguous, dtype of a
  const float* h0;  // (B, D), contiguous, float32
  void* h;          // (B, S, D), contiguous, dtype of x
  int B, S, D;
  int dtype;        // 0 float32, 1 bfloat16
};

}  // extern "C"

namespace {

constexpr int kLanes = 32;   // channels per block
constexpr int kWarps = 8;    // time chunks per tile
constexpr int kSteps = 16;   // steps per chunk
constexpr int kTile = kWarps * kSteps;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kLanes * kWarps) rglru_scan_kernel(RglruArgs args) {
  __shared__ float s_prod[2][kWarps][kLanes];
  __shared__ float s_h[2][kWarps][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kLanes + lane;
  const bool valid = d < args.D;
  const long long row = (long long)args.D;
  const long long base = (long long)b * args.S * row + d;
  const T* __restrict__ a = static_cast<const T*>(args.a) + base;
  const T* __restrict__ x = static_cast<const T*>(args.x) + base;
  T* __restrict__ out = static_cast<T*>(args.h) + base;

  float carry = valid ? args.h0[(long long)b * args.D + d] : 0.f;
  int buf = 0;
  for (int t0 = 0; t0 < args.S; t0 += kTile, buf ^= 1) {
    const int first = t0 + warp * kSteps;
    float av[kSteps], xv[kSteps];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const int t = first + i;
      const bool in = valid && t < args.S;
      av[i] = in ? load(a + t * row) : 1.f;
      xv[i] = in ? load(x + t * row) : 0.f;
    }
    float prod = 1.f, h = 0.f;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), xv[i]);
      prod = __fmul_rn(prod, av[i]);
    }
    s_prod[buf][warp][lane] = prod;
    s_h[buf][warp][lane] = h;
    __syncthreads();

    float carry_in = carry;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
      if (j == warp) carry_in = carry;
      carry = __fadd_rn(__fmul_rn(s_prod[buf][j][lane], carry), s_h[buf][j][lane]);
    }

    h = carry_in;
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      h = __fadd_rn(__fmul_rn(av[i], h), xv[i]);
      const int t = first + i;
      if (valid && t < args.S) store(out + t * row, h);
    }
  }
}

template <typename T>
int launch(const RglruArgs& a, cudaStream_t stream) {
  const dim3 grid((a.D + kLanes - 1) / kLanes, a.B);
  rglru_scan_kernel<T><<<grid, kLanes * kWarps, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success).  The wrapper has
// checked shapes (B <= 65535, S >= 1, D >= 1) and dtypes.
int rglru_scan_launch(const RglruArgs* a, void* stream) {
  if (a->B < 1 || a->B > 65535 || a->S < 1 || a->D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 1 ? launch<__nv_bfloat16>(*a, s) : launch<float>(*a, s);
}

}  // extern "C"
