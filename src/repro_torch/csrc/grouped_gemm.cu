// Grouped expert GEMM for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gg_kernel` of
// src/repro/kernels/moe_gemm/grouped_gemm.py (the `pl.pallas_call` in
// `grouped_gemm`): y[e] = x[e] @ w[e] for every expert e, with x (E, C, D),
// w (E, D, F) and y (E, C, F), all contiguous, sums over D in f32 and the
// output in x's dtype.  The TPU version walks D as the innermost sequential
// grid axis with the sum in VMEM scratch; here blocks run in no order, so one
// block owns one output tile and walks all of D in a loop, the sum in
// registers.  Any C, D and F: ragged tiles are zero-filled on load and masked
// on store (the reference asserts divisibility; the port's decode has C = 8).
//
// bf16 path: grid (ceil(F / BN), ceil(C / BM), E).  A block of 128 x 128
// (four warps, each 64 x 64: 4 x 4 wmma fragments of 16 x 16 x 16, bf16
// inputs, f32 accumulators) where C > 16, as at prefill; a block of 16 x 128
// (four warps of 16 x 32) where C <= 16, as at decode.  k tiles of 32 of x
// and w go through a ring of four stages in shared memory, filled by
// cp.async 16-byte copies (zero-filled past the edge) so that three tiles
// are in flight while the tensor cores work on the fourth; rows whose length
// is not a multiple of 8 are loaded element by element instead.  The
// epilogue goes through a 16 x 16 f32 scratch per warp to mask the ragged
// edge and round to bf16.
//
// f32 path: grid (ceil(F / 64), ceil(C / 64), E), 256 threads, each owning
// a 4 x 4 set of outputs (rows ty + 16 i, columns tx + 16 j); 64 x 16 tiles
// of x and 16 x 64 tiles of w in shared memory; products written out with
// __fmaf_rn (the library is built with -fmad=false, which would otherwise
// split every product from its add).
//
// What bounds it: operations at the prefill shapes (olmoe-1b-7b at 4 x 2048
// tokens: (64, 1280, 2048) @ (64, 2048, 1024), 344 GFLOP against 0.7 GB, so
// 0.35 ms at 989 TFLOP/s), bytes at decode (C = 8: the 268 MB of expert
// weights per call, 0.08 ms at 3.35 TB/s).  This version uses mma.sync-class
// tensor-core fragments (wmma), far below the bf16 peak at prefill, where
// other tile shapes, k depths and ring depths did no better; wgmma fed by
// TMA and warp specialization are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

extern "C" {

// Kernel arguments; mirrored field by field by a ctypes.Structure in
// repro_torch/kernels/moe_gemm/grouped_gemm.py (pointers, then ints).
struct GroupedGemmArgs {
  const void* x;  // (E, C, D), contiguous
  const void* w;  // (E, D, F), contiguous
  void* y;        // (E, C, F), contiguous, dtype of x
  int E, C, D, F;
  int dtype;      // 0 float32, 1 bfloat16
};

}  // extern "C"

namespace {

using namespace nvcuda;

// -- bf16 tensor-core path ------------------------------------------------------
constexpr int kBK = 32;
constexpr int kStages = 4;

// A block of WM x WN warps, each owning FM x FN wmma fragments of 16 x 16:
// a BM x BN output tile, k tiles of 32 in a ring of kStages.
template <int WM, int WN, int FM, int FN, int MIN_BLOCKS>
struct Tile {
  static constexpr int kWM = WM, kWN = WN, kFM = FM, kFN = FN, kMinBlocks = MIN_BLOCKS;
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int BM = WM * FM * 16, BN = WN * FN * 16;
  static constexpr int LDA = kBK + 8;  // padded rows: 80 bytes, a multiple of 16
  static constexpr int LDB = BN + 8;   // BN * 2 + 16 bytes
  static constexpr int StageX = BM * LDA, StageW = kBK * LDB;  // elements
  static constexpr int SmemBytes = kStages * (StageX + StageW) * 2;
  static_assert(WM * WN * 1024 <= SmemBytes, "the epilogue's scratch fits in the ring");
};

union Pack8 {
  uint4 u;
  unsigned short s[8];
};

// 16 bytes from device memory into shared memory without passing through
// registers; with src_bytes = 0 the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Eight consecutive bf16 values of a row at `col` into shared memory, zero
// at and beyond `n` or when the row is out of range.  With `vec` (row length
// a multiple of 8, 16-byte aligned rows) an asynchronous 16-byte copy, else
// element by element.
__device__ __forceinline__ void load8(unsigned short* dst, const unsigned short* base, long long row_off,
                                      bool row_ok, int col, int n, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < n;  // n % 8 == 0: a chunk is wholly in or wholly out
    cp_async16(dst, ok ? base + row_off + col : base, ok ? 16 : 0);
  } else {
    Pack8 p;
#pragma unroll
    for (int j = 0; j < 8; ++j) p.s[j] = row_ok && col + j < n ? base[row_off + col + j] : (unsigned short)0;
    *reinterpret_cast<uint4*>(dst) = p.u;
  }
}

// One stage: rows [c0, c0 + BM) x columns [k0, k0 + 32) of x and rows
// [k0, k0 + 32) x columns [n0, n0 + BN) of w, in chunks of 8 elements.
template <class T>
__device__ __forceinline__ void load_stage(unsigned short* sx, unsigned short* sw,
                                           const unsigned short* x, const unsigned short* w,
                                           int C, int D, int F, int c0, int n0, int k0,
                                           bool vec_x, bool vec_w) {
  constexpr int kChunksX = T::BM * kBK / 8, kChunksW = kBK * T::BN / 8;
#pragma unroll
  for (int chunk = threadIdx.x; chunk < kChunksX; chunk += T::kThreads) {
    const int r = chunk / (kBK / 8), c = (chunk % (kBK / 8)) * 8;
    load8(sx + r * T::LDA + c, x, (long long)(c0 + r) * D, c0 + r < C, k0 + c, D, vec_x);
  }
#pragma unroll
  for (int chunk = threadIdx.x; chunk < kChunksW; chunk += T::kThreads) {
    const int r = chunk / (T::BN / 8), c = (chunk % (T::BN / 8)) * 8;
    load8(sw + r * T::LDB + c, w, (long long)(k0 + r) * F, k0 + r < D, n0 + c, F, vec_w);
  }
}

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gg_bf16_kernel(const __nv_bfloat16* __restrict__ x_all, const __nv_bfloat16* __restrict__ w_all,
               __nv_bfloat16* __restrict__ y_all, int C, int D, int F, bool vec_x, bool vec_w) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(smem);  // kStages x (BM x LDA)
  __nv_bfloat16* sw = sx + kStages * T::StageX;                // kStages x (32 x LDB)

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * T::BN, c0 = blockIdx.y * T::BM;
  const unsigned short* x = reinterpret_cast<const unsigned short*>(x_all) + (long long)e * C * D;
  const unsigned short* w = reinterpret_cast<const unsigned short*>(w_all) + (long long)e * D * F;
  __nv_bfloat16* y = y_all + (long long)e * C * F;
  auto load = [&](int kt) {
    const int s = kt % kStages;
    load_stage<T>(reinterpret_cast<unsigned short*>(sx + s * T::StageX),
                  reinterpret_cast<unsigned short*>(sw + s * T::StageW), x, w, C, D, F, c0, n0,
                  kt * kBK, vec_x, vec_w);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::kWN, wn = warp % T::kWN;  // warp tile rows wm * FM * 16, columns wn * FN * 16

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFM][T::kFN];
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // A ring of kStages k tiles: kStages - 1 in flight while one is multiplied.
  const int n_k = (D + kBK - 1) / kBK;
#pragma unroll
  for (int kt = 0; kt < kStages - 1; ++kt) {
    if (kt < n_k) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and tile kt - 1 is no longer read
    if (kt + kStages - 1 < n_k) load(kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* tx = sx + (kt % kStages) * T::StageX + wm * T::kFM * 16 * T::LDA;
    const __nv_bfloat16* tw = sw + (kt % kStages) * T::StageW + wn * T::kFN * 16;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[T::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[T::kFN];
#pragma unroll
      for (int i = 0; i < T::kFM; ++i) wmma::load_matrix_sync(a[i], tx + i * 16 * T::LDA + kk, T::LDA);
#pragma unroll
      for (int j = 0; j < T::kFN; ++j) wmma::load_matrix_sync(b[j], tw + kk * T::LDB + j * 16, T::LDB);
#pragma unroll
      for (int i = 0; i < T::kFM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFN; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: its first kilobytes become the epilogue's scratch

  float* sc = reinterpret_cast<float*>(smem) + warp * 256;
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kFN; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int row = c0 + (wm * T::kFM + i) * 16 + r;
      const int col = n0 + (wn * T::kFN + j) * 16 + c;
      if (row < C) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (col + q < F) y[(long long)row * F + col + q] = __float2bfloat16(sc[r * 16 + c + q]);
      }
      __syncwarp();
    }
  }
}

template <class T>
int launch_bf16(const GroupedGemmArgs* a, cudaStream_t s) {
  const dim3 grid((a->F + T::BN - 1) / T::BN, (a->C + T::BM - 1) / T::BM, a->E);
  // 16-byte copies need every row to start on a 16-byte boundary.
  const bool vec_x = a->D % 8 == 0 && (reinterpret_cast<uintptr_t>(a->x) & 15) == 0;
  const bool vec_w = a->F % 8 == 0 && (reinterpret_cast<uintptr_t>(a->w) & 15) == 0;
  const cudaError_t err = cudaFuncSetAttribute(gg_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               T::SmemBytes);
  if (err != cudaSuccess) return (int)err;
  gg_bf16_kernel<T><<<grid, T::kThreads, T::SmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(a->x), static_cast<const __nv_bfloat16*>(a->w),
      static_cast<__nv_bfloat16*>(a->y), a->C, a->D, a->F, vec_x, vec_w);
  return (int)cudaGetLastError();
}

// 128 x 128 tiles of four warps of 64 x 64 where C is large (prefill); one
// row tile of 16 for C <= 16 (decode), where a 128-row tile would spend its
// copies and products on padding and give the card four times fewer blocks
// to stream the weights with.
using LargeTile = Tile<2, 2, 4, 4, 2>;
using SmallTile = Tile<1, 4, 1, 2, 4>;

// -- f32 FMA path -------------------------------------------------------------------
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gg_f32_kernel(const float* __restrict__ x_all, const float* __restrict__ w_all,
              float* __restrict__ y_all, int C, int D, int F) {
  __shared__ float sx[kFK][kFM + 4];  // transposed: sx[k][row]
  __shared__ float sw[kFK][kFN + 4];

  const int e = blockIdx.z;
  const int n0 = blockIdx.x * kFN, c0 = blockIdx.y * kFM;
  const float* x = x_all + (long long)e * C * D;
  const float* w = w_all + (long long)e * D * F;
  float* y = y_all + (long long)e * C * F;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kFK) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int idx = threadIdx.x + q * kThreads;
      const int xr = idx / kFK, xk = idx % kFK;  // x: 16 consecutive k of one row
      sx[xk][xr] = (c0 + xr < C && k0 + xk < D) ? x[(long long)(c0 + xr) * D + k0 + xk] : 0.f;
      const int wk = idx / kFN, wc = idx % kFN;  // w: 64 consecutive columns of one k
      sw[wk][wc] = (k0 + wk < D && n0 + wc < F) ? w[(long long)(k0 + wk) * F + n0 + wc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sx[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sw[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < F) y[(long long)row * F + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success).  The wrapper has
// checked shapes, dtypes and contiguity; E and the tile counts fit the grid.
int grouped_gemm_launch(const GroupedGemmArgs* a, void* stream) {
  if (a->E < 0 || a->C < 0 || a->D < 0 || a->F < 0) return (int)cudaErrorInvalidValue;
  if (a->E == 0 || a->C == 0 || a->F == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->dtype == 1) return a->C <= SmallTile::BM ? launch_bf16<SmallTile>(a, s) : launch_bf16<LargeTile>(a, s);
  const dim3 grid((a->F + kFN - 1) / kFN, (a->C + kFM - 1) / kFM, a->E);
  gg_f32_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(a->x), static_cast<const float*>(a->w),
                                          static_cast<float*>(a->y), a->C, a->D, a->F);
  return (int)cudaGetLastError();
}

}  // extern "C"
