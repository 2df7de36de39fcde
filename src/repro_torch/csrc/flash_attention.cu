// Flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of
// src/repro/kernels/flash/flash_attention.py (the `pl.pallas_call` in
// `flash_attention`).  q (B, H, Sq, hd) attends to k, v (B, Kv, Sk, hd) with
// grouped-query heads (query head h reads kv head h / (H / Kv)), under a
// causal mask (j <= i, offset 0: Sq == Sk), a causal sliding window
// (i - window < j <= i) or no mask.  Softmax is the reference's online form
// in f32: m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha =
// exp(m - m_new), l = l * alpha + rowsum(p), acc = acc * alpha + p v, and
// out = acc / max(l, 1e-30).  Masked scores are -1e30 and add p = 0.
//
// Design: one thread block (256 threads) per (64-row q tile, b * H).  The q
// tile stays in shared memory as f32, zero-padded from hd to HDP (64, 128 or
// 256); 32-row k and v tiles are staged through shared memory in turn.
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4): score
// columns tx + 16 j (j < 2) and output columns tx + 16 c (c < HDP / 16);
// row maxima and sums are reduced over the 16 threads of a half-warp with
// shuffles.  Tiles wholly in the future, or wholly older than the window,
// are skipped; a ragged last tile is masked.  Products are f32 fused
// multiply-adds written out with __fmaf_rn (the library is built with
// -fmad=false, which would otherwise split every product from its add).
// Rows of shared memory are padded by one float so that the 16 key rows a
// half-warp reads sit in 16 banks.
//
// What bounds it: operations.  Causal attention over 4 x 2048 tokens with
// 16 heads of 128 is 17 GFLOP against 33 MB of inputs and outputs.  This
// first version reads six shared-memory words per eight FMAs in the score
// loop and so runs far below the card's f32 rate, let alone its tensor-core
// rate; tensor-core tiles (mma.sync / wgmma) fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" {

// Kernel arguments; mirrored field by field by a ctypes.Structure in
// repro_torch/kernels/flash/flash_attention.py (pointers, then strides in
// elements, then the scale, then ints).
struct FlashArgs {
  const void* q;   // (B, H, Sq, hd), innermost stride 1
  const void* k;   // (B, Kv, Sk, hd)
  const void* v;   // (B, Kv, Sk, hd)
  void* o;         // (B, H, Sq, hd), dtype of q
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;     // 1 / sqrt(hd)
  int B, H, Kv, Sq, Sk, hd;
  int causal;
  int window;      // <= 0: no window
  int dtype;       // 0 float32, 1 bfloat16
};

}  // extern "C"

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int HDP>
constexpr int smem_floats() {
  return (kBQ + 2 * kBK) * (HDP + 1) + kBQ * (kBK + 1);
}

// Load rows [r0, r0 + rows) of one head into shared memory as f32, zero
// beyond the sequence and beyond hd.
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int r0, int rows, int n_rows, int hd) {
  constexpr int LD = HDP + 1;
  for (int idx = threadIdx.x; idx < rows * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    float x = 0.f;
    if (r0 + r < n_rows && d < hd) x = to_f32(src[(long long)(r0 + r) * row_stride + d]);
    dst[r * LD + d] = x;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads) flash_kernel(const FlashArgs a) {
  constexpr int LD = HDP + 1;
  constexpr int LP = kBK + 1;
  constexpr int NC = HDP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;              // kBQ x LD
  float* sK = sQ + kBQ * LD;     // kBK x LD
  float* sV = sK + kBK * LD;     // kBK x LD
  float* sP = sV + kBK * LD;     // kBQ x LP

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int kvh = h / (a.H / a.Kv);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<T, HDP>(sQ, q, a.q_ss, q0, kBQ, a.Sq, a.hd);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_k = (a.Sk + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kBK;
    if (a.causal) {
      if (k0 > q0 + kBQ - 1) break;                                 // wholly in the future
      if (a.window > 0 && k0 + kBK - 1 <= q0 - a.window) continue;  // wholly older than the window
    }
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    load_tile<T, HDP>(sK, k, a.k_ss, k0, kBK, a.Sk, a.hd);
    load_tile<T, HDP>(sV, v, a.v_ss, k0, kBK, a.Sk, a.hd);
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[2];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = kj < a.Sk &&
                (!a.causal || (kj <= qi && (a.window <= 0 || kj > qi - a.window)));
        s[i][j] = ok[j] ? s[i][j] * a.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * LP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = sV[t * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = __fmaf_rn(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < a.hd) store(o + (long long)row * a.o_ss + d, acc[i][c] / denom);
    }
  }
}

template <typename T, int HDP>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const int smem = smem_floats<HDP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HDP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_kernel<T, HDP><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const FlashArgs& a, cudaStream_t stream) {
  if (a.hd <= 64) return launch<T, 64>(a, stream);
  if (a.hd <= 128) return launch<T, 128>(a, stream);
  return launch<T, 256>(a, stream);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns a cudaError_t (0 on success).  The wrapper
// has checked shapes (hd <= 256, H % Kv == 0, Sq == Sk when causal) and
// dtypes.
int flash_attention_launch(const FlashArgs* a, void* stream) {
  if (a->hd < 1 || a->hd > 256) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 1 ? launch_hd<__nv_bfloat16>(*a, s) : launch_hd<float>(*a, s);
}

}  // extern "C"
