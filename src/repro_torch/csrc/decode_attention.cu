// Single-token decode attention (split-K flash decoding) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of
// src/repro/kernels/decode_attn/decode_attention.py (the `pl.pallas_call` in
// `decode_attention`).  One query token per head, q (B, H, hd), attends to
// the first `length` rows of a KV cache k, v (B, Kv, S, hd), with query
// head h reading kv head h / (H / Kv).  Softmax is the reference's online
// form in f32, out = acc / max(l, 1e-30).
//
// Design.  The TPU kernel walks the cache in order and merges in scratch;
// here the cache rows are cut into n_split contiguous splits that run in
// parallel, and a second kernel merges them.
//   decode_partial_kernel: one thread block of kWarps warps per
//     (group of kWarps splits, b * Kv); each warp owns one split.  The warp
//     holds the G query heads of its kv group in registers (lane owns
//     columns lane + 32 i), walks its rows below `length` four at a time
//     (eight coalesced row loads in flight), reduces each score over the
//     warp with shuffles and keeps one online softmax (m, l, acc) per head.
//     It writes its partial (m, l, acc) in f32 to a workspace; a split
//     wholly past `length` writes m = -1e30, l = 0, acc = 0.
//   decode_combine_kernel: one block per (b, h) rescales the partials by
//     exp(m_s - max m) and divides by the rescaled sum of l.
// `length` is read on the device when a pointer is given, so the caller
// needs no host sync; it is clamped to S.  A length below 1 gives zeros.
//
// What bounds it: bytes.  Each K and V row below `length` is read once
// (2 * B * Kv * length * hd elements); the workspace adds
// n_split * B * H * (hd + 2) floats written and read once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

extern "C" {

// Kernel arguments; mirrored field by field by a ctypes.Structure in
// repro_torch/kernels/decode_attn/decode_attention.py (pointers, then
// strides in elements, then the scale, then ints).
struct DecodeArgs {
  const void* q;          // (B, H, hd), innermost stride 1
  const void* k;          // (B, Kv, S, hd)
  const void* v;          // (B, Kv, S, hd)
  const int* length_ptr;  // device scalar, or null to use `length`
  float* part_m;          // (n_split, B, H)
  float* part_l;          // (n_split, B, H)
  float* part_acc;        // (n_split, B, H, hd)
  void* o;                // (B, H, hd), dtype of q
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  float scale;            // 1 / sqrt(hd)
  int B, H, Kv, S, hd;
  int length;
  int n_split, split_rows;
  int dtype;              // 0 float32, 1 bfloat16
};

}  // extern "C"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;  // cache rows a warp loads per step
constexpr int kMaxSplit = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int valid_length(const DecodeArgs& a) {
  const int len = a.length_ptr ? *a.length_ptr : a.length;
  return len < a.S ? len : a.S;
}

template <typename T, int HDP, int MAXG>
__global__ void __launch_bounds__(kWarps * 32) decode_partial_kernel(const DecodeArgs a) {
  constexpr int NV = HDP / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int split = blockIdx.x * kWarps + warp;
  if (split >= a.n_split) return;
  const int G = a.H / a.Kv;
  const int b = blockIdx.y / a.Kv, kvh = blockIdx.y % a.Kv;
  const int len = valid_length(a);
  const int t0 = split * a.split_rows;
  const int t1 = min(t0 + a.split_rows, len);

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (long long)kvh * G * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  float qr[MAXG][NV], acc[MAXG][NV], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      qr[g][i] = (g < G && d < a.hd) ? to_f32(q[g * a.q_sh + d]) : 0.f;
      acc[g][i] = 0.f;
    }
  }

  for (int t = t0; t < t1; t += kRows) {
    float kr[kRows][NV], vr[kRows][NV];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int d = lane + 32 * i;
        const bool in = t + u < t1 && d < a.hd;
        kr[u][i] = in ? to_f32(k[(long long)(t + u) * a.k_ss + d]) : 0.f;
        vr[u][i] = in ? to_f32(v[(long long)(t + u) * a.v_ss + d]) : 0.f;
      }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (t + u >= t1) break;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) s = __fmaf_rn(qr[g][i], kr[u][i], s);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        s *= a.scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int i = 0; i < NV; ++i) acc[g][i] = __fmaf_rn(p, vr[u][i], acc[g][i] * alpha);
      }
    }
  }

  const long long BH = (long long)a.B * a.H;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    const long long row = split * BH + (long long)b * a.H + kvh * G + g;
    if (lane == 0) {
      a.part_m[row] = m[g];
      a.part_l[row] = l[g];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int d = lane + 32 * i;
      if (d < a.hd) a.part_acc[row * a.hd + d] = acc[g][i];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(128) decode_combine_kernel(const DecodeArgs a) {
  __shared__ float w[kMaxSplit];
  __shared__ float total;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh % a.H;
  const long long BH = (long long)a.B * a.H;
  if (threadIdx.x < 32) {  // warp 0: weights exp(m_s - max m) and the total
    const int lane = threadIdx.x;
    float mx = kNegInf;
    for (int s = lane; s < a.n_split; s += 32) mx = fmaxf(mx, a.part_m[s * BH + bh]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int s = lane; s < a.n_split; s += 32) {
      w[s] = expf(a.part_m[s * BH + bh] - mx);
      sum += a.part_l[s * BH + bh] * w[s];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) total = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
  for (int d = threadIdx.x; d < a.hd; d += blockDim.x) {
    float x = 0.f;
    for (int s = 0; s < a.n_split; ++s) x = __fmaf_rn(a.part_acc[(s * BH + bh) * a.hd + d], w[s], x);
    store(o + d, x / total);
  }
}

template <typename T, int HDP, int MAXG>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const dim3 grid((a.n_split + kWarps - 1) / kWarps, a.B * a.Kv);
  decode_partial_kernel<T, HDP, MAXG><<<grid, kWarps * 32, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T><<<a.B * a.H, 128, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int HDP>
int launch_g(const DecodeArgs& a, cudaStream_t stream) {
  const int G = a.H / a.Kv;
  if (G <= 1) return launch<T, HDP, 1>(a, stream);
  if (G <= 2) return launch<T, HDP, 2>(a, stream);
  if (G <= 4) return launch<T, HDP, 4>(a, stream);
  if (G <= 8) return launch<T, HDP, 8>(a, stream);
  return launch<T, HDP, 16>(a, stream);
}

template <typename T>
int launch_hd(const DecodeArgs& a, cudaStream_t stream) {
  if (a.hd <= 64) return launch_g<T, 64>(a, stream);
  if (a.hd <= 128) return launch_g<T, 128>(a, stream);
  return launch_g<T, 256>(a, stream);
}

}  // namespace

extern "C" {

// Launch both kernels on `stream`; returns a cudaError_t (0 on success).
// The wrapper has checked shapes (hd <= 256, G = H / Kv <= 16,
// n_split <= 256) and dtypes.
int decode_attention_launch(const DecodeArgs* a, void* stream) {
  if (a->hd < 1 || a->hd > 256 || a->H / a->Kv > 16 || a->n_split < 1 ||
      a->n_split > kMaxSplit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a->dtype == 1 ? launch_hd<__nv_bfloat16>(*a, s) : launch_hd<float>(*a, s);
}

}  // extern "C"
