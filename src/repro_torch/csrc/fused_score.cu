// Fused candidate-scoring kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_fused_kernel` of
// src/repro/core/search/kernels/fused_score.py (the `pl.pallas_call` in
// `_fused_fn`).  For each candidate row p of a (B, T) placement batch it
// computes, in float64:
//   net        sum over edges of net[p[src], p[dst]], plus move_cost[t] for
//              every task placed off its pre-move node;
//   violation  sum over nodes and hard dims of max(used - avail, 0), where
//              used is the demand segment-summed onto nodes;
//   dead       the number of tasks placed on dead nodes;
//   throughput (optional) min(source, cpu, bandwidth, ack) * sink_rate, with
//              local_or_shuffle routing, memory thrash and colocation terms.
//
// Design: one thread block per candidate row.  The per-node, per-rack,
// per-combo and per-component-edge accumulators and the row's placement
// live in dynamic shared memory; scatters are shared-memory fp64 atomics.
// Every summand is a multiple of a dyadic grid (net distances of 0.5,
// rates of 2^-26, latencies of 2^-48), so the sums are exact in any order
// and atomics cannot change a bit.  The elementwise tail is IEEE double
// arithmetic in the reference's order; the library is built with
// -fmad=false so no multiply is contracted into an add.
//
// What bounds it: each block streams the shared edge tables (about 57 bytes
// per task edge: endpoints, validity, bytes, latency classes, comp edge,
// combo key, locality flag) from L2 twice, so the kernel is bound by L2
// traffic that grows with B * E, not by device memory.  Amortizing those
// tables over several candidates per block is left for a later change.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr double kEps = 1e-12;

}  // namespace

extern "C" {

// Kernel arguments; mirrored field by field by a ctypes.Structure in
// fused_score.py (pointers, then doubles, then ints: no padding).
struct FusedArgs {
  const int* P;                 // (B, T) node index per task
  const double* net;            // (N, N) net distance
  const double* avail;          // (N, Dh) hard-column budget
  const double* demand;         // (T, Dh) hard demand per task
  const unsigned char* alive;   // (N,)
  const int* edges;             // (E, 2) task-index pairs
  const double* evalid;         // (E,) 1.0 real edge, 0.0 padding
  const int* move_base;         // (T,) pre-move node
  const double* move_cost;      // (T,) migration penalty
  const double* task_cpu;       // (T,)
  const double* task_mem;       // (T,)
  const double* cpu_cap;        // (N,)
  const double* mem_cap;        // (N,)
  const double* edge_bytes;     // (E,)
  const int* edge_comp;         // (E,)
  const double* edge_lat;       // (3, E) latency class rows
  const double* den_flow;       // (n_ce,)
  const int* rack_of;           // (N,)
  const unsigned char* edge_local;  // (E,)
  const int* pair_key;          // (E,) combo index
  const int* combo_ce;          // (K,)
  const double* local_num;      // (K,)
  const int* ack_tab;           // dp_ci[n_dp], dp_off[n_dp+1], dp_ce[n_pairs], dp_d[n_pairs], spouts[n_spouts]
  const double* svc;            // (n_comp,)
  double* out_net;              // (B,)
  double* out_viol;             // (B,)
  long long* out_dead;          // (B,)
  double* out_tp;               // (B,) or null
  double nic_bw;
  double rack_bw;
  double thrash_factor;
  double source_bound;
  double sink_rate;
  double pending;
  double ack_overhead;
  int B, T, N, Dh, E, R, K, n_ce, n_comp, n_dp, n_pairs, n_spouts;
  int with_tp;
  int acked;
};

}  // extern "C"

namespace {

// Doubles in dynamic shared memory, in this order: used[N*Dh], then with the
// throughput model cpu_load[N], mem_used[N], egress[N], ingress[N],
// rack_up[R], L[K], ack_num[n_ce], path[n_comp]; then the row's P[T] (int).
__host__ __device__ inline long long smem_doubles(const FusedArgs& a) {
  long long n = (long long)a.N * a.Dh;
  if (a.with_tp) n += 4LL * a.N + a.R + a.K + a.n_ce + a.n_comp;
  return n;
}

__device__ inline double dmax(double a, double b) { return b > a ? b : a; }
__device__ inline double dmin(double a, double b) { return b < a ? b : a; }

// capacity_bound's per-entry ratio: max(cap, 0) / use where use > eps.
__device__ inline double ratio(double use, double cap) {
  return use > kEps ? (cap >= 0.0 ? cap : 0.0) / use : INFINITY;
}

__global__ void __launch_bounds__(kThreads) fused_score_kernel(const FusedArgs a) {
  extern __shared__ double smem[];
  __shared__ double red_net[kWarps], red_viol[kWarps], red_lam[kWarps];
  __shared__ long long red_dead[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int N = a.N, T = a.T, Dh = a.Dh, E = a.E;
  const long long nd = smem_doubles(a);

  double* used = smem;
  double* cpu_load = used + (long long)N * Dh;
  double* mem_used = cpu_load + N;
  double* egress = mem_used + N;
  double* ingress = egress + N;
  double* rack_up = ingress + N;
  double* L = rack_up + a.R;
  double* ack_num = L + a.K;
  double* path = ack_num + a.n_ce;
  int* Ps = reinterpret_cast<int*>(smem + nd);

  // Pass 1: zero the accumulators, stage the row.
  for (long long k = tid; k < nd; k += kThreads) smem[k] = 0.0;
  const int* Prow = a.P + (long long)row * T;
  for (int t = tid; t < T; t += kThreads) Ps[t] = Prow[t];
  __syncthreads();

  // Pass 2: tasks — capacity/CPU/memory scatters, dead count, move term.
  double net_acc = 0.0;
  long long dead_acc = 0;
  for (int t = tid; t < T; t += kThreads) {
    const int n = Ps[t];
    for (int d = 0; d < Dh; ++d) {
      const double v = a.demand[(long long)t * Dh + d];
      if (v != 0.0) atomicAdd(&used[(long long)n * Dh + d], v);
    }
    dead_acc += a.alive[n] ? 0 : 1;
    if (n != a.move_base[t]) net_acc += a.move_cost[t];
    if (a.with_tp) {
      atomicAdd(&cpu_load[n], a.task_cpu[t]);
      atomicAdd(&mem_used[n], a.task_mem[t]);
    }
  }

  // Pass 3: edges — netcost, colocation counts per (src task, comp edge).
  for (int e = tid; e < E; e += kThreads) {
    const int s = Ps[a.edges[2 * e]];
    const int d = Ps[a.edges[2 * e + 1]];
    net_acc += a.net[(long long)s * N + d] * a.evalid[e];
    if (a.with_tp && s == d) atomicAdd(&L[a.pair_key[e]], 1.0);
  }
  __syncthreads();

  // Pass 4: edges again (needs the finished L) — locality routing, link
  // flows, hop latencies; then the locally routed combos' ack terms.
  if (a.with_tp) {
    for (int e = tid; e < E; e += kThreads) {
      const int s = Ps[a.edges[2 * e]];
      const int d = Ps[a.edges[2 * e + 1]];
      const bool colo = s == d;
      const bool routed_local = a.edge_local[e] && L[a.pair_key[e]] > 0.0;
      if (routed_local) continue;
      const double eb = a.edge_bytes[e];
      const int rs = a.rack_of[s], rd = a.rack_of[d];
      if (!colo && eb != 0.0) {
        atomicAdd(&egress[s], eb);
        atomicAdd(&ingress[d], eb);
      }
      if (rs != rd && eb != 0.0) atomicAdd(&rack_up[rs], eb);
      const double lat = colo ? a.edge_lat[e] : (rs == rd ? a.edge_lat[E + e] : a.edge_lat[2 * E + e]);
      if (lat != 0.0) atomicAdd(&ack_num[a.edge_comp[e]], lat);
    }
    for (int k = tid; k < a.K; k += kThreads) {
      if (L[k] > 0.0 && a.local_num[k] != 0.0) atomicAdd(&ack_num[a.combo_ce[k]], a.local_num[k]);
    }
  }
  __syncthreads();

  // Pass 5: per-thread partials — overshoot sum and the capacity minima.
  double viol = 0.0;
  for (long long k = tid; k < (long long)N * Dh; k += kThreads) {
    const double over = used[k] - a.avail[k];
    if (over > 0.0) viol += over;
  }
  double lam = INFINITY;
  if (a.with_tp) {
    for (int n = tid; n < N; n += kThreads) {
      const double cap = mem_used[n] > a.mem_cap[n] + 1e-9 ? a.cpu_cap[n] * a.thrash_factor : a.cpu_cap[n];
      lam = dmin(lam, ratio(cpu_load[n], cap));
      lam = dmin(lam, ratio(egress[n], a.nic_bw));
      lam = dmin(lam, ratio(ingress[n], a.nic_bw));
    }
    for (int r = tid; r < a.R; r += kThreads) lam = dmin(lam, ratio(rack_up[r], a.rack_bw));
  }

  // Block reductions (exact: grid-multiple sums, order-free minima).
  for (int off = 16; off > 0; off >>= 1) {
    net_acc += __shfl_down_sync(0xffffffffu, net_acc, off);
    viol += __shfl_down_sync(0xffffffffu, viol, off);
    dead_acc += __shfl_down_sync(0xffffffffu, dead_acc, off);
    lam = dmin(lam, __shfl_down_sync(0xffffffffu, lam, off));
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    red_net[warp] = net_acc;
    red_viol[warp] = viol;
    red_dead[warp] = dead_acc;
    red_lam[warp] = lam;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    net_acc += red_net[w];
    viol += red_viol[w];
    dead_acc += red_dead[w];
    lam = dmin(lam, red_lam[w]);
  }
  a.out_net[row] = net_acc;
  a.out_viol[row] = viol;
  a.out_dead[row] = dead_acc;
  if (!a.with_tp) return;

  // Zero-load ack critical path (AckPlan.dp, reverse topological order).
  double ack = INFINITY;
  if (a.acked) {
    const int* dp_ci = a.ack_tab;
    const int* dp_off = dp_ci + a.n_dp;
    const int* dp_ce = dp_off + a.n_dp + 1;
    const int* dp_d = dp_ce + a.n_pairs;
    const int* spouts = dp_d + a.n_pairs;
    auto hop = [&](int ce) {
      const double den = a.den_flow[ce];
      return den > 0.0 ? ack_num[ce] / den : 0.0;
    };
    const double zero = hop(0) * 0.0;
    for (int k = 0; k < a.n_dp; ++k) {
      double best = zero;
      for (int q = dp_off[k]; q < dp_off[k + 1]; ++q) {
        const int dn = dp_d[q];
        best = dmax(best, (hop(dp_ce[q]) + a.svc[dn]) + path[dn]);
      }
      path[dp_ci[k]] = best;
    }
    double Lp = zero;
    for (int q = 0; q < a.n_spouts; ++q) Lp = dmax(Lp, a.svc[spouts[q]] + path[spouts[q]]);
    ack = a.pending / (Lp + a.ack_overhead);
  }
  lam = dmin(lam, a.source_bound);
  lam = dmin(lam, ack);
  a.out_tp[row] = lam * a.sink_rate;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs (the wrapper checks the card's limit).
long long fused_score_smem_bytes(const FusedArgs* a) {
  return smem_doubles(*a) * (long long)sizeof(double) + (long long)a->T * (long long)sizeof(int);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
int fused_score_launch(const FusedArgs* a, void* stream) {
  const long long smem = fused_score_smem_bytes(a);
  cudaError_t err = cudaFuncSetAttribute(
      fused_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fused_score_kernel<<<a->B, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
