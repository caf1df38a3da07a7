// Two-level centroid route (the TreeRouter probe stage):
//   ss[q, s]      = <Q[q], SC[s]>                      for every super s
//   sup[q, 0..t)  = the t_route best supers, score descending, lowest index on ties
//   out[q, r*cmax + j] = <Q[q], CC[sup[q, r], j]>      id CH[sup[q, r], j]
// with -inf and id -1 where CH < 0 (children-table padding).
// Replaces the Pallas kernel src/repro/kernels/tree_route.py::tree_route_pallas.
//
// Bound: the outputs and the child rows at routing shapes (S ~ sqrt(c)),
// far below any time the card can resolve (0.5 us at c = 2,000): what the
// kernel pays is latency, the chain of dependent round trips each block
// makes to L2 or device memory, and at larger S the selection. So the
// design keeps many loads in flight and selects with the whole block:
// - one block of 16 warps per query; its warps score all S supers, then
//   all t_route * cmax child rows of the chosen supers, round after round;
// - rows are scored by groups of 8 lanes (a warp takes 4 rows at a time),
//   each lane loading float4 chunks of 4 such rows at once (16 rows a
//   warp, 256 a block) before any sum, then a 3-step shuffle within the
//   group: where a row-at-a-time loop had one load in flight, a warp has
//   sixteen;
// - the t_route supers are selected at once: every thread counts, for its
//   own supers, the supers before it in the order (score desc, NaN last,
//   index asc), stopping at t_route; a super with r < t_route before it
//   is round r's. The order is jax.lax.top_k's, with no serial rounds;
// - child rows are read whether or not they are padding (the table holds
//   them), so a row's id and its values arrive in one round trip; the
//   padding is masked when the scores are written, coalesced along k.
// The TPU kernel's one-hot MXU gathers and its VMEM-size gate do not carry
// over: rows are gathered by index, and any S whose scores fit in shared
// memory is taken.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int TR_THREADS = 512;
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int TR_GROUP = 8;                      // lanes that score one row
constexpr int TR_ROWS = 32 / TR_GROUP;           // rows a warp scores side by side
constexpr int TR_UNROLL = 4;                     // ... times this, loads in flight
constexpr int TR_PER_WARP = TR_ROWS * TR_UNROLL;
constexpr int TR_CHUNKS = 4;                     // vector chunks a lane loads per row and step

// the supers' strict total order: score descending, NaN after every number,
// lowest index first among equal scores and among NaNs
__device__ __forceinline__ bool before(float a, int i, float b, int j) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return nb;
  if (!na && a != b) return a > b;
  return i < j;
}

__device__ __forceinline__ float fma_dot(float4 a, float4 b, float acc) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc))));
}
__device__ __forceinline__ float fma_dot(float a, float b, float acc) { return fmaf(a, b, acc); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// acc[u] = this lane's share of <q, rows[u]> (chunks sub, sub + 8, ...); a
// null row adds nothing. All loads of a step are issued before its sums.
template <typename T>
__device__ __forceinline__ void dot_rows(const T* q, const T* (&rows)[TR_UNROLL], int dv,
                                         int sub, float (&acc)[TR_UNROLL]) {
  for (int e0 = sub; e0 < dv; e0 += TR_GROUP * TR_CHUNKS) {
    T v[TR_UNROLL][TR_CHUNKS];
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u)
#pragma unroll
      for (int k = 0; k < TR_CHUNKS; ++k) {
        const int e = e0 + TR_GROUP * k;
        v[u][k] = rows[u] != nullptr && e < dv ? __ldg(rows[u] + e) : zero<T>();
      }
#pragma unroll
    for (int k = 0; k < TR_CHUNKS; ++k) {
      const int e = e0 + TR_GROUP * k;
      if (e < dv) {
        const T qq = q[e];
#pragma unroll
        for (int u = 0; u < TR_UNROLL; ++u) acc[u] = fma_dot(qq, v[u][k], acc[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < TR_UNROLL; ++u)
    for (int o = TR_GROUP / 2; o > 0; o >>= 1) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
}

// T = float4 when d % 4 == 0 and every row is 16-byte aligned, else float
template <typename T>
__global__ void __launch_bounds__(TR_THREADS)
tree_route_kernel(const float* __restrict__ Q, const float* __restrict__ SC,
                  const float* __restrict__ CC, const int* __restrict__ CH, int S, int cmax,
                  int d, int t_route, float* __restrict__ scores, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = sizeof(T) / sizeof(float);
  const int dv = d / V;
  T* q = reinterpret_cast<T*>(smem);                                       // (dv,)
  float* ss = reinterpret_cast<float*>(smem + (size_t)d * sizeof(float));  // (S,)
  int* sel = reinterpret_cast<int*>(ss + S);                               // (t_route,)

  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane % TR_GROUP, grp = lane / TR_GROUP;
  const T* qg = reinterpret_cast<const T*>(Q + (size_t)qi * d);
  for (int e = tid; e < dv; e += TR_THREADS) q[e] = qg[e];
  __syncthreads();

  // 1. every super's score; rows base + u * 4 + grp of a warp's 16
  for (int base = warp * TR_PER_WARP; base < S; base += TR_WARPS * TR_PER_WARP) {
    const T* rows[TR_UNROLL];
    float acc[TR_UNROLL];
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      const int s = base + u * TR_ROWS + grp;
      rows[u] = s < S ? reinterpret_cast<const T*>(SC + (size_t)s * d) : nullptr;
      acc[u] = 0.f;
    }
    dot_rows<T>(q, rows, dv, sub, acc);
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      const int s = base + u * TR_ROWS + grp;
      if (sub == 0 && s < S) ss[s] = acc[u];
    }
  }
  __syncthreads();

  // 2. the t_route best supers: super s goes to round r when exactly r
  //    supers come before it (a count stops once it reaches t_route)
  for (int s = tid; s < S; s += TR_THREADS) {
    const float v = ss[s];
    int n_before = 0;
    for (int o = 0; o < S && n_before < t_route; ++o) n_before += before(ss[o], o, v, s);
    if (n_before < t_route) sel[n_before] = s;
  }
  __syncthreads();

  // 3. the chosen supers' child rows, round by round, padding included
  //    (masked on the way out); output slot k = r * cmax + j
  const int w = t_route * cmax;
  float* so = scores + (size_t)qi * w;
  int* io = ids + (size_t)qi * w;
  for (int base = warp * TR_PER_WARP; base < w; base += TR_WARPS * TR_PER_WARP) {
    const T* rows[TR_UNROLL];
    float acc[TR_UNROLL];
    int cid[TR_UNROLL];
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      const int k = base + u * TR_ROWS + grp;
      const int r = k / cmax;
      const size_t row = k < w ? (size_t)sel[r] * cmax + (k - r * cmax) : 0;
      rows[u] = k < w ? reinterpret_cast<const T*>(CC + row * d) : nullptr;
      cid[u] = k < w && sub == 0 ? __ldg(CH + row) : -1;
      acc[u] = 0.f;
    }
    dot_rows<T>(q, rows, dv, sub, acc);
#pragma unroll
    for (int u = 0; u < TR_UNROLL; ++u) {
      const int k = base + u * TR_ROWS + grp;
      if (sub == 0 && k < w) {
        so[k] = cid[u] >= 0 ? acc[u] : -INFINITY;
        io[k] = cid[u];
      }
    }
  }
}

// Q (nq, d) f32, SC (S, d) f32, CC (S, cmax, d) f32, CH (S, cmax) int32,
// 1 <= t_route <= S, vec = 1 when d % 4 == 0 and Q, SC, CC are 16-byte
// aligned -> scores (nq, t_route*cmax) f32, ids (nq, t_route*cmax) int32.
// Shared memory: d + S + t_route words.
extern "C" int tree_route_launch(const float* Q, const float* SC, const float* CC,
                                 const int* CH, int nq, int S, int cmax, int d, int t_route,
                                 int vec, float* scores, int* ids, cudaStream_t stream) {
  const size_t smem = (size_t)(d + S + t_route) * sizeof(float);
  const unsigned blocks = (unsigned)nq;
  if (vec) {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          tree_route_kernel<float4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    tree_route_kernel<float4><<<blocks, TR_THREADS, smem, stream>>>(Q, SC, CC, CH, S, cmax, d,
                                                                    t_route, scores, ids);
  } else {
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          tree_route_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    tree_route_kernel<float><<<blocks, TR_THREADS, smem, stream>>>(Q, SC, CC, CH, S, cmax, d,
                                                                   t_route, scores, ids);
  }
  return (int)cudaGetLastError();
}
