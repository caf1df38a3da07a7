// Two-level centroid route (the TreeRouter probe stage):
//   ss[q, s]      = <Q[q], SC[s]>                      for every super s
//   sup[q, 0..t)  = the t_route best supers, score descending, lowest index on ties
//   out[q, r*cmax + j] = <Q[q], CC[sup[q, r], j]>      id CH[sup[q, r], j]
// with -inf and id -1 where CH < 0 (children-table padding).
// Replaces the Pallas kernel src/repro/kernels/tree_route.py::tree_route_pallas.
//
// Bound: memory at routing shapes. The work is 2*nq*(S + t_route*cmax)*d
// FLOPs against the tables, the queries and the (nq, t_route*cmax) outputs;
// at S ~ sqrt(c) the outputs and the child rows dominate. One block per
// query: q and its S super scores sit in shared memory; warp 0 picks the
// t_route supers by t_route rounds of a lexicographic (value desc, index
// asc) warp argmax over the not-yet-taken supers (no atomics, so the order
// is the reference's); then every warp scores whole child rows read
// straight from global memory (the tables are small and stay L2-resident),
// lanes striding over d with a shuffle reduction, so loads are coalesced.
// The TPU kernel's one-hot MXU gathers and its VMEM-size gate do not carry
// over: the rows are gathered by index, and any S whose scores fit in
// shared memory is taken.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int TR_THREADS = 256;
constexpr int TR_WARPS = TR_THREADS / 32;
constexpr int MAX_SMEM = 232448;  // 227 KB: a block's shared-memory ceiling on sm_90

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(TR_THREADS)
tree_route_kernel(const float* __restrict__ Q, const float* __restrict__ SC,
                  const float* __restrict__ CC, const int* __restrict__ CH, int S, int cmax,
                  int d, int t_route, float* __restrict__ scores, int* __restrict__ ids) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* q = reinterpret_cast<float*>(smem);      // (d,)
  float* ss = q + d;                              // (S,)
  int* sel = reinterpret_cast<int*>(ss + S);      // (t_route,)
  unsigned char* taken = reinterpret_cast<unsigned char*>(sel + t_route);  // (S,)

  const int qi = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qg = Q + (size_t)qi * d;
  for (int e = threadIdx.x; e < d; e += TR_THREADS) q[e] = qg[e];
  for (int s = threadIdx.x; s < S; s += TR_THREADS) taken[s] = 0;
  __syncthreads();

  // super scores: one warp per super row
  for (int s = warp; s < S; s += TR_WARPS) {
    const float* row = SC + (size_t)s * d;
    float acc = 0.f;
    for (int e = lane; e < d; e += 32) acc += q[e] * row[e];
    acc = warp_sum(acc);
    if (lane == 0) ss[s] = acc;
  }
  __syncthreads();

  // t_route rounds of a lexicographic argmax over the untaken supers (warp 0)
  if (warp == 0) {
    for (int r = 0; r < t_route; ++r) {
      float bv = -INFINITY;
      int bi = INT32_MAX;
      for (int s = lane; s < S; s += 32)
        if (!taken[s] && better(ss[s], s, bv, bi)) { bv = ss[s]; bi = s; }
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
      }
      if (lane == 0) {
        if (bi >= S) {  // only NaN scores left untaken: take the lowest such index
          bi = 0;
          while (taken[bi]) ++bi;
        }
        sel[r] = bi;
        taken[bi] = 1;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // child rows of the chosen supers: one warp per row
  const int w = t_route * cmax;
  float* so = scores + (size_t)qi * w;
  int* io = ids + (size_t)qi * w;
  for (int k = warp; k < w; k += TR_WARPS) {
    const int s = sel[k / cmax];
    const int j = k - (k / cmax) * cmax;
    const int cid = CH[(size_t)s * cmax + j];
    float acc = 0.f;
    if (cid >= 0) {  // uniform across the warp
      const float* row = CC + ((size_t)s * cmax + j) * d;
      for (int e = lane; e < d; e += 32) acc += q[e] * row[e];
      acc = warp_sum(acc);
    }
    if (lane == 0) {
      so[k] = cid >= 0 ? acc : -INFINITY;
      io[k] = cid;
    }
  }
}

// Shared memory the kernel needs for S supers, d dims and t_route rounds.
static size_t tree_route_smem(int S, int d, int t_route) {
  return (size_t)(d + S) * sizeof(float) + (size_t)t_route * sizeof(int) + (size_t)S;
}

// Q (nq, d) f32, SC (S, d) f32, CC (S, cmax, d) f32, CH (S, cmax) int32,
// 1 <= t_route <= S -> scores (nq, t_route*cmax) f32, ids (nq, t_route*cmax) int32.
extern "C" int tree_route_launch(const float* Q, const float* SC, const float* CC,
                                 const int* CH, int nq, int S, int cmax, int d, int t_route,
                                 float* scores, int* ids, cudaStream_t stream) {
  const size_t smem = tree_route_smem(S, d, t_route);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tree_route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tree_route_kernel<<<nq, TR_THREADS, smem, stream>>>(Q, SC, CC, CH, S, cmax, d, t_route,
                                                      scores, ids);
  return (int)cudaGetLastError();
}
