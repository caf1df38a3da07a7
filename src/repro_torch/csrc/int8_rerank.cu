// Exact rerank over int8 rows, with the final top-k:
//   s[q, j]  = <Q[q], codes[ids[q, j]]> * scale[ids[q, j]]   where approx[q, j] is finite
//            = -inf                                          elsewhere
//   out[q, r] = the r-th of the (score desc, NaN first, position asc) order, r < k:
//               ids[q, pos] and s[q, pos]; (-1, -inf) for r >= B.
// The dot product runs on the int8 codes (read as they are, widened in
// registers) and is accumulated in f32 on the CUDA cores, then multiplied
// once by the row's scale: no TF32, no f32 copy of the rows.
// Replaces no TPU kernel: the JAX package dequantizes its int8 rerank rows
// into an (n, d) f32 table and reranks with a product (`repro/core/search.py`).
//
// Bound: bytes. A candidate costs d + 4 bytes of row and scale and 8 of id
// and PQ score, against 2d flops: at glove's d = 100 and budget 256 a
// 128-query tile reads 3.7 MB (1.1 us at 3.35 TB/s), 6.6 MFLOP. The rows
// are read at random, one id at a time, so what the kernel pays is
// latency: chains of dependent loads (id, then row and scale). The design
// keeps many rows in flight and never writes the (nq, budget) scores:
// - one block of 16 warps a query; a warp scores 4 candidates side by
//   side, 8 lanes a row, each lane loading up to 4 4-byte words of its row
//   before it sums (d <= 128 in one round), then a 3-step shuffle in the
//   group; the row's scale is loaded with its words;
// - the budget's scores stay in shared memory, and the top k are chosen
//   at once: every thread counts, for its own candidates, the candidates
//   before it in the order, stopping at k; a candidate with r < k before
//   it is rank r. The order is `torch.sort(descending=True, stable=True)`'s,
//   which the plain version (`kernels/ref.py::int8_rerank_ref`) uses.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int IR_THREADS = 512;
constexpr int IR_WARPS = IR_THREADS / 32;
constexpr int IR_GROUP = 8;                      // lanes that score one row
constexpr int IR_ROWS = 32 / IR_GROUP;           // rows a warp scores side by side
constexpr int IR_UNROLL = 4;                     // loads a lane has in flight for its row

// the strict total order of the scores: descending, NaN before every
// number (torch's descending sort), lower position first among equals
__device__ __forceinline__ bool before(float a, int i, float b, int j) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return i < j;
}

__device__ __forceinline__ float dot4(char4 x, const float* q, float acc) {
  acc = fmaf((float)x.x, q[0], acc);
  acc = fmaf((float)x.y, q[1], acc);
  acc = fmaf((float)x.z, q[2], acc);
  return fmaf((float)x.w, q[3], acc);
}

// this lane's share of <q, row>: elements (VEC: 4-byte words) sub, sub + 8, ...
template <bool VEC>
__device__ __forceinline__ float lane_dot(const int8_t* __restrict__ row, const float* q,
                                          int d, int sub) {
  float acc = 0.f;
  if (VEC) {
    const char4* w = reinterpret_cast<const char4*>(row);
    const int nw = d / 4;
    for (int w0 = 0; w0 < nw; w0 += IR_GROUP * IR_UNROLL) {
      char4 v[IR_UNROLL];
#pragma unroll
      for (int u = 0; u < IR_UNROLL; ++u) {
        const int i = w0 + sub + u * IR_GROUP;
        v[u] = i < nw ? __ldg(w + i) : make_char4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < IR_UNROLL; ++u) {
        const int i = w0 + sub + u * IR_GROUP;
        if (i < nw) acc = dot4(v[u], q + 4 * i, acc);
      }
    }
  } else {
    for (int e0 = 0; e0 < d; e0 += IR_GROUP * IR_UNROLL) {
      int8_t v[IR_UNROLL];
#pragma unroll
      for (int u = 0; u < IR_UNROLL; ++u) {
        const int i = e0 + sub + u * IR_GROUP;
        v[u] = i < d ? row[i] : (int8_t)0;
      }
#pragma unroll
      for (int u = 0; u < IR_UNROLL; ++u) {
        const int i = e0 + sub + u * IR_GROUP;
        if (i < d) acc = fmaf((float)v[u], q[i], acc);
      }
    }
  }
  return acc;
}

template <bool VEC>
__global__ void __launch_bounds__(IR_THREADS) int8_rerank_kernel(
    const float* __restrict__ Q, const int8_t* __restrict__ codes,
    const float* __restrict__ scale, const int* __restrict__ ids,
    const float* __restrict__ approx, int B, int d, int k,
    int* __restrict__ out_ids, float* __restrict__ out_scores) {
  extern __shared__ float smem[];
  float* q = smem;                                // the query (d)
  float* s = smem + d;                            // the candidates' scores (B)
  const int row = blockIdx.x;
  const float* Qr = Q + (size_t)row * d;
  const int* rid = ids + (size_t)row * B;
  const float* rap = approx + (size_t)row * B;
  for (int i = threadIdx.x; i < d; i += IR_THREADS) q[i] = Qr[i];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % IR_GROUP;
  for (int j0 = warp * IR_ROWS; j0 < B; j0 += IR_WARPS * IR_ROWS) {
    const int j = j0 + lane / IR_GROUP;           // the same j0 across the warp: shuffles converge
    const bool valid = j < B && isfinite(__ldg(rap + j));
    const int id = valid ? __ldg(rid + j) : 0;
    float acc = 0.f, sc = 0.f;
    if (valid) {
      sc = __ldg(scale + id);
      acc = lane_dot<VEC>(codes + (size_t)id * d, q, d, sub);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (sub == 0 && j < B) s[j] = valid ? acc * sc : -INFINITY;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < B; i += IR_THREADS) {
    const float si = s[i];
    int rank = 0;
    for (int j = 0; j < B && rank < k; ++j) rank += before(s[j], j, si, i);
    if (rank < k) {
      out_ids[(size_t)row * k + rank] = rid[i];
      out_scores[(size_t)row * k + rank] = si;
    }
  }
  for (int r = B + threadIdx.x; r < k; r += IR_THREADS) {
    out_ids[(size_t)row * k + r] = -1;
    out_scores[(size_t)row * k + r] = -INFINITY;
  }
}

template <bool VEC>
static int launch(const float* Q, const int8_t* codes, const float* scale, const int* ids,
                  const float* approx, int nq, int B, int d, int k, int* out_ids,
                  float* out_scores, cudaStream_t stream) {
  const size_t smem = (size_t)(d + B) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_rerank_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int8_rerank_kernel<VEC><<<(unsigned)nq, IR_THREADS, smem, stream>>>(
      Q, codes, scale, ids, approx, B, d, k, out_ids, out_scores);
  return (int)cudaGetLastError();
}

extern "C" int int8_rerank_launch(const float* Q, const int8_t* codes, const float* scale,
                                  const int* ids, const float* approx, int nq, int B, int d,
                                  int k, int vec, int* out_ids, float* out_scores,
                                  cudaStream_t stream) {
  return vec ? launch<true>(Q, codes, scale, ids, approx, nq, B, d, k, out_ids, out_scores, stream)
             : launch<false>(Q, codes, scale, ids, approx, nq, B, d, k, out_ids, out_scores,
                             stream);
}
