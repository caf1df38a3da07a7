// Shared tile loop of the nearest-centroid kernels (vq_assign, soar_assign,
// lloyd): one block owns BM rows of X and walks every centroid tile.
//
// Per (row i, centroid j) the score is the reassociated one-GEMM form
//     ||c_j||^2 - 2 <x_i, c_j>
// and, for the SOAR spill (Theorem 3.1 of the paper),
//     + lam * (<rhat_i, x_i> - <rhat_i, c_j>)^2   with j = primary(i) excluded.
// ||x_i||^2 is constant in j and added to the winning value only.
//
// Both X (and R-hat) and the centroid tile are staged in shared memory BK
// columns at a time; every thread accumulates a TM x TC micro-tile with
// plain f32 FMAs (no TF32, no tensor cores). Centroid norms are accumulated
// from the same staged tile, so the kernels need no scratch buffers.
//
// Ties: every (value, index) comparison is lexicographic, so each row gets
// the lowest index among equal minima, as jnp.argmin / torch.argmin give.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace assign {

constexpr int BM = 64;                   // rows of X per block
constexpr int BC = 64;                   // centroids per tile
constexpr int BK = 16;                   // depth staged per step
constexpr int TM = 4;                    // rows per thread
constexpr int TC = 4;                    // centroids per thread
constexpr int TX = BC / TC;              // threads across centroids (16)
constexpr int THREADS = (BM / TM) * TX;  // 256
constexpr int LD = BM + 4;               // padded row, keeps float4 alignment

static_assert(BM == BC, "stage() serves X and C tiles alike");
static_assert(TX == 16, "the row reduction shuffles over 16 lanes");

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// S[k][r] = A[r0 + r][k0 + k], zero outside the (rows x d) matrix.
__device__ __forceinline__ void stage(float (*S)[LD], const float* __restrict__ A,
                                      int rows, int d, int r0, int k0) {
  for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
    const int r = e / BK, k = e % BK;
    const int gr = r0 + r, gk = k0 + k;
    S[k][r] = (gr < rows && gk < d) ? A[(size_t)gr * d + gk] : 0.f;
  }
}

// Block-wide: rows [blockIdx.x * BM, +BM) of X against all c centroids.
// Writes out_idx[i] (argmin) and out_val[i] (min value + ||x_i||^2).
// Must be reached by all THREADS threads of the block.
template <bool SOAR>
__device__ void assign_rows(const float* __restrict__ X, const float* __restrict__ R,
                            const int32_t* __restrict__ prim, const float* __restrict__ C,
                            float lam, int n, int c, int d,
                            int32_t* __restrict__ out_idx, float* __restrict__ out_val) {
  __shared__ __align__(16) float Xs[BK][LD];
  __shared__ __align__(16) float Rs[SOAR ? BK : 1][LD];
  __shared__ __align__(16) float Cs[BK][LD];
  __shared__ float cn_s[BC];
  __shared__ float xn_s[BM];
  __shared__ float rx_s[BM];
  __shared__ int prim_s[BM];

  const int tid = threadIdx.x;
  const int ty = tid / TX, tx = tid % TX;
  const int r0 = blockIdx.x * BM;

  if (tid < BM) {
    const int gr = r0 + tid;
    float xn = 0.f, rx = 0.f;
    int p = -1;
    if (gr < n) {
      const float* x = X + (size_t)gr * d;
      for (int k = 0; k < d; ++k) xn = fmaf(x[k], x[k], xn);
      if constexpr (SOAR) {
        const float* r = R + (size_t)gr * d;
        for (int k = 0; k < d; ++k) rx = fmaf(r[k], x[k], rx);
        p = prim[gr];
      }
    }
    xn_s[tid] = xn;
    rx_s[tid] = rx;
    prim_s[tid] = p;
  }
  __syncthreads();

  float best_v[TM];
  int best_i[TM];
  float rx_r[TM];
  int prim_r[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    best_v[i] = CUDART_INF_F;
    best_i[i] = 0;
    rx_r[i] = rx_s[ty * TM + i];
    prim_r[i] = prim_s[ty * TM + i];
  }

  for (int c0 = 0; c0 < c; c0 += BC) {
    float acc[TM][TC];
    float racc[TM][TC];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        acc[i][j] = 0.f;
        racc[i][j] = 0.f;
      }
    float cacc = 0.f;  // ||c_{c0+tid}||^2, threads tid < BC

    for (int k0 = 0; k0 < d; k0 += BK) {
      stage(Xs, X, n, d, r0, k0);
      if constexpr (SOAR) stage(Rs, R, n, d, r0, k0);
      stage(Cs, C, c, d, c0, k0);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&Xs[k][ty * TM]);
        const float4 b = *reinterpret_cast<const float4*>(&Cs[k][tx * TC]);
        const float av[TM] = {a.x, a.y, a.z, a.w};
        const float bv[TC] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        if constexpr (SOAR) {
          const float4 r = *reinterpret_cast<const float4*>(&Rs[k][ty * TM]);
          const float rv[TM] = {r.x, r.y, r.z, r.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) racc[i][j] = fmaf(rv[i], bv[j], racc[i][j]);
        }
      }
      if (tid < BC) {
#pragma unroll
        for (int k = 0; k < BK; ++k) cacc = fmaf(Cs[k][tid], Cs[k][tid], cacc);
      }
      __syncthreads();
    }
    if (tid < BC) cn_s[tid] = cacc;
    __syncthreads();

#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = c0 + tx * TC + j;
      if (col >= c) continue;
      const float cn = cn_s[tx * TC + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        float v = cn - 2.f * acc[i][j];
        if constexpr (SOAR) {
          if (col == prim_r[i]) continue;
          const float t = rx_r[i] - racc[i][j];
          v = v + lam * (t * t);
        }
        if (better(v, col, best_v[i], best_i[i])) {
          best_v[i] = v;
          best_i[i] = col;
        }
      }
    }
  }

  // (value, index) min over the 16 threads that share each row
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float v = best_v[i];
    int id = best_i[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, id, off);
      if (better(ov, oi, v, id)) {
        v = ov;
        id = oi;
      }
    }
    const int gr = r0 + ty * TM + i;
    if (tx == 0 && gr < n) {
      out_idx[gr] = id;
      out_val[gr] = v + xn_s[ty * TM + i];
    }
  }
}

}  // namespace assign
