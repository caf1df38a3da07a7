// SOAR spilled assignment (Theorem 3.1 loss), the primary excluded:
//   idx[i] = argmin_{j != prim[i]} ||c_j||^2 - 2<x_i,c_j> + lam (<rhat_i,x_i> - <rhat_i,c_j>)^2
// Replaces the Pallas kernel src/repro/kernels/soar_assign.py::soar_assign_pallas.
// Both dot products come from the same staged centroid tile (assign.cuh).
#include "assign.cuh"

using namespace assign;

__global__ void __launch_bounds__(THREADS)
soar_assign_kernel(const float* __restrict__ X, const float* __restrict__ R,
                   const int32_t* __restrict__ prim, const float* __restrict__ C, float lam,
                   int n, int c, int d, int32_t* __restrict__ idx, float* __restrict__ val) {
  assign_rows<true>(X, R, prim, C, lam, n, c, d, idx, val);
}

// X, R (n, d) f32, prim (n,) int32, C (c, d) f32 -> idx (n,) int32, val (n,) f32
// (loss at idx, with ||x||^2).
extern "C" int soar_assign_launch(const float* X, const float* R, const int32_t* prim,
                                  const float* C, float lam, int n, int c, int d,
                                  int32_t* idx, float* val, cudaStream_t stream) {
  const int blocks = (n + BM - 1) / BM;
  soar_assign_kernel<<<blocks, THREADS, 0, stream>>>(X, R, prim, C, lam, n, c, d, idx, val);
  return (int)cudaGetLastError();
}
