// Nearest-centroid assignment: idx[i] = argmin_j ||x_i - c_j||^2.
// Replaces the Pallas kernel src/repro/kernels/vq_assign.py::vq_assign_pallas.
// The tile loop lives in assign.cuh; see there for the bound and the design.
#include "assign.cuh"

using namespace assign;

__global__ void __launch_bounds__(THREADS)
vq_assign_kernel(const float* __restrict__ X, const float* __restrict__ C, int n, int c,
                 int d, int32_t* __restrict__ idx, float* __restrict__ val) {
  assign_rows<false>(X, nullptr, nullptr, C, 0.f, n, c, d, idx, val);
}

// X (n, d), C (c, d) f32 row-major -> idx (n,) int32, val (n,) f32 (with ||x||^2).
extern "C" int vq_assign_launch(const float* X, const float* C, int n, int c, int d,
                                int32_t* idx, float* val, cudaStream_t stream) {
  const int blocks = (n + BM - 1) / BM;
  vq_assign_kernel<<<blocks, THREADS, 0, stream>>>(X, C, n, c, d, idx, val);
  return (int)cudaGetLastError();
}
