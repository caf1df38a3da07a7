// Nearest-centroid assignment: idx[i] = argmin_j ||x_i - c_j||^2.
// Replaces the Pallas kernel src/repro/kernels/vq_assign.py::vq_assign_pallas.
// The tile loop (3xTF32 on the tensor cores, BM = 128 rows a block) lives in
// assign_tc.cuh; see there for the bound and the design. This file also
// holds what the assignment entries share with the Lloyd sweep's (lloyd.cu):
// the codebook's preparation (||c||^2 and its hi/lo mma fragments, once per
// codebook) and the nearest-centroid launch.
#include "assign_tc.cuh"

__global__ void centroid_norms_kernel(const float* __restrict__ C, int c, int d,
                                      float* __restrict__ cn) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c) return;
  const float* r = C + (size_t)j * d;
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = fmaf(r[k], r[k], s);
  cn[j] = s;
}

__global__ void split_centroids_kernel(const float* __restrict__ C, int c, int d, size_t count,
                                       uint4* __restrict__ Cf) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) Cf[e] = tc::centroid_fragment(C, c, d, e);
}

namespace tc {

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

cudaError_t prepare_centroids(const float* C, int c, int d, float* cn, uint4* Cf,
                              cudaStream_t stream) {
  centroid_norms_kernel<<<ceil_div(c, 256), 256, 0, stream>>>(C, c, d, cn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t count = fragment_count(c, d);
  split_centroids_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(C, c, d, count, Cf);
  return cudaGetLastError();
}

cudaError_t nearest(const float* X, const uint4* Cf, const float* cn, int n, int c, int d,
                    bool vec, int32_t* idx, float* val, cudaStream_t stream) {
  return launch_rows<BM_NEAREST, false>(X, nullptr, nullptr, Cf, cn, 0.f, n, c, d, vec, idx,
                                        val, stream);
}

}  // namespace tc

// C (c, d) f32 row-major -> cn (c,) f32 and Cf (tc::fragment_count(c, d)
// 16-byte entries): the prepared codebook that vq_assign_launch and
// soar_assign_launch read.
extern "C" int assign_prepare_launch(const float* C, int c, int d, float* cn, void* Cf,
                                     cudaStream_t stream) {
  if (c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return (int)tc::prepare_centroids(C, c, d, cn, static_cast<uint4*>(Cf), stream);
}

// X (n, d) f32 row-major against a prepared codebook (Cf, cn) of c
// centroids -> idx (n,) int32, val (n,) f32 (with ||x||^2). vec: d % 4 == 0
// and X 16-byte aligned. Any d: above the resident limit X streams through
// the ring.
extern "C" int vq_assign_launch(const float* X, const void* Cf, const float* cn, int n, int c,
                                int d, int vec, int32_t* idx, float* val, cudaStream_t stream) {
  if (n < 1 || c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return (int)tc::nearest(X, static_cast<const uint4*>(Cf), cn, n, c, d, vec != 0, idx, val,
                          stream);
}
