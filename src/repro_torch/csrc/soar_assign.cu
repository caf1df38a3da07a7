// SOAR spilled assignment (Theorem 3.1 loss), the primary excluded:
//   idx[i] = argmin_{j != prim[i]} ||c_j||^2 - 2<x_i,c_j> + lam (<rhat_i,x_i> - <rhat_i,c_j>)^2
// Replaces the Pallas kernel src/repro/kernels/soar_assign.py::soar_assign_pallas.
// The tile loop of assign_tc.cuh in its SOAR mode: BM = 64 rows a block, X
// and R-hat both A operands, every centroid fragment feeding both products
// (3xTF32 each); see there for the bound and the design.
#include "assign_tc.cuh"

// X, R (n, d) f32, prim (n,) int32 against a prepared codebook (Cf, cn) of
// c centroids (assign_prepare_launch) -> idx (n,) int32, val (n,) f32 (loss
// at idx, with ||x||^2; +inf and idx 0 where the primary is the only
// centroid). vec: d % 4 == 0 and X, R 16-byte aligned.
extern "C" int soar_assign_launch(const float* X, const float* R, const int32_t* prim,
                                  const void* Cf, const float* cn, float lam, int n, int c, int d,
                                  int vec, int32_t* idx, float* val, cudaStream_t stream) {
  if (n < 1 || c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  return (int)tc::launch_rows<tc::BM_SOAR, true>(X, R, prim, static_cast<const uint4*>(Cf), cn,
                                                 lam, n, c, d, vec != 0, idx, val, stream);
}
