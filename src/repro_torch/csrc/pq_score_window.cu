// Per-query candidate-window PQ scoring:
//   out[q, i] = sum_k luts[q, k, codes[q, i, k]]
// Replaces the Pallas kernel src/repro/kernels/pq_score.py::pq_score_window_pallas.
//
// Bound: memory. Each code byte is read once and used once; the scores are
// written once. The TPU kernel widens codes to int32 and contracts a one-hot
// expansion on the MXU; here the codes stay uint8 (a quarter of the bytes),
// the query's LUT (m x 16 f32) sits in shared memory, the block's code tile
// is staged with coalesced byte loads, and each thread sums its candidate's
// m LUT entries in subspace order.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int PQ_THREADS = 256;  // candidates per block
constexpr int PQ_CENTERS = 16;
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(PQ_THREADS)
pq_score_window_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                       int q0, int cand, int m, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* tile = smem + (size_t)m * PQ_CENTERS * sizeof(float);

  const int q = q0 + blockIdx.y;
  const int i0 = blockIdx.x * PQ_THREADS;
  const int rows = cand - i0 < PQ_THREADS ? cand - i0 : PQ_THREADS;

  const float* lq = luts + (size_t)q * m * PQ_CENTERS;
  for (int e = threadIdx.x; e < m * PQ_CENTERS; e += PQ_THREADS) lut[e] = lq[e];
  const uint8_t* src = codes + ((size_t)q * cand + i0) * m;
  for (int e = threadIdx.x; e < rows * m; e += PQ_THREADS) tile[e] = src[e];
  __syncthreads();

  if (threadIdx.x < rows) {
    const unsigned char* row = tile + threadIdx.x * m;
    float s = 0.f;
    for (int k = 0; k < m; ++k) s += lut[k * PQ_CENTERS + row[k]];
    out[(size_t)q * cand + i0 + threadIdx.x] = s;
  }
}

// luts (nq, m, 16) f32, codes (nq, cand, m) uint8 (each < 16) -> out (nq, cand) f32.
extern "C" int pq_score_window_launch(const float* luts, const uint8_t* codes, int nq,
                                      int cand, int m, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)m * PQ_CENTERS * sizeof(float) + (size_t)PQ_THREADS * m;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_score_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (cand + PQ_THREADS - 1) / PQ_THREADS;
  for (int q0 = 0; q0 < nq; q0 += MAX_GRID_Y) {
    const int rows = nq - q0 < MAX_GRID_Y ? nq - q0 : MAX_GRID_Y;
    pq_score_window_kernel<<<dim3(tiles, rows), PQ_THREADS, smem, stream>>>(luts, codes, q0,
                                                                           cand, m, out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
