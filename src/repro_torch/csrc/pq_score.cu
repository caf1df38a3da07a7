// Dense PQ LUT scoring, every query against every code row:
//   out[q, i] = sum_k luts[q, k, codes[i, k]]
// Replaces the Pallas kernel src/repro/kernels/pq_score.py::pq_score_pallas.
//
// Bound: memory. The (nq, n) f32 output is most of the bytes (at 128 queries
// and m = 50 it is ten times the uint8 codes), and each score is m adds. A
// block stages a tile of PQS_ROWS code rows (uint8, as stored; the TPU
// kernel widens them to int32) and the LUTs of PQS_QUERIES queries in shared
// memory; each thread owns one row, reads each of its codes once and adds it
// into PQS_QUERIES running sums, summing subspaces in order. The stores of
// one query's scores are coalesced along n. The query-group index is the
// fastest grid dimension, so the blocks that share a code tile run together
// and the tile is read from device memory about once.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int PQS_ROWS = 256;     // code rows per block, one per thread
constexpr int PQS_QUERIES = 8;    // queries per block
constexpr int PQS_CENTERS = 16;
constexpr int MAX_GRID_Y = 65535;
constexpr int MAX_SMEM = 232448;  // 227 KB: a block's shared-memory ceiling on sm_90

__global__ void __launch_bounds__(PQS_ROWS)
pq_score_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes, int nq,
                int n, int m, int tile0, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);                            // (QB, m*16)
  unsigned char* tile = smem + (size_t)PQS_QUERIES * m * PQS_CENTERS * sizeof(float);

  const int q0 = blockIdx.x * PQS_QUERIES;
  const int nqb = nq - q0 < PQS_QUERIES ? nq - q0 : PQS_QUERIES;
  const long long i0 = (long long)(tile0 + blockIdx.y) * PQS_ROWS;
  const int rows = n - i0 < PQS_ROWS ? (int)(n - i0) : PQS_ROWS;

  const int lw = m * PQS_CENTERS;
  const float* lq = luts + (size_t)q0 * lw;
  for (int e = threadIdx.x; e < nqb * lw; e += PQS_ROWS) lut[e] = lq[e];
  const uint8_t* src = codes + (size_t)i0 * m;
  for (int e = threadIdx.x; e < rows * m; e += PQS_ROWS) tile[e] = src[e];
  __syncthreads();

  if (threadIdx.x >= rows) return;
  const unsigned char* row = tile + threadIdx.x * m;
  float s[PQS_QUERIES];
#pragma unroll
  for (int b = 0; b < PQS_QUERIES; ++b) s[b] = 0.f;
  for (int k = 0; k < m; ++k) {
    const float* lk = lut + k * PQS_CENTERS + row[k];
#pragma unroll
    for (int b = 0; b < PQS_QUERIES; ++b)
      if (b < nqb) s[b] += lk[b * lw];
  }
  float* o = out + (size_t)q0 * n + i0 + threadIdx.x;
#pragma unroll
  for (int b = 0; b < PQS_QUERIES; ++b)
    if (b < nqb) o[(size_t)b * n] = s[b];
}

// luts (nq, m, 16) f32, codes (n, m) uint8 (each < 16) -> out (nq, n) f32.
extern "C" int pq_score_launch(const float* luts, const uint8_t* codes, int nq, int n, int m,
                               float* out, cudaStream_t stream) {
  const size_t smem =
      (size_t)PQS_QUERIES * m * PQS_CENTERS * sizeof(float) + (size_t)PQS_ROWS * m;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pq_score_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (nq + PQS_QUERIES - 1) / PQS_QUERIES;
  const int tiles = (int)(((long long)n + PQS_ROWS - 1) / PQS_ROWS);
  for (int t0 = 0; t0 < tiles; t0 += MAX_GRID_Y) {
    const int ty = tiles - t0 < MAX_GRID_Y ? tiles - t0 : MAX_GRID_Y;
    pq_score_kernel<<<dim3(groups, ty), PQS_ROWS, smem, stream>>>(luts, codes, nq, n, m, t0,
                                                                  out);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
