// PQ scoring of each query's probed partitions, read by probe id:
//   out[q, j*pmax + i] = (sum_k luts[q, k, codes[parts[q, j], i, k]]) + psc[q, j]
// for i < extent[parts[q, j]], and -inf past it. extent[p] is partition p's
// slot extent: its last slot holding an id >= 0, plus one. Slots inside it
// whose id is -1 (a tombstone) are scored like any other; the search masks
// them by id.
// Replaces the Pallas kernel src/repro/kernels/pq_score.py::pq_score_window_pallas,
// together with the window gather, the coarse term and the padding mask
// that the search wraps around it (repro/core/search.py::_search_pass).
//
// Bound: memory. The probed partitions' rows up to their extent are read
// once each (extent[p] * m bytes, not the pmax-wide padded row, and no gathered
// window in device memory), the LUTs once per block, the scores written
// once. One block per (query, group of probes): the query's LUT (m x 16
// f32) goes to shared memory once. A partition's rows are contiguous in
// the packed (c, pmax, m) table at p * pmax * m, which is only 4-byte
// aligned at pmax * m = 75,300, so each 256-row chunk is copied from the
// 16-byte boundary at or below its first byte, with 16-byte cp.async
// (the last copy takes only the bytes that exist), into a double-buffered
// shared ring: the next chunk's copy overlaps this chunk's scoring. One
// thread scores one candidate: its code bytes read 4, 2 or 1 at a time as
// m's alignment allows, m LUT lookups (a subspace's 16 entries lie in 16
// banks, so a warp's lookups never conflict), summed in subspace order,
// then psc added (a starved probe's -inf stays -inf).
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

constexpr int PR_THREADS = 256;   // candidates per chunk, one per thread
constexpr int PR_CENTERS = 16;
constexpr int PR_MAX_GROUP = 8;   // probes per block, at most
constexpr int PR_TARGET_BLOCKS = 2048;

static __host__ __device__ inline int pr_chunk_bytes(int m) {
  return (15 + PR_THREADS * m + 15) / 16 * 16;   // head + rows, in whole 16-byte copies
}

__device__ __forceinline__ void pr_cp16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

// sum_k lut[k][row[k]] in subspace order; row is W-byte aligned
template <int W>
__device__ __forceinline__ float score_row(const unsigned char* row, const float* lut, int m) {
  float s = 0.f;
  for (int k = 0; k < m; k += W) {
    uint32_t w;
    if constexpr (W == 4) w = *reinterpret_cast<const uint32_t*>(row + k);
    else if constexpr (W == 2) w = *reinterpret_cast<const uint16_t*>(row + k);
    else w = row[k];
#pragma unroll
    for (int u = 0; u < W; ++u) s += lut[(k + u) * PR_CENTERS + ((w >> (8 * u)) & 0xff)];
  }
  return s;
}

template <int W>
__global__ void __launch_bounds__(PR_THREADS)
pq_score_probes_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                       const int32_t* __restrict__ extent, const int64_t* __restrict__ parts,
                       const float* __restrict__ psc, int t, int pmax, int m, int group,
                       long long table_bytes, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part_s[PR_MAX_GROUP], size_s[PR_MAX_GROUP], first_s[PR_MAX_GROUP + 1];
  __shared__ float psc_s[PR_MAX_GROUP];
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (size_t)m * PR_CENTERS * sizeof(float);
  const int chunk = pr_chunk_bytes(m);

  const int tid = threadIdx.x;
  const int ngroups = (t + group - 1) / group;
  const int q = blockIdx.x / ngroups, j0 = blockIdx.x % ngroups * group;
  const int nj = min(group, t - j0);
  if (tid == 0) {
    int items = 0;
    for (int jj = 0; jj < nj; ++jj) {
      const int p = (int)parts[(size_t)q * t + j0 + jj];
      const int sz = max(0, min(extent[p], pmax));
      part_s[jj] = p;
      size_s[jj] = sz;
      psc_s[jj] = psc[(size_t)q * t + j0 + jj];
      first_s[jj] = items;
      items += (sz + PR_THREADS - 1) / PR_THREADS;
    }
    first_s[nj] = items;
  }
  const float* lq = luts + (size_t)q * m * PR_CENTERS;
  for (int e = tid; e < m * PR_CENTERS; e += PR_THREADS) lut[e] = lq[e];
  __syncthreads();

  float* oq = out + ((size_t)q * t + j0) * pmax;
  for (int jj = 0; jj < nj; ++jj)   // padding slots
    for (int i = size_s[jj] + tid; i < pmax; i += PR_THREADS) oq[(size_t)jj * pmax + i] = -CUDART_INF_F;

  // item = (probe jj, chunk of 256 rows); its copy starts at the 16-byte
  // boundary at or below the chunk's first byte
  auto locate = [&](int it, int& jj, int& r0, int& rows, long long& begin) {
    jj = 0;
    while (first_s[jj + 1] <= it) ++jj;
    r0 = (it - first_s[jj]) * PR_THREADS;
    rows = min(PR_THREADS, size_s[jj] - r0);
    begin = ((long long)part_s[jj] * pmax + r0) * m;
  };
  const int items = first_s[nj];
  auto fetch = [&](int it) {
    if (it < items) {
      int jj, r0, rows;
      long long begin;
      locate(it, jj, r0, rows, begin);
      const long long a = begin & ~15LL, end = begin + (long long)rows * m;
      unsigned char* dst = ring + (size_t)(it & 1) * chunk;
      for (long long o = a + 16LL * tid; o < end; o += 16LL * PR_THREADS)
        pr_cp16(dst + (o - a), codes + o, (int)min(16LL, table_bytes - o));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  fetch(0);
  for (int it = 0; it < items; ++it) {
    fetch(it + 1);   // into the buffer every thread finished with last round
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    int jj, r0, rows;
    long long begin;
    locate(it, jj, r0, rows, begin);
    if (tid < rows) {
      const unsigned char* row = ring + (size_t)(it & 1) * chunk + (begin & 15) + (size_t)tid * m;
      oq[(size_t)jj * pmax + r0 + tid] = score_row<W>(row, lut, m) + psc_s[jj];
    }
    __syncthreads();   // fetch(it + 2) overwrites this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int W>
static int launch_w(const float* luts, const uint8_t* codes, const int32_t* extent,
                    const int64_t* parts, const float* psc, int nq, int c, int pmax, int m, int t,
                    float* out, cudaStream_t stream) {
  const size_t smem = (size_t)m * PR_CENTERS * sizeof(float) + 2 * (size_t)pr_chunk_bytes(m);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(pq_score_probes_kernel<W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // enough probes per block that a tile's grid stays near PR_TARGET_BLOCKS
  const long long per = ((long long)nq * t + PR_TARGET_BLOCKS - 1) / PR_TARGET_BLOCKS;
  const int group = per < 1 ? 1 : per > PR_MAX_GROUP ? PR_MAX_GROUP : (int)per;
  const int ngroups = (t + group - 1) / group;
  const long long table_bytes = (long long)c * pmax * m;
  pq_score_probes_kernel<W><<<(unsigned)((long long)nq * ngroups), PR_THREADS, smem, stream>>>(
      luts, codes, extent, parts, psc, t, pmax, m, group, table_bytes, out);
  return (int)cudaGetLastError();
}

// luts (nq, m, 16) f32, codes (c, pmax, m) uint8 (each < 16, 16-byte
// aligned), extent (c,) int32, parts (nq, t) int64 in [0, c), psc (nq, t)
// f32 -> out (nq, t * pmax) f32.
extern "C" int pq_score_probes_launch(const float* luts, const uint8_t* codes,
                                      const int32_t* extent, const int64_t* parts,
                                      const float* psc, int nq, int c, int pmax, int m, int t,
                                      float* out, cudaStream_t stream) {
  if (nq < 1 || c < 1 || pmax < 1 || m < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if (m % 4 == 0) return launch_w<4>(luts, codes, extent, parts, psc, nq, c, pmax, m, t, out, stream);
  if (m % 2 == 0) return launch_w<2>(luts, codes, extent, parts, psc, nq, c, pmax, m, t, out, stream);
  return launch_w<1>(luts, codes, extent, parts, psc, nq, c, pmax, m, t, out, stream);
}
