// Dense PQ LUT scoring, every query against every code row:
//   out[q, i] = sum_k luts[q, k, codes[i, k]]    (f32, k in order)
// Replaces the Pallas kernel src/repro/kernels/pq_score.py::pq_score_pallas.
//
// Bound: bytes in principle (the (nq, n) f32 output is ten times the uint8
// codes at 128 queries and m = 50), but a design that keeps the LUTs in
// shared memory is held by its lookups first: nq * n * m of them, and one
// shared-memory wavefront serves at most one 128-byte line. The design
// makes each wavefront return as many lookups as it can and pays nothing
// else per lookup:
// - a block owns QG queries (QG from m, so their LUTs fit in 227 KB: 64 at
//   m = 50, 8 at m = 200) and stays resident, streaming code tiles of 256
//   rows through a double-buffered shared ring by 16-byte cp.async (the
//   next tile's copy overlaps this tile's scoring), so a query group's LUTs
//   are staged once per block, not once per 256 rows;
// - the LUTs sit in shared memory as [k][query pair][code][2]: the 16
//   codes' float2 entries of one (k, pair) fill the 32 banks once, so one
//   64-bit load by every thread of a warp (random codes, one row each) is
//   free of conflicts and returns two queries' entries;
// - each thread scores one row against its QG queries (QG accumulators in
//   registers, subspaces added in order), reading its codes 4, 2 or 1
//   bytes at a time as m allows;
// - blocks of the query groups interleave by tile, so the groups read each
//   code tile at about the same time and it comes from L2;
// - scores are written with streaming stores, coalesced along n.
// The TPU kernel's one-hot MXU contraction is not carried over: keeping f32
// accuracy on the tensor cores takes a 3-way bf16 split of the LUTs and
// one-hot operands built per tile, more work than the lookups themselves.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int PQ_ROWS = 256;      // rows per tile, one per thread
constexpr int PQ_CENTERS = 16;
constexpr int PQ_MAX_GROUP = 64;  // queries per block, at most
constexpr int PQ_MAX_SMEM = 232448;  // 227 KB: a block's shared-memory ceiling on sm_90

static size_t pq_smem(int qg, int m) {
  return (size_t)qg * m * PQ_CENTERS * sizeof(float) + 2 * (size_t)PQ_ROWS * m;
}

__device__ __forceinline__ void pq_cp16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

template <int QG, int W>
__global__ void __launch_bounds__(PQ_ROWS)
pq_score_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes, int nq,
                long long n, int m, int groups, int per_group, long long tiles,
                float* __restrict__ out) {
  constexpr int QP = QG / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* lut = reinterpret_cast<float*>(smem);   // [k][pair][code][2]
  const float2* lut2 = reinterpret_cast<const float2*>(smem);
  unsigned char* ring = smem + (size_t)QG * m * PQ_CENTERS * sizeof(float);
  const int tile_bytes = PQ_ROWS * m;            // a multiple of 16

  const int tid = threadIdx.x;
  const int g = blockIdx.x % groups, slice = blockIdx.x / groups;
  const int q0 = g * QG, nqb = min(QG, nq - q0);
  const long long code_bytes = n * m;

  auto fetch = [&](long long t, int buf) {
    if (t < tiles) {
      const long long b0 = t * tile_bytes;
      const long long end = min(b0 + tile_bytes, code_bytes);
      unsigned char* dst = ring + (size_t)buf * tile_bytes;
      for (long long o = b0 + 16LL * tid; o < end; o += 16LL * PQ_ROWS)
        pq_cp16(dst + (o - b0), codes + o, (int)min(16LL, end - o));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  fetch(slice, 0);

  // the group's LUTs, queries past nq as zeros
  const int lw = m * PQ_CENTERS;
  for (int e = tid; e < QG * lw; e += PQ_ROWS) {
    const int b = e / lw, rem = e - b * lw, k = rem >> 4, c = rem & 15;
    lut[((k * QP + (b >> 1)) * PQ_CENTERS + c) * 2 + (b & 1)] =
        b < nqb ? luts[(size_t)(q0 + b) * lw + rem] : 0.f;
  }

  int buf = 0;
  for (long long t = slice; t < tiles; t += per_group, buf ^= 1) {
    fetch(t + per_group, buf ^ 1);   // into the buffer every thread finished with
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const long long i = t * PQ_ROWS + tid;
    if (i < n) {
      const unsigned char* row = ring + (size_t)buf * tile_bytes + (size_t)tid * m;
      float acc[QG];
#pragma unroll
      for (int b = 0; b < QG; ++b) acc[b] = 0.f;
      for (int k = 0; k < m; k += W) {
        uint32_t w;
        if constexpr (W == 4) w = *reinterpret_cast<const uint32_t*>(row + k);
        else if constexpr (W == 2) w = *reinterpret_cast<const uint16_t*>(row + k);
        else w = row[k];
#pragma unroll
        for (int u = 0; u < W; ++u) {
          const float2* lk = lut2 + (size_t)(k + u) * QP * PQ_CENTERS + ((w >> (8 * u)) & 0xff);
#pragma unroll
          for (int p = 0; p < QP; ++p) {
            const float2 v = lk[p * PQ_CENTERS];
            acc[2 * p] += v.x;
            acc[2 * p + 1] += v.y;
          }
        }
      }
      float* o = out + (size_t)q0 * n + i;
#pragma unroll
      for (int b = 0; b < QG; ++b)
        if (b < nqb) __stcs(o + (size_t)b * n, acc[b]);
    }
    __syncthreads();   // fetch(t + 2 * per_group) overwrites this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int QG, int W>
static int pq_launch_qw(const float* luts, const uint8_t* codes, int nq, long long n, int m,
                        float* out, cudaStream_t stream) {
  auto kernel = pq_score_kernel<QG, W>;
  const size_t smem = pq_smem(QG, m);
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, PQ_ROWS, smem)) !=
      cudaSuccess)
    return (int)err;
  const int groups = (nq + QG - 1) / QG;
  const long long tiles = (n + PQ_ROWS - 1) / PQ_ROWS;
  // resident blocks shared out among the query groups, at least one each
  long long per = ((long long)sms * (per_sm > 0 ? per_sm : 1) + groups - 1) / groups;
  per = per < 1 ? 1 : per > tiles ? tiles : per;
  const long long blocks = (long long)groups * per;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, PQ_ROWS, smem, stream>>>(luts, codes, nq, n, m, groups, (int)per,
                                                      tiles, out);
  return (int)cudaGetLastError();
}

template <int QG>
static int pq_launch_q(const float* luts, const uint8_t* codes, int nq, long long n, int m,
                       float* out, cudaStream_t stream) {
  if (m % 4 == 0) return pq_launch_qw<QG, 4>(luts, codes, nq, n, m, out, stream);
  if (m % 2 == 0) return pq_launch_qw<QG, 2>(luts, codes, nq, n, m, out, stream);
  return pq_launch_qw<QG, 1>(luts, codes, nq, n, m, out, stream);
}

// luts (nq, m, 16) f32, codes (n, m) uint8 (each < 16, 16-byte aligned)
// -> out (nq, n) f32. The query group is the largest of 64, 32, ..., 2
// whose LUTs and ring fit in shared memory, and no wider than nq needs.
extern "C" int pq_score_launch(const float* luts, const uint8_t* codes, int nq, int n, int m,
                               float* out, cudaStream_t stream) {
  int qg = PQ_MAX_GROUP;
  while (qg > 2 && (pq_smem(qg, m) > PQ_MAX_SMEM || qg / 2 >= nq)) qg /= 2;
  if (pq_smem(qg, m) > PQ_MAX_SMEM) return (int)cudaErrorInvalidValue;
  switch (qg) {
    case 64: return pq_launch_q<64>(luts, codes, nq, n, m, out, stream);
    case 32: return pq_launch_q<32>(luts, codes, nq, n, m, out, stream);
    case 16: return pq_launch_q<16>(luts, codes, nq, n, m, out, stream);
    case 8: return pq_launch_q<8>(luts, codes, nq, n, m, out, stream);
    case 4: return pq_launch_q<4>(luts, codes, nq, n, m, out, stream);
    default: return pq_launch_q<2>(luts, codes, nq, n, m, out, stream);
  }
}
