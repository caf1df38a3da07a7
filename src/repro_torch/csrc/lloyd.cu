// One Lloyd iteration: assign every row to its nearest centroid, then the
// per-centroid sums, counts and the mean distortion. Empty clusters keep
// their old centroid.
// Replaces the Pallas kernel src/repro/kernels/lloyd.py::lloyd_sweep_pallas.
//
// The TPU kernel keeps the whole codebook in VMEM and accumulates across a
// sequential grid. Hopper blocks run in parallel and a block's shared memory
// is far smaller, so the sweep is three launches, with no float atomics and
// a fixed summation order (the same bits on every run):
//   1. the assignment tile loop of vq_assign (assign.cuh): idx, distortion;
//   2. one block per centroid scans idx in row order, compacts its rows with
//      a warp ballot and sums them in row order;
//   3. one thread sums the per-centroid distortions in centroid order.
#include "assign.cuh"

using namespace assign;

constexpr int ACC_THREADS = 256;
constexpr int ACC_WARPS = ACC_THREADS / 32;
constexpr int ACC_DPT = 4;  // dims per thread: d <= ACC_THREADS * ACC_DPT

__global__ void __launch_bounds__(THREADS)
lloyd_assign_kernel(const float* __restrict__ X, const float* __restrict__ C, int n, int c,
                    int d, int32_t* __restrict__ idx, float* __restrict__ mind) {
  assign_rows<false>(X, nullptr, nullptr, C, 0.f, n, c, d, idx, mind);
}

__global__ void __launch_bounds__(ACC_THREADS)
lloyd_accumulate_kernel(const float* __restrict__ X, const float* __restrict__ C,
                        const int32_t* __restrict__ idx, const float* __restrict__ mind,
                        int n, int d, float* __restrict__ new_C, float* __restrict__ counts,
                        float* __restrict__ part_loss) {
  __shared__ int rows_s[ACC_THREADS];
  __shared__ int warp_hits[ACC_WARPS];
  const int j = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

  float acc[ACC_DPT];
#pragma unroll
  for (int t = 0; t < ACC_DPT; ++t) acc[t] = 0.f;
  float lsum = 0.f;  // thread 0 only
  int cnt = 0;

  for (int base = 0; base < n; base += ACC_THREADS) {
    const int i = base + tid;
    const bool hit = i < n && idx[i] == j;
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[w] = __popc(mask);
    __syncthreads();
    int off = 0, total = 0;
#pragma unroll
    for (int q = 0; q < ACC_WARPS; ++q) {
      const int h = warp_hits[q];
      off += q < w ? h : 0;
      total += h;
    }
    if (hit) rows_s[off + __popc(mask & ((1u << lane) - 1u))] = i;
    __syncthreads();
    for (int r = 0; r < total; ++r) {
      const float* x = X + (size_t)rows_s[r] * d;
#pragma unroll
      for (int t = 0; t < ACC_DPT; ++t) {
        const int k = tid + t * ACC_THREADS;
        if (k < d) acc[t] += x[k];
      }
    }
    if (tid == 0)
      for (int r = 0; r < total; ++r) lsum += mind[rows_s[r]];
    cnt += total;
    __syncthreads();  // rows_s and warp_hits are rewritten by the next chunk
  }

#pragma unroll
  for (int t = 0; t < ACC_DPT; ++t) {
    const int k = tid + t * ACC_THREADS;
    if (k < d)
      new_C[(size_t)j * d + k] = cnt > 0 ? acc[t] / (float)cnt : C[(size_t)j * d + k];
  }
  if (tid == 0) {
    counts[j] = (float)cnt;
    part_loss[j] = lsum;
  }
}

__global__ void lloyd_loss_kernel(const float* __restrict__ part_loss, int c, int n,
                                  float* __restrict__ loss) {
  if (threadIdx.x == 0 && blockIdx.x == 0) {
    double s = 0.0;
    for (int j = 0; j < c; ++j) s += part_loss[j];
    loss[0] = (float)s / (float)n;
  }
}

// X (n, d), C (c, d) f32 -> new_C (c, d), counts (c,) f32, loss (1,) mean distortion.
// idx (n,) int32, mind (n,) f32 and part_loss (c,) f32 are scratch.
extern "C" int lloyd_sweep_launch(const float* X, const float* C, int n, int c, int d,
                                  int32_t* idx, float* mind, float* part_loss, float* new_C,
                                  float* counts, float* loss, cudaStream_t stream) {
  if (d > ACC_THREADS * ACC_DPT) return (int)cudaErrorInvalidValue;
  lloyd_assign_kernel<<<(n + BM - 1) / BM, THREADS, 0, stream>>>(X, C, n, c, d, idx, mind);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lloyd_accumulate_kernel<<<c, ACC_THREADS, 0, stream>>>(X, C, idx, mind, n, d, new_C, counts,
                                                         part_loss);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lloyd_loss_kernel<<<1, 32, 0, stream>>>(part_loss, c, n, loss);
  return (int)cudaGetLastError();
}
