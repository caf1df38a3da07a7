// One Lloyd iteration: assign every row to its nearest centroid, then the
// per-centroid sums, counts and the mean distortion. Empty clusters keep
// their old centroid.
// Replaces the Pallas kernel src/repro/kernels/lloyd.py::lloyd_sweep_pallas.
//
// The TPU kernel keeps the whole codebook in VMEM and accumulates across a
// sequential grid. Hopper blocks run in parallel and a block's shared
// memory is far smaller, so the sweep is two C entries of a few launches
// each, with no float atomics and a fixed summation order (the same bits
// on every run):
//   lloyd_assign_launch: ||c||^2 and the centroids' hi/lo fragments once,
//     then the 3xTF32 tensor-core tile loop (assign_tc.cuh), both shared
//     with the nearest-centroid entry (vq_assign.cu): idx, per-row
//     distortion. Bound: operations.
//   lloyd_group_launch: O(n) integer grouping, then ordered sums. Bound:
//     bytes (X read once more).
//     1. hist: per block of SEG rows, an integer histogram of idx (shared
//        atomics; integer counts are exact in any order) and the block's
//        distortion partial (fixed-order tree);
//     2. colscan: per centroid, the exclusive prefix of the block counts;
//     3. scan: one block scans the totals over centroids (start of each
//        centroid's run) and sums the distortion partials in a fixed order;
//     4. scatter: per block, one warp walks its rows in row order and puts
//        each row id at start + prefix + its rank among equal ids (a stable
//        counting sort: rows keep row order within each centroid);
//     5. sums: one warp per centroid adds its rows in row order, lanes
//        over d (float4 where d % 4 == 0), and writes the mean or the old
//        centroid. The order of the adds is row order, as the per-centroid
//        scan of the kernel before this one had it, so the same idx gives
//        the same bits.
#include "assign_tc.cuh"

constexpr int G_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_SCALAR = 32;       // floats per lane: d <= 32 * MAX_SCALAR = 1024
constexpr size_t KEYS_SMEM_MAX = 160 * 1024;   // per-block counters in shared memory up to this
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(G_THREADS)
group_hist_kernel(const int32_t* __restrict__ idx, const float* __restrict__ mind, int n, int c,
                  int seg, int keys_smem, int32_t* __restrict__ H, float* __restrict__ seg_loss) {
  extern __shared__ int keys_s[];
  __shared__ float part[G_THREADS];
  const int b = blockIdx.x, tid = threadIdx.x;
  int* h = keys_smem ? keys_s : H + (size_t)b * c;
  for (int j = tid; j < c; j += G_THREADS) h[j] = 0;
  __syncthreads();
  const int i0 = b * seg, i1 = min(n, i0 + seg);
  float l = 0.f;
  for (int i = i0 + tid; i < i1; i += G_THREADS) {
    atomicAdd(h + idx[i], 1);
    l += mind[i];
  }
  part[tid] = l;
  __syncthreads();
  if (keys_smem)
    for (int j = tid; j < c; j += G_THREADS) H[(size_t)b * c + j] = keys_s[j];
  for (int s = G_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) part[tid] += part[tid + s];
    __syncthreads();
  }
  if (tid == 0) seg_loss[b] = part[0];
}

// H[b][j] <- sum_{b' < b} H[b'][j]; cnt[j] <- sum_b H[b][j]
__global__ void __launch_bounds__(G_THREADS)
group_colscan_kernel(int32_t* __restrict__ H, int c, int nb, int32_t* __restrict__ cnt) {
  const int j = blockIdx.x * G_THREADS + threadIdx.x;
  if (j >= c) return;
  int run = 0, b = 0;
  for (; b + 8 <= nb; b += 8) {    // eight loads in flight
    int h[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) h[u] = H[(size_t)(b + u) * c + j];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      H[(size_t)(b + u) * c + j] = run;
      run += h[u];
    }
  }
  for (; b < nb; ++b) {
    const int h = H[(size_t)b * c + j];
    H[(size_t)b * c + j] = run;
    run += h;
  }
  cnt[j] = run;
}

// one block: start = exclusive scan of cnt, counts = cnt as f32, and the
// mean distortion from the block partials, summed in a fixed order
__global__ void __launch_bounds__(SCAN_THREADS)
group_scan_kernel(const int32_t* __restrict__ cnt, int c, const float* __restrict__ seg_loss,
                  int nb, int n, int32_t* __restrict__ start, float* __restrict__ counts,
                  float* __restrict__ loss) {
  __shared__ int warp_sum[SCAN_THREADS / 32];
  __shared__ int carry_s;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  int carry = 0;
  for (int base = 0; base < c; base += SCAN_THREADS) {
    const int j = base + tid;
    const int v = j < c ? cnt[j] : 0;
    int x = v;   // inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[w] = x;
    __syncthreads();
    if (w == 0) {
      int s = warp_sum[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, s, off);
        if (lane >= off) s += y;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    const int excl = carry + (w > 0 ? warp_sum[w - 1] : 0) + x - v;
    if (j < c) {
      start[j] = excl;
      counts[j] = (float)v;
    }
    if (tid == SCAN_THREADS - 1) carry_s = excl + v;
    __syncthreads();
    carry = carry_s;
    __syncthreads();   // warp_sum and carry_s are rewritten by the next chunk
  }
  // thread-strided partial sums, then a fixed tree: the same order every run
  __shared__ double lsum[SCAN_THREADS];
  double ls = 0.0;
  for (int b = tid; b < nb; b += SCAN_THREADS) ls += seg_loss[b];
  lsum[tid] = ls;
  __syncthreads();
  for (int st = SCAN_THREADS / 2; st > 0; st >>= 1) {
    if (tid < st) lsum[tid] += lsum[tid + st];
    __syncthreads();
  }
  if (tid == 0) loss[0] = (float)lsum[0] / (float)n;
}

__global__ void __launch_bounds__(G_THREADS)
group_scatter_kernel(const int32_t* __restrict__ idx, int n, int c, int seg, int keys_smem,
                     int32_t* __restrict__ H, const int32_t* __restrict__ start,
                     int32_t* __restrict__ order) {
  extern __shared__ int sm[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  int* idx_s = sm;
  int* cur = keys_smem ? sm + seg : H + (size_t)b * c;   // next slot of each id
  const int i0 = b * seg, rows = min(n, i0 + seg) - i0;
  for (int e = tid; e < rows; e += G_THREADS) idx_s[e] = idx[i0 + e];
  for (int j = tid; j < c; j += G_THREADS) cur[j] = start[j] + H[(size_t)b * c + j];
  __syncthreads();
  if (tid >= 32) return;
  for (int base = 0; base < rows; base += 32) {
    const int e = base + lane;
    const bool ok = e < rows;
    const unsigned active = __ballot_sync(FULL, ok);
    if (ok) {
      const int j = idx_s[e];
      const unsigned peers = __match_any_sync(active, j);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if (lane == leader) {
        pos = cur[j];
        cur[j] = pos + __popc(peers);
      }
      pos = __shfl_sync(active, pos, leader);
      order[pos + __popc(peers & ((1u << lane) - 1u))] = i0 + e;
    }
    __syncwarp();   // the next step reads the cursors this one wrote
  }
}

// one warp per centroid: its rows in row order, lanes over d (R float4 a
// lane, d <= 128 * R). A cluster's sums are one chain of adds per
// dimension in row order, so a large cluster costs its row count times a
// load's latency unless loads run ahead: the loads of B rows are started,
// unconditionally (rows past the cluster's end read row 0 and are not
// added), before their adds, and the next 32 row ids are fetched first.
template <int R>
__global__ void __launch_bounds__(G_THREADS)
group_sum_vec_kernel(const float* __restrict__ X, const float* __restrict__ C,
                     const int32_t* __restrict__ order, const int32_t* __restrict__ start,
                     const int32_t* __restrict__ cnt, int c, int d, float* __restrict__ new_C) {
  constexpr int B = 32 / R;   // rows in flight (B divides 32)
  const int j = blockIdx.x * (G_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= c) return;
  const int s0 = start[j], m = cnt[j];
  float4 acc[R];
#pragma unroll
  for (int t = 0; t < R; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  int next = lane < m ? __ldg(order + s0 + lane) : 0;
  for (int r = 0; r < m; r += 32) {
    const int mine = next;    // row ids r .. r + 31 (0 past the end)
    next = r + 32 + lane < m ? __ldg(order + s0 + r + 32 + lane) : 0;
    const int rows = min(32, m - r);
    for (int u0 = 0; u0 < rows; u0 += B) {
      float4 v[B][R];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const float* x = X + (size_t)__shfl_sync(FULL, mine, u0 + u) * d;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          const int k = (t * 32 + lane) * 4;
          v[u][t] = k < d ? __ldg(reinterpret_cast<const float4*>(x + k))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < B; ++u)
        if (u0 + u < rows) {
#pragma unroll
          for (int t = 0; t < R; ++t) {
            acc[t].x += v[u][t].x;
            acc[t].y += v[u][t].y;
            acc[t].z += v[u][t].z;
            acc[t].w += v[u][t].w;
          }
        }
    }
  }
  const float fm = (float)m;
  float* out = new_C + (size_t)j * d;
  const float* old = C + (size_t)j * d;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int k = (t * 32 + lane) * 4;
    if (k < d)
      *reinterpret_cast<float4*>(out + k) =
          m > 0 ? make_float4(acc[t].x / fm, acc[t].y / fm, acc[t].z / fm, acc[t].w / fm)
                : *reinterpret_cast<const float4*>(old + k);
  }
}

// the same without float4 (d % 4 != 0 or unaligned rows): lanes over d
__global__ void __launch_bounds__(G_THREADS)
group_sum_kernel(const float* __restrict__ X, const float* __restrict__ C,
                 const int32_t* __restrict__ order, const int32_t* __restrict__ start,
                 const int32_t* __restrict__ cnt, int c, int d, float* __restrict__ new_C) {
  const int j = blockIdx.x * (G_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= c) return;
  const int s0 = start[j], m = cnt[j];
  float acc[MAX_SCALAR];
#pragma unroll
  for (int t = 0; t < MAX_SCALAR; ++t) acc[t] = 0.f;
  for (int r = 0; r < m; r += 32) {
    const int mine = r + lane < m ? order[s0 + r + lane] : 0;
    const int rows = min(32, m - r);
#pragma unroll 4
    for (int u = 0; u < rows; ++u) {
      const float* x = X + (size_t)__shfl_sync(FULL, mine, u) * d;
#pragma unroll
      for (int t = 0; t < MAX_SCALAR; ++t) {
        const int k = t * 32 + lane;
        if (k < d) acc[t] += x[k];
      }
    }
  }
  const float fm = (float)m;
#pragma unroll
  for (int t = 0; t < MAX_SCALAR; ++t) {
    const int k = t * 32 + lane;
    if (k < d) new_C[(size_t)j * d + k] = m > 0 ? acc[t] / fm : C[(size_t)j * d + k];
  }
}

// X (n, d), C (c, d) f32 -> idx (n,) int32 nearest centroid, mind (n,) f32
// its squared distance. Scratch: cn (c,) f32 and Cf, tc::fragment_count(c,
// d) 16-byte entries. vec: d % 4 == 0 and X 16-byte aligned.
extern "C" int lloyd_assign_launch(const float* X, const float* C, int n, int c, int d, int vec,
                                   float* cn, void* Cf, int32_t* idx, float* mind,
                                   cudaStream_t stream) {
  if (n < 1 || c < 1 || d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  uint4* frags = static_cast<uint4*>(Cf);
  cudaError_t err = tc::prepare_centroids(C, c, d, cn, frags, stream);
  if (err == cudaSuccess) err = tc::nearest(X, frags, cn, n, c, d, vec != 0, idx, mind, stream);
  return (int)err;
}

// Grouping and ordered sums of one sweep, from the assignment's idx/mind
// -> new_C (c, d), counts (c,) f32, loss (1,) mean distortion. Scratch:
// H (ceil(n / seg) * c) int32, cnt and start (c,) int32, order (n,)
// int32, seg_loss (ceil(n / seg),) f32.
extern "C" int lloyd_group_launch(const float* X, const float* C, const int32_t* idx,
                                  const float* mind, int n, int c, int d, int vec, int seg,
                                  int32_t* H, int32_t* cnt, int32_t* start, int32_t* order,
                                  float* seg_loss, float* new_C, float* counts, float* loss,
                                  cudaStream_t stream) {
  if (n < 1 || c < 1 || d < 1 || d > 1024 || seg < 1) return (int)cudaErrorInvalidValue;
  const int nb = tc::ceil_div(n, seg);
  const int keys_smem = (size_t)c * sizeof(int) <= KEYS_SMEM_MAX;
  const size_t hist_smem = keys_smem ? (size_t)c * sizeof(int) : 0;
  const size_t scatter_smem = (size_t)seg * sizeof(int) + hist_smem;
  cudaError_t err = tc::allow_smem((const void*)group_hist_kernel, hist_smem);
  if (err == cudaSuccess) err = tc::allow_smem((const void*)group_scatter_kernel, scatter_smem);
  if (err != cudaSuccess) return (int)err;

  group_hist_kernel<<<nb, G_THREADS, hist_smem, stream>>>(idx, mind, n, c, seg, keys_smem, H,
                                                         seg_loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  group_colscan_kernel<<<tc::ceil_div(c, G_THREADS), G_THREADS, 0, stream>>>(H, c, nb, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  group_scan_kernel<<<1, SCAN_THREADS, 0, stream>>>(cnt, c, seg_loss, nb, n, start, counts, loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  group_scatter_kernel<<<nb, G_THREADS, scatter_smem, stream>>>(idx, n, c, seg, keys_smem, H,
                                                               start, order);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = tc::ceil_div(c, G_THREADS / 32);
  if (!vec)
    group_sum_kernel<<<blocks, G_THREADS, 0, stream>>>(X, C, order, start, cnt, c, d, new_C);
  else if (d <= 128)
    group_sum_vec_kernel<1><<<blocks, G_THREADS, 0, stream>>>(X, C, order, start, cnt, c, d, new_C);
  else if (d <= 256)
    group_sum_vec_kernel<2><<<blocks, G_THREADS, 0, stream>>>(X, C, order, start, cnt, c, d, new_C);
  else if (d <= 512)
    group_sum_vec_kernel<4><<<blocks, G_THREADS, 0, stream>>>(X, C, order, start, cnt, c, d, new_C);
  else
    group_sum_vec_kernel<8><<<blocks, G_THREADS, 0, stream>>>(X, C, order, start, cnt, c, d, new_C);
  return (int)cudaGetLastError();
}
