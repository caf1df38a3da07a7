// k-means++ seeding of m independent problems X (m, n, d) -> centres
// (m, c, d): the first centre given, then c - 1 sequential exact D² picks,
// all of them in one launch.
// Replaces no Pallas kernel: the JAX package runs the pick loop as a
// compiled lax.fori_loop (repro/core/kmeans.py::kmeans_pp_init); in eager
// PyTorch the same loop (kernels/ref.py::kmeans_pp_ref, the plain version,
// which CPU tensors take) issues ~20 small operators a pick from the host.
//
// Each pick is the plain version's arithmetic, bit for bit:
//   d_new[x] = max((‖x‖² − 2⟨x, c⟩) + ‖c‖², 0), min_d = min(min_d, d_new),
// dots and norms as one FMA chain in feature order (no TF32); then the
// draw of kernels/ref.py::d2_draw: top = max(min_d), w = trunc(min_d ·
// (rcp(top) · scale)) as int64 (torch computes the float `scale / top` as
// reciprocal(top) · scale), the CDF their int64 inclusive sum,
// t = trunc(u · float(total)), and the first row whose CDF exceeds
// min(t, total − 1) (a row of zeros picks row 0). The float chain uses the
// _rn intrinsics, so nothing is contracted; int64 sums do not depend on
// their order, so the picks are the same on every run and for every
// partition of the rows.
//
// Bound: latency. A pick reads the sample once (32,768 × 100 f32, 13 MB:
// 4 µs at 3.35 TB/s, or less from shared memory), but every pick depends
// on the last through two reductions over all rows. So the kernel is
// persistent: a team of G blocks (one block an SM, all resident under a
// cooperative launch) owns one problem, each block a contiguous slice of
// its rows, held in shared memory with their norms and distances when
// they fit (rows padded to an odd number of float4s: no bank conflicts).
// A pick costs two team barriers (an atomic counter a team, spun on by one
// thread a block):
//   1. each block publishes its largest distance; after the barrier every
//      block takes the team's top and publishes the int64 sum of its
//      slice's weights;
//   2. after the barrier every block scans the G sums, finds the block
//      that holds the draw, rescans that block's published distances (a few
//      hundred values, from L2) to the row, and updates its own slice
//      against that row: no third barrier to broadcast the pick.
// Small problems in numbers (PQ's m ≈ 50 subspaces of d 2) get teams of
// one or two blocks, and with one block a team barrier is a block barrier.
// The plan (teams, G, what lives in shared memory) is the wrapper's
// (kernels/kmeans_pp.py::plan), from m, n and d.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

constexpr int KP_THREADS = 256;
constexpr int KP_WARPS = KP_THREADS / 32;

// where a block's rows of X are read from
enum { X_SHARED = 0, X_GLOBAL = 1 };

struct KpShared {
  long long part[KP_WARPS];
  float partf[KP_WARPS];
  long long rem;
  int owner;
  int pick;
};

// ⟨a, b⟩ as one FMA chain in feature order; a, b of d floats, or of
// d4 float4s zero-padded past d (fmaf(0, 0, acc) == acc: acc is never -0)
__device__ __forceinline__ float dot_vec(const float4* a, const float4* b, int d4) {
  float acc = 0.f;
  for (int k = 0; k < d4; ++k) {
    const float4 x = a[k], y = b[k];
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

__device__ __forceinline__ float dot_scalar(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}

template <int XMODE>
__device__ __forceinline__ float row_dot(const float* X, const float4* xs, int r, int lo, int d,
                                         int stride4, const float4* v) {
  if (XMODE == X_SHARED) return dot_vec(xs + (size_t)r * stride4, v, stride4);
  return dot_scalar(X + (size_t)(lo + r) * d, reinterpret_cast<const float*>(v), d);
}

// inclusive int64 sum over the block; *total gets the block's sum
__device__ long long block_scan(long long v, KpShared& sh, long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) sh.part[warp] = v;
  __syncthreads();
  long long before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < KP_WARPS; ++w) {
    const long long p = sh.part[w];
    before += w < warp ? p : 0;
    all += p;
  }
  __syncthreads();
  *total = all;
  return v + before;
}

__device__ float block_max(float v, KpShared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) sh.partf[warp] = v;
  __syncthreads();
  float m = 0.f;
#pragma unroll
  for (int w = 0; w < KP_WARPS; ++w) m = fmaxf(m, sh.partf[w]);
  __syncthreads();
  return m;
}

// all G blocks of a team meet; `passed` counts this block's barriers
__device__ __forceinline__ void team_sync(unsigned* bar, int G, unsigned& passed) {
  __syncthreads();
  if (G > 1 && threadIdx.x == 0) {
    const unsigned target = ++passed * (unsigned)G;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(seen) : "l"(bar) : "memory");
    } while (seen < target);
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ long long weight(float w, float rs) {
  return __float2ll_rz(__fmul_rn(w, rs));
}

template <int XMODE>
__global__ void __launch_bounds__(KP_THREADS, 1)
kmeans_pp_kernel(const float* __restrict__ Xall, const long long* __restrict__ first,
                 const float* __restrict__ u, int m, int n, int d, int c, float scale, int G,
                 int R, int stride4, int state_shared, float* __restrict__ cents,
                 int* __restrict__ done, float* xn_all, float* mind_all, float* bmax,
                 long long* bsum, unsigned* bars) {
  extern __shared__ float4 smem4[];
  __shared__ KpShared sh;
  const int tid = threadIdx.x;
  const int team = blockIdx.x / G, g = blockIdx.x % G, teams = gridDim.x / G;
  const int lo = g * R, rows = min(R, n - lo);
  const int width = stride4 * 4;
  float4* cen4 = smem4;                                   // the pick's row, zero-padded
  float* cen = reinterpret_cast<float*>(cen4);
  float4* xs = smem4 + stride4;                           // X_SHARED: the slice's rows
  float* st = reinterpret_cast<float*>(xs + (XMODE == X_SHARED ? (size_t)R * stride4 : 0));
  float* tbmax = bmax + (size_t)team * G;
  long long* tbsum = bsum + (size_t)team * G;
  unsigned* bar = bars + team;
  unsigned passed = 0;

  for (int p = team; p < m; p += teams) {
    const float* X = Xall + (size_t)p * n * d;
    float* xn_g = xn_all + (size_t)p * n;                 // published norms
    // the distances after pick i, published for the draw: two buffers
    // in turn, so a pick's update never overwrites what a slower block of
    // the team may still be drawing from
    float* pub0 = mind_all + (size_t)p * n;
    float* pub1 = mind_all + ((size_t)m + p) * n;
    // a thread's own rows' norms and distances: in shared memory, else in
    // global memory (the norms' publication, the distances' last one)
    float* s_xn = state_shared ? st : xn_g + lo;
    float* s_mind = state_shared ? st + R : nullptr;

    if (XMODE == X_SHARED)
      for (int e = tid; e < rows * width; e += KP_THREADS) {
        const int r = e / width, k = e % width;
        reinterpret_cast<float*>(xs)[e] = k < d ? X[(size_t)(lo + r) * d + k] : 0.f;
      }
    __syncthreads();
    for (int r = tid; r < rows; r += KP_THREADS) {
      const float4* own = XMODE == X_SHARED
                              ? xs + (size_t)r * stride4
                              : reinterpret_cast<const float4*>(X + (size_t)(lo + r) * d);
      const float v = row_dot<XMODE>(X, xs, r, lo, d, stride4, own);
      s_xn[r] = v;
      if (state_shared) __stcg(xn_g + lo + r, v);
    }
    team_sync(bar, G, passed);                            // every norm published

    int idx = (int)first[p];
    int picks = 0;
    for (int i = 0;; ++i) {
      // the pick's row: into shared memory, and the team's first block
      // writes it out as centre i
      const float* xr = X + (size_t)idx * d;
      for (int k = tid; k < width; k += KP_THREADS) {
        const float v = k < d ? __ldg(xr + k) : 0.f;
        cen[k] = v;
        if (g == 0 && k < d) cents[((size_t)p * c + i) * d + k] = v;
      }
      if (i == c - 1) break;
      const float vn = __ldcg(xn_g + idx);
      __syncthreads();

      // 1. the slice's distances to the pick, folded into min_d
      float* out = i & 1 ? pub1 : pub0;
      const float* prev = (i & 1 ? pub0 : pub1) + lo;
      float lmax = 0.f;
      for (int r = tid; r < rows; r += KP_THREADS) {
        const float dot = row_dot<XMODE>(X, xs, r, lo, d, stride4, cen4);
        const float dn = fmaxf(__fadd_rn(__fsub_rn(s_xn[r], __fmul_rn(2.f, dot)), vn), 0.f);
        const float old = i == 0 ? INFINITY : (state_shared ? s_mind[r] : __ldcg(prev + r));
        const float mn = fminf(old, dn);
        if (state_shared) s_mind[r] = mn;
        __stcg(out + lo + r, mn);
        lmax = fmaxf(lmax, mn);
      }
      lmax = block_max(lmax, sh);
      if (tid == 0) __stcg(tbmax + g, lmax);
      team_sync(bar, G, passed);

      // 2. the team's top, the scale, the slice's int64 weight sum
      float top = tid < G ? __ldcg(tbmax + tid) : 0.f;
      top = block_max(top, sh);
      const float rs = __fmul_rn(__frcp_rn(top > 0.f ? top : 1.f), scale);
      long long wsum = 0;
      for (int r = tid; r < rows; r += KP_THREADS)
        wsum += weight(state_shared ? s_mind[r] : __ldcg(out + lo + r), rs);
      long long bsum_block;
      block_scan(wsum, sh, &bsum_block);
      if (tid == 0) __stcg(tbsum + g, bsum_block);
      team_sync(bar, G, passed);

      // 3. the draw: the block that holds it, then its row
      const long long bs = tid < G ? __ldcg(tbsum + tid) : 0;
      long long total;
      const long long incl = block_scan(bs, sh, &total);
      const long long tu = __float2ll_rz(__fmul_rn(u[(size_t)i * m + p], __ll2float_rn(total)));
      const long long t = tu < total - 1 ? tu : total - 1;
      if (tid < G && incl > t && (tid == 0 || incl - bs <= t)) {
        sh.owner = tid;
        sh.rem = t - (incl - bs);
      }
      __syncthreads();
      const int b = sh.owner;
      const long long rem = sh.rem;
      const int blo = b * R, brows = min(R, n - blo);
      const int per = (brows + KP_THREADS - 1) / KP_THREADS;
      const int j0 = min(brows, tid * per), j1 = min(brows, j0 + per);
      const float* bmind = out + blo;
      long long csum = 0;
      for (int j = j0; j < j1; ++j) csum += weight(__ldcg(bmind + j), rs);
      long long ignored;
      const long long cincl = block_scan(csum, sh, &ignored);
      const long long cexcl = cincl - csum;
      if (j0 < j1 && cincl > rem && (tid == 0 || cexcl <= rem)) {
        long long acc = cexcl;
        int j = j0;
        for (; j < j1 - 1; ++j) {
          acc += weight(__ldcg(bmind + j), rs);
          if (acc > rem) break;
        }
        sh.pick = blo + j;
      }
      __syncthreads();
      idx = sh.pick;
      ++picks;
    }
    if (g == 0 && tid == 0) done[p] = picks;
  }
}

template <int XMODE>
static cudaError_t launch_mode(void** args, int grid, int smem, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(kmeans_pp_kernel<XMODE>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(KP_THREADS), args, (size_t)smem,
                                     stream);
}

// teams × G blocks, all resident (a cooperative launch refuses a grid that
// is not); xmode X_SHARED / X_GLOBAL; smem the dynamic
// shared bytes of the plan. Scratch: xn (m, n) and mind (2, m, n) f32,
// bmax (teams·G) f32, bsum (teams·G) int64, bars (teams) u32, zeroed here.
extern "C" int kmeans_pp_launch(const float* X, const long long* first, const float* u, int m,
                                int n, int d, int c, float scale, int teams, int G, int R,
                                int stride4, int xmode, int state_shared, int smem,
                                float* cents, int* done, float* xn, float* mind, float* bmax,
                                long long* bsum, unsigned* bars, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(bars, 0, sizeof(unsigned) * (size_t)teams, stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&X,     &first,        &u,     &m,    &n,  &d,    &c,    &scale,
                  &G,     &R,            &stride4, &state_shared, &cents, &done, &xn, &mind,
                  &bmax,  &bsum,         &bars};
  const int grid = teams * G;
  if (xmode == X_SHARED) err = launch_mode<X_SHARED>(args, grid, smem, stream);
  else err = launch_mode<X_GLOBAL>(args, grid, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
