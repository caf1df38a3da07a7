// Tensor-core tile loop of the port's assignment kernels at f32 accuracy
// (3xTF32 on mma.sync.m16n8k8): the nearest centroid (vq_assign.cu, which
// the Lloyd sweep's assignment in lloyd.cu shares) and the SOAR spill
// (soar_assign.cu).
//
// Per (row i, centroid j) the nearest-centroid score is
//     ||c_j||^2 - 2<x_i, c_j>
// and the SOAR spill's (Theorem 3.1 of the paper) adds
//     + lam * (<rhat_i, x_i> - <rhat_i, c_j>)^2   with j = primary(i) excluded.
// ||c_j||^2 is computed once per codebook (cn) and ||x_i||^2 added to the
// winning value only. Each product runs in 3xTF32: each operand splits
// into a TF32 high part and a TF32 remainder, and lo*hi + hi*lo + hi*hi
// accumulate in f32 (the dropped lo*lo term is ~2^-22 relative). One TF32
// pass keeps about three decimal digits and flips near-tied argmins (the
// SOAR penalty squares the error of <rhat, c>); three keep parity with a
// f32 product.
//
// Bound on the H100: operations, 3 x 2ncd per product at the TF32
// tensor-core peak. One block owns BM rows and walks every BN = 128
// centroid tile: 8 warps as 2 (rows) x 4 (centroids), each a BM/2 x 32
// warp tile of MT x 4 m16n8 f32 accumulators per product. BM = 128 (MT =
// 4) for the nearest centroid; BM = 64 (MT = 2) for SOAR, whose second A
// operand (R-hat) doubles the accumulators and the resident rows, so that
// both fit in a thread's registers and a block's shared memory. The
// centroids are split once per codebook (prepare_centroids) into hi/lo and
// laid out in mma B-fragment order (centroid_fragment: one 16-byte shared
// load gives a lane both parts of its fragment); they stream through a
// STAGES-deep cp.async ring in BK = 32-deep chunks, and the ring runs
// across tile boundaries, so the next tile's loads overlap this tile's
// products. Each fragment load feeds every product of the block: in SOAR
// mode 3 passes into the x.c accumulators and 3 into the rhat.c ones.
// A operands: when the block's rows fit in shared memory beside the ring
// (Tile::resident), they are copied in through the ring (all their loads in
// flight at once), split into hi/lo once, stored in mma fragment order (one
// 16-byte shared load per fragment) and reused for every centroid tile;
// otherwise (large d) their chunks ride in the ring beside the centroid
// chunks and are split as they are read. Each k8 step loads all of a warp's
// fragments first, then runs the lo*hi, hi*lo and hi*hi passes over all its
// accumulators in turn, so no mma waits on the one before it.
// Ragged d is zero-filled (a zero adds nothing to the products); ragged c
// is masked by id in the epilogue, and the SOAR primary is skipped by id,
// never by +inf sentinels: a row whose only centroid is its primary keeps
// index 0 and value +inf.
// Ties: each thread meets its columns in increasing order, so a strict <
// keeps the lowest index among equal minima; the reduction across lanes
// and warps compares (value, index) lexicographically. Each row gets the
// lowest index among equal minima, as torch.argmin gives.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace tc {

constexpr int BN = 128;                     // centroids per tile
constexpr int BK = 32;                      // depth of one ring stage
constexpr int WARPS_M = 2, WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;   // 256
constexpr int WN = BN / WARPS_N;            // 32 centroids per warp
constexpr int NT = WN / 8;                  // 4 mma n-tiles per warp
constexpr int KS = BK / 8;                  // k8 steps per stage
constexpr int STAGES = 3;
constexpr int LDS = BK + 4;                 // staged row: 144 B, conflict-free fragments
constexpr int CF_STAGE = KS * (BN / 8) * 32;   // centroid fragments (uint4) per stage
constexpr size_t SMEM_MAX = 232448;         // dynamic shared memory a block may use (sm_90)
constexpr int BM_NEAREST = 128, BM_SOAR = 64;

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

// One block's shape: BM rows, one A operand (X) or two (X and R-hat, SOAR).
template <int BM, bool SOAR>
struct Tile {
  static constexpr int OPS = SOAR ? 2 : 1;
  static constexpr int WM = BM / WARPS_M;   // rows per warp
  static constexpr int MT = WM / 16;        // mma m-tiles per warp
  static_assert(WM % 16 == 0, "a warp's rows are whole m16 tiles");
  static_assert(OPS * BM * LDS <= 4 * CF_STAGE,
                "a ring stage holds one BK-deep chunk of each operand when they are resident");

  // dynamic shared bytes of one block
  static __host__ __device__ size_t smem_bytes(int d, bool resident) {
    const size_t ring = (size_t)STAGES * (4 * CF_STAGE + (resident ? 0 : OPS * BM * LDS)) * 4;
    const size_t rows = resident ? (size_t)OPS * 2 * BM * ceil_div(d, 8) * 8 * 4 : 0;
    const size_t red = (size_t)WARPS_N * BM * 8 + (size_t)BM * 4 * (SOAR ? 3 : 1);
    return ring + rows + red;
  }
  // the operands' hi/lo fragments stay in shared memory when they fit
  static __host__ __device__ bool resident(int d) { return smem_bytes(d, true) <= SMEM_MAX; }
};

// Centroid fragments of one codebook: entry ((ct * nks + ks) * BN/8 + n8) *
// 32 + lane holds {hi(b0), hi(b1), lo(b0), lo(b1)} of that lane's mma B
// fragment, b0 = C[col][k], b1 = C[col][k + 4] with col = ct * BN + n8 * 8
// + lane / 4 and k = ks * 8 + lane % 4; zero outside the (c x d) matrix.
__host__ __device__ inline size_t fragment_count(int c, int d) {
  return (size_t)ceil_div(c, BN) * ceil_div(d, 8) * (BN / 8) * 32;
}

// Shared by the assignment and Lloyd entries; defined in vq_assign.cu.
// Raises a kernel's dynamic shared memory limit where it needs > 48 KB.
cudaError_t allow_smem(const void* kernel, size_t bytes);
// cn[j] = ||c_j||^2 and Cf (fragment_count(c, d) entries), once per codebook.
cudaError_t prepare_centroids(const float* C, int c, int d, float* cn, uint4* Cf,
                              cudaStream_t stream);
// Nearest centroid of every row of X against a prepared codebook:
// idx (argmin) and val (min value + ||x||^2).
cudaError_t nearest(const float* X, const uint4* Cf, const float* cn, int n, int c, int d,
                    bool vec, int32_t* idx, float* val, cudaStream_t stream);

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// acc += A (16x8, row) * B (8x8, col), TF32 in, f32 accumulate. Not
// volatile, so the compiler may interleave independent accumulators.
__device__ __forceinline__ void mma(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// copies `bytes` (0..size) of src and zero-fills the rest of the size
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 centroid_fragment(const float* __restrict__ C, int c, int d,
                                                   size_t e) {
  const int lane = (int)(e % 32), n8 = (int)(e / 32 % (BN / 8));
  const size_t q = e / 32 / (BN / 8);
  const int nks = ceil_div(d, 8), ks = (int)(q % nks), ct = (int)(q / nks);
  const int col = ct * BN + n8 * 8 + (lane >> 2), k = ks * 8 + (lane & 3);
  const float b0 = (col < c && k < d) ? C[(size_t)col * d + k] : 0.f;
  const float b1 = (col < c && k + 4 < d) ? C[(size_t)col * d + k + 4] : 0.f;
  uint4 f;
  split(b0, f.x, f.z);
  split(b1, f.y, f.w);
  return f;
}

// S[r][k] = A[r0 + r][k0 + k] for r < R, k < BK; zero outside the
// (rows x d) matrix. vec: d % 4 == 0 and A 16-byte aligned.
template <int R>
__device__ __forceinline__ void load_chunk(float* S, const float* __restrict__ A, int rows,
                                           int d, int r0, int k0, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < R * (BK / 4); e += THREADS) {
      const int r = e / (BK / 4), k = e % (BK / 4) * 4;
      const bool ok = r0 + r < rows && k0 + k < d;
      cp_async16(S + r * LDS + k, ok ? A + (size_t)(r0 + r) * d + k0 + k : A, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < R * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      const bool ok = r0 + r < rows && k0 + k < d;
      cp_async4(S + r * LDS + k, ok ? A + (size_t)(r0 + r) * d + k0 + k : A, ok ? 4 : 0);
    }
  }
}

// Block-wide: rows [blockIdx.x * BM, +BM) of X (n, d) against all c
// centroids, given as their fragments Cf (centroid_fragment) and norms
// cn[j] = ||c_j||^2. SOAR: R (n, d) holds the rows' unit residuals r-hat
// and prim (n,) their primaries, which are excluded. Writes out_idx[i]
// (argmin) and out_val[i] (min value + ||x_i||^2). RESIDENT must equal
// Tile<BM, SOAR>::resident(d); the block needs Tile<BM, SOAR>::smem_bytes(d,
// RESIDENT) of dynamic shared memory. vec: d % 4 == 0 and X (and R) 16-byte
// aligned.
template <int BM, bool SOAR, bool RESIDENT>
__device__ void assign_rows(const float* __restrict__ X, const float* __restrict__ R,
                            const int32_t* __restrict__ prim, const uint4* __restrict__ Cf,
                            const float* __restrict__ cn, float lam, int n, int c, int d,
                            bool vec, int32_t* __restrict__ out_idx,
                            float* __restrict__ out_val) {
  using T = Tile<BM, SOAR>;
  constexpr int OPS = T::OPS, WM = T::WM, MT = T::MT;
  extern __shared__ __align__(16) float smem[];
  const int nks = ceil_div(d, 8);
  const int stage = 4 * CF_STAGE + (RESIDENT ? 0 : OPS * BM * LDS);   // floats
  const int nfrag = RESIDENT ? (BM / 16) * nks * 32 : 0;  // float4s of one hi or lo half
  float* ring = smem;
  // resident operand o: hi fragments at afrag + 2 o nfrag, lo at afrag + (2 o + 1) nfrag
  float4* afrag = reinterpret_cast<float4*>(ring + STAGES * stage);
  float* red_v = reinterpret_cast<float*>(afrag + 2 * OPS * nfrag);
  int* red_i = reinterpret_cast<int*>(red_v + WARPS_N * BM);
  float* xn_s = reinterpret_cast<float*>(red_i + WARPS_N * BM);   // ||x_i||^2
  float* rx_s = xn_s + BM;                                        // SOAR: <rhat_i, x_i>
  int* prim_s = reinterpret_cast<int*>(rx_s + BM);                // SOAR: primary(i)
  auto A = [&](int o) { return o == 0 ? X : R; };   // the A operands

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row / column group
  const int r0 = blockIdx.x * BM;
  const int nkc = ceil_div(d, BK), total = ceil_div(c, BN) * nkc;

  if constexpr (SOAR)
    for (int r = tid; r < BM; r += THREADS) prim_s[r] = r0 + r < n ? prim[r0 + r] : -1;
  if constexpr (RESIDENT) {
    // copy the block's rows through the ring, STAGES chunks of each operand
    // a round, and split them into A-fragment order: fragment (m-tile, k8
    // step) is 32 lanes x {a0..a3}; a0 (row g, col t4), a1 (g + 8, t4), a2
    // (g, t4 + 4), a3 (g + 8, t4 + 4)
    for (int kc0 = 0; kc0 < nkc; kc0 += STAGES) {
      const int kc1 = min(nkc, kc0 + STAGES);
      for (int kc = kc0; kc < kc1; ++kc)
        for (int o = 0; o < OPS; ++o)
          load_chunk<BM>(ring + (kc - kc0) * stage + o * BM * LDS, A(o), n, d, r0, kc * BK, vec);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      const int k0 = kc0 * BK, w = min(kc1 * BK, nks * 8) - k0;
      for (int e = tid; e < OPS * BM * w; e += THREADS) {
        const int o = e / (BM * w), r = e / w % BM, k = k0 + e % w;
        const float v = ring[(k / BK - kc0) * stage + o * BM * LDS + r * LDS + k % BK];
        uint32_t hi, lo;
        split(v, hi, lo);
        const int rr = r & 15, kk = k & 7;
        const int slot = ((r >> 4) * nks + (k >> 3)) * 32 + (rr & 7) * 4 + (kk & 3);
        const int j = (rr >> 3) + 2 * (kk >> 2);
        reinterpret_cast<uint32_t*>(afrag + 2 * o * nfrag + slot)[j] = hi;
        reinterpret_cast<uint32_t*>(afrag + (2 * o + 1) * nfrag + slot)[j] = lo;
      }
      // ||x||^2 (and <rhat, x>), round by round: a warp per row, lanes over
      // the round's columns, rounds in order
      for (int r = warp; r < BM; r += THREADS / 32) {
        float sq = 0.f, rx = 0.f;
        for (int k = k0 + lane; k < k0 + w; k += 32) {
          const float* p = ring + (k / BK - kc0) * stage + r * LDS + k % BK;
          sq = fmaf(p[0], p[0], sq);
          if constexpr (SOAR) rx = fmaf(p[BM * LDS], p[0], rx);
        }
        sq = warp_sum(sq);
        if constexpr (SOAR) rx = warp_sum(rx);
        if (lane == 0) {
          xn_s[r] = kc0 == 0 ? sq : xn_s[r] + sq;
          if constexpr (SOAR) rx_s[r] = kc0 == 0 ? rx : rx_s[r] + rx;
        }
      }
      __syncthreads();   // the ring is refilled next
    }
  } else {
    // ||x||^2 (and <rhat, x>) of the block's rows: a warp per row, lanes
    // over d, fixed order
    for (int r = warp; r < BM; r += THREADS / 32) {
      float sq = 0.f, rx = 0.f;
      if (r0 + r < n) {
        const float* x = X + (size_t)(r0 + r) * d;
        for (int k = lane; k < d; k += 32) {
          sq = fmaf(x[k], x[k], sq);
          if constexpr (SOAR) rx = fmaf(R[(size_t)(r0 + r) * d + k], x[k], rx);
        }
      }
      sq = warp_sum(sq);
      if constexpr (SOAR) rx = warp_sum(rx);
      if (lane == 0) {
        xn_s[r] = sq;
        if constexpr (SOAR) rx_s[r] = rx;
      }
    }
    __syncthreads();
  }

  auto fetch = [&](int item) {
    if (item < total) {
      float* S = ring + (item % STAGES) * stage;
      const int ct = item / nkc, kc = item % nkc;
      const int steps = min(KS, nks - kc * KS);
      const uint4* src = Cf + ((size_t)ct * nks + kc * KS) * (BN / 8) * 32;
      for (int e = tid; e < steps * (BN / 8) * 32; e += THREADS)
        cp_async16(reinterpret_cast<uint4*>(S) + e, src + e, 16);
      if constexpr (!RESIDENT)
        for (int o = 0; o < OPS; ++o)
          load_chunk<BM>(S + 4 * CF_STAGE + o * BM * LDS, A(o), n, d, r0, kc * BK, vec);
    }
    cp_commit();   // an empty group keeps the wait counts uniform
  };
  for (int s = 0; s < STAGES - 1; ++s) fetch(s);

  // the rows this thread's accumulators hold: r = wm WM + mt 16 + half 8 + g
  float rx_r[MT][2];
  int prim_r[MT][2];
  float best_v[MT][2];
  int best_i[MT][2];
  float acc[OPS][MT][NT][4];   // [0] x.c, [1] rhat.c (SOAR)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      best_v[mt][half] = CUDART_INF_F;
      best_i[mt][half] = 0;
      if constexpr (SOAR) {
        const int r = wm * WM + mt * 16 + half * 8 + g;
        rx_r[mt][half] = rx_s[r];
        prim_r[mt][half] = prim_s[r];
      }
    }
#pragma unroll
    for (int o = 0; o < OPS; ++o)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[o][mt][nt][e] = 0.f;
  }

  for (int item = 0; item < total; ++item) {
    cp_wait<STAGES - 2>();
    __syncthreads();           // stage `item` landed; stage item - 1 is free
    fetch(item + STAGES - 1);
    const float* S = ring + (item % STAGES) * stage;
    const uint4* Sf = reinterpret_cast<const uint4*>(S);
    const int ct = item / nkc, kc = item % nkc;
    const int steps = min(KS, nks - kc * KS);
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      if (s < steps) {
        uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 f = Sf[(s * (BN / 8) + wn * NT + nt) * 32 + lane];
          bh[nt][0] = f.x;
          bh[nt][1] = f.y;
          bl[nt][0] = f.z;
          bl[nt][1] = f.w;
        }
        uint32_t ah[OPS][MT][4], al[OPS][MT][4];
#pragma unroll
        for (int o = 0; o < OPS; ++o)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            if constexpr (RESIDENT) {
              const int slot = ((wm * MT + mt) * nks + kc * KS + s) * 32 + lane;
              const float4 h = afrag[2 * o * nfrag + slot], l = afrag[(2 * o + 1) * nfrag + slot];
              ah[o][mt][0] = __float_as_uint(h.x); ah[o][mt][1] = __float_as_uint(h.y);
              ah[o][mt][2] = __float_as_uint(h.z); ah[o][mt][3] = __float_as_uint(h.w);
              al[o][mt][0] = __float_as_uint(l.x); al[o][mt][1] = __float_as_uint(l.y);
              al[o][mt][2] = __float_as_uint(l.z); al[o][mt][3] = __float_as_uint(l.w);
            } else {
              const float* a =
                  S + 4 * CF_STAGE + o * BM * LDS + (wm * WM + mt * 16 + g) * LDS + s * 8 + t4;
              split(a[0], ah[o][mt][0], al[o][mt][0]);
              split(a[8 * LDS], ah[o][mt][1], al[o][mt][1]);
              split(a[4], ah[o][mt][2], al[o][mt][2]);
              split(a[8 * LDS + 4], ah[o][mt][3], al[o][mt][3]);
            }
          }
        // one centroid fragment, every product: lo*hi, hi*lo, hi*hi, pass by pass
#pragma unroll
        for (int o = 0; o < OPS; ++o)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma(acc[o][mt][nt], al[o][mt], bh[nt][0], bh[nt][1]);
#pragma unroll
        for (int o = 0; o < OPS; ++o)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma(acc[o][mt][nt], ah[o][mt], bl[nt][0], bl[nt][1]);
#pragma unroll
        for (int o = 0; o < OPS; ++o)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma(acc[o][mt][nt], ah[o][mt], bh[nt][0], bh[nt][1]);
      }
    }
    if (kc == nkc - 1) {
      // tile ct done: fold its scores into the running (value, index) minima
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = ct * BN + wn * WN + nt * 8 + 2 * t4 + h;
          if (col < c) {
            const float cnv = __ldg(cn + col);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int half = 0; half < 2; ++half) {
                float v = cnv - 2.f * acc[0][mt][nt][2 * half + h];
                bool take = true;
                if constexpr (SOAR) {
                  const float t = rx_r[mt][half] - acc[OPS - 1][mt][nt][2 * half + h];
                  v = v + lam * (t * t);
                  take = col != prim_r[mt][half];   // the primary is skipped by id
                }
                if (take && v < best_v[mt][half]) {   // columns arrive in increasing order
                  best_v[mt][half] = v;
                  best_i[mt][half] = col;
                }
              }
          }
        }
#pragma unroll
      for (int o = 0; o < OPS; ++o)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[o][mt][nt][e] = 0.f;
    }
  }
  cp_wait<0>();

  // (value, index) min over the 4 lanes of a row, then over the WARPS_N warps
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v = best_v[mt][half];
      int id = best_i[mt][half];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, id, off);
        if (better(ov, oi, v, id)) {
          v = ov;
          id = oi;
        }
      }
      if (t4 == 0) {
        const int r = wm * WM + mt * 16 + half * 8 + g;
        red_v[wn * BM + r] = v;
        red_i[wn * BM + r] = id;
      }
    }
  __syncthreads();
  if (tid < BM && r0 + tid < n) {
    float v = red_v[tid];
    int id = red_i[tid];
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w)
      if (better(red_v[w * BM + tid], red_i[w * BM + tid], v, id)) {
        v = red_v[w * BM + tid];
        id = red_i[w * BM + tid];
      }
    out_idx[r0 + tid] = id;
    out_val[r0 + tid] = v + xn_s[tid];
  }
}

template <int BM, bool SOAR, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
assign_kernel(const float* __restrict__ X, const float* __restrict__ R,
              const int32_t* __restrict__ prim, const uint4* __restrict__ Cf,
              const float* __restrict__ cn, float lam, int n, int c, int d, int vec,
              int32_t* __restrict__ idx, float* __restrict__ val) {
  assign_rows<BM, SOAR, RESIDENT>(X, R, prim, Cf, cn, lam, n, c, d, vec != 0, idx, val);
}

// Launch the loop over all n rows (n, c, d >= 1) on `stream`.
template <int BM, bool SOAR>
cudaError_t launch_rows(const float* X, const float* R, const int32_t* prim, const uint4* Cf,
                        const float* cn, float lam, int n, int c, int d, bool vec,
                        int32_t* idx, float* val, cudaStream_t stream) {
  using T = Tile<BM, SOAR>;
  const bool res = T::resident(d);
  const size_t smem = T::smem_bytes(d, res);
  cudaError_t err = allow_smem(res ? (const void*)assign_kernel<BM, SOAR, true>
                                   : (const void*)assign_kernel<BM, SOAR, false>,
                               smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ceil_div(n, BM));
  if (res)
    assign_kernel<BM, SOAR, true><<<grid, THREADS, smem, stream>>>(X, R, prim, Cf, cn, lam, n,
                                                                   c, d, vec, idx, val);
  else
    assign_kernel<BM, SOAR, false><<<grid, THREADS, smem, stream>>>(X, R, prim, Cf, cn, lam, n,
                                                                    c, d, vec, idx, val);
  return cudaGetLastError();
}

}  // namespace tc
