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
//
// The selecting form (SELECT, pq_score_probes_select_launch) writes no
// window. It keeps each query's top `keep` slots by (score descending,
// window slot j*pmax + i ascending) among the candidates: slots with a
// finite score whose id (part_ids) is >= 0 and, given a filter, passes it.
// The search needs only those (its dedup reads the top multiplicity x
// budget of the window), and the window's f32 scores and int32 ids, tens of
// MB a tile, were written and read again by the ops that found them. A
// candidate is one 64-bit key, the score's bits in an order that compares
// as the float does above the complement of its slot, so keys are unique
// and a greater key ranks first. Each block keeps a buffer of keys in
// shared memory against a running threshold, the least key its top `keep`
// so far holds, so most slots fail one compare (each slot's id, read
// before it is scored, costs 4 bytes beside its m code bytes);
// when the buffer fills it is cut back to `keep` (a radix select, 8 bits of
// the key a pass). The block's survivors go to a (nq, groups, keep) scratch;
// a second launch, one block a query, cuts their union the same way, sorts
// the `keep` left (a bitonic sort in shared memory), reads the ranked slots'
// ids and writes them in rank order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

constexpr int PR_THREADS = 256;   // candidates per chunk, one per thread
constexpr int PR_CENTERS = 16;
constexpr int PR_MAX_GROUP = 8;   // probes per block, at most
constexpr int PR_TARGET_BLOCKS = 2048;
constexpr int PR_SELECT_MAX = 2048;   // keep, at most
constexpr int PR_MERGE_LOADS = 8;     // keys a merge thread loads a round
constexpr int PR_MERGE_CAP = 24576;   // keys the merge holds at once, at most (192 KiB)
constexpr int PR_BINS = 256;          // radix digits of 8 bits, one thread a digit
constexpr unsigned PR_FULL = 0xffffffffu;
static_assert(PR_THREADS == PR_BINS, "the radix select clears a digit a thread");

static __host__ __device__ inline int pr_chunk_bytes(int m) {
  return (15 + PR_THREADS * m + 15) / 16 * 16;   // head + rows, in whole 16-byte copies
}

// entries of a block's candidate buffer: room for keep and at least 1,024
// more, so a cut comes after many chunks
static __host__ __device__ inline int pr_buffer(int keep) {
  const int b = keep + (keep > 1024 ? keep : 1024);
  return (b + PR_THREADS - 1) / PR_THREADS * PR_THREADS;
}

// ... of the merge's buffer: every key of the query where they fit, so it
// cuts once; else room for keep and a round of loads
static __host__ __device__ inline int pr_merge_buffer(int keep, int per_query) {
  constexpr int ROUND = PR_THREADS * PR_MERGE_LOADS;
  const int all = (per_query + ROUND - 1) / ROUND * ROUND;
  const int least = (keep + ROUND + PR_THREADS - 1) / PR_THREADS * PR_THREADS;
  const int held = all < PR_MERGE_CAP ? all : PR_MERGE_CAP;
  return held > least ? held : least;
}

// shared memory of a select state of nbuf keys: buffer, digit counts, holes
static __host__ inline size_t pr_select_smem(int nbuf, int keep) {
  return (size_t)nbuf * 8 + PR_BINS * 4 + (size_t)keep * 4;
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

// (score, slot) -> a key that orders as (score desc, slot asc) when
// compared as a larger-first unsigned integer; 0 is no candidate's key
__device__ __forceinline__ unsigned long long pr_key(float s, int slot) {
  const unsigned u = __float_as_uint(s);
  const unsigned o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned)~slot;
}

__device__ __forceinline__ float pr_key_score(unsigned long long k) {
  const unsigned o = (unsigned)(k >> 32);
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ int pr_key_slot(unsigned long long k) { return (int)~(unsigned)k; }

struct PrSelect {
  unsigned long long thr;   // a key below it cannot reach the block's top keep
  int cnt;                  // keys in the buffer
  int bin, need, inbin;     // the radix select's pick of a pass
  int holes, moved;
};

// append the keys of the threads that want to (every thread of the block
// calls it); warp-aggregated, one atomic a warp
__device__ __forceinline__ void pr_push(bool want, unsigned long long key,
                                        unsigned long long* buf, PrSelect& st) {
  const unsigned mask = __ballot_sync(PR_FULL, want);
  if (!want) return;
  const int lane = threadIdx.x & 31, leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&st.cnt, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  buf[base + __popc(mask & ((1u << lane) - 1u))] = key;
}

__device__ __forceinline__ void pr_start(PrSelect& st) {
  st.cnt = 0;
  st.thr = 1;   // key 0 marks no candidate
}

// buf[0, st.cnt), more than keep distinct keys, cut to its keep largest at
// buf[0, keep) in no order; st.thr raised to their least (or a key at or
// below it). Every thread of the block calls it, after a barrier. Radix
// select from the top byte: count the keys under the prefix found so far
// by their next byte (a warp's equal bytes by one atomic), take the byte
// where the count from the top reaches `need`, and stop once every key of
// that byte is needed. Then each kept key at or past keep moves into a
// hole, a cut key's place below keep.
__device__ void pr_cut(unsigned long long* buf, int* hist, int* holes, PrSelect& st, int keep) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int n = st.cnt;
  unsigned long long prefix = 0;
  int need = keep;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const unsigned long long hi = shift == 56 ? 0ull : ~0ull << (shift + 8);
    hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += PR_THREADS) {
      const int e = base + tid;
      int d = -1;
      if (e < n) {
        const unsigned long long k = buf[e];
        if ((k & hi) == prefix) d = (int)(k >> shift) & 255;
      }
      const unsigned peers = __match_any_sync(PR_FULL, d);
      if (d >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[d], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {   // lane l holds bytes 8l .. 8l + 7
      int c[8], s = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        c[b] = hist[lane * 8 + b];
        s += c[b];
      }
      int suf = s;    // keys under bytes 8l and up
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_down_sync(PR_FULL, suf, o);
        if (lane + o < 32) suf += v;
      }
      int acc = suf - s;
      if (acc < need && suf >= need) {
#pragma unroll
        for (int b = 7; b >= 0; --b) {
          if (acc + c[b] >= need) {
            st.bin = lane * 8 + b;
            st.need = need - acc;
            st.inbin = c[b];
            break;
          }
          acc += c[b];
        }
      }
    }
    __syncthreads();
    prefix |= (unsigned long long)st.bin << shift;
    need = st.need;
    if (st.inbin == need) break;   // keys >= prefix are exactly keep
  }
  if (tid == 0) st.holes = st.moved = 0;
  __syncthreads();
  for (int e = tid; e < keep; e += PR_THREADS)
    if (buf[e] < prefix) holes[atomicAdd(&st.holes, 1)] = e;
  __syncthreads();
  for (int e = keep + tid; e < n; e += PR_THREADS) {
    const unsigned long long k = buf[e];
    if (k >= prefix) buf[holes[atomicAdd(&st.moved, 1)]] = k;
  }
  __syncthreads();
  if (tid == 0) {
    st.cnt = keep;
    st.thr = prefix;
  }
  __syncthreads();
}

template <int W, bool SELECT>
__global__ void __launch_bounds__(PR_THREADS)
pq_score_probes_kernel(const float* __restrict__ luts, const uint8_t* __restrict__ codes,
                       const int32_t* __restrict__ extent, const int64_t* __restrict__ parts,
                       const float* __restrict__ psc, int t, int pmax, int m, int group,
                       long long table_bytes, float* __restrict__ out,
                       const int32_t* __restrict__ part_ids, const uint8_t* __restrict__ filter,
                       int keep, unsigned long long* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part_s[PR_MAX_GROUP], size_s[PR_MAX_GROUP], first_s[PR_MAX_GROUP + 1];
  __shared__ float psc_s[PR_MAX_GROUP];
  __shared__ PrSelect st;
  float* lut = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + (size_t)m * PR_CENTERS * sizeof(float);
  const int chunk = pr_chunk_bytes(m);
  const int nbuf = pr_buffer(keep);
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(ring + 2 * (size_t)chunk);
  int* hist = reinterpret_cast<int*>(buf + nbuf);
  int* holes = hist + PR_BINS;

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
    pr_start(st);
  }
  const float* lq = luts + (size_t)q * m * PR_CENTERS;
  for (int e = tid; e < m * PR_CENTERS; e += PR_THREADS) lut[e] = lq[e];
  __syncthreads();

  float* oq = SELECT ? nullptr : out + ((size_t)q * t + j0) * pmax;
  if constexpr (!SELECT) {
    for (int jj = 0; jj < nj; ++jj)   // padding slots
      for (int i = size_s[jj] + tid; i < pmax; i += PR_THREADS) oq[(size_t)jj * pmax + i] = -CUDART_INF_F;
  }

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
    // read between two barriers with no push between them, so every thread
    // sees one count: whether the buffer lacks room for a chunk
    const bool full = SELECT && st.cnt > nbuf - PR_THREADS;
    fetch(it + 1);   // into the buffer every thread finished with last round
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    if constexpr (SELECT) {
      if (full) pr_cut(buf, hist, holes, st, keep);
    }
    int jj, r0, rows;
    long long begin;
    locate(it, jj, r0, rows, begin);
    if constexpr (SELECT) {
      bool want = false;
      unsigned long long key = 0;
      if (tid < rows) {
        const int i = r0 + tid;
        // the id's load is issued first, so its latency hides behind the scoring
        const int id = __ldg(part_ids + (size_t)part_s[jj] * pmax + i);
        const unsigned char* row = ring + (size_t)(it & 1) * chunk + (begin & 15) + (size_t)tid * m;
        const float s = score_row<W>(row, lut, m) + psc_s[jj];
        key = pr_key(s, (j0 + jj) * pmax + i);
        want = s > -CUDART_INF_F && key >= st.thr && id >= 0 &&
               (filter == nullptr || filter[id] != 0);
      }
      pr_push(want, key, buf, st);
    } else if (tid < rows) {
      const unsigned char* row = ring + (size_t)(it & 1) * chunk + (begin & 15) + (size_t)tid * m;
      oq[(size_t)jj * pmax + r0 + tid] = score_row<W>(row, lut, m) + psc_s[jj];
    }
    __syncthreads();   // fetch(it + 2) overwrites this buffer
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  if constexpr (SELECT) {
    __syncthreads();
    if (st.cnt > keep) pr_cut(buf, hist, holes, st, keep);
    const int n = st.cnt;
    unsigned long long* dst = cand + ((size_t)q * ngroups + blockIdx.x % ngroups) * keep;
    for (int e = tid; e < keep; e += PR_THREADS) dst[e] = e < n ? buf[e] : 0ull;
  }
}

// The second launch of the selecting form, one block a query: the union of
// its groups' survivors (cand, (nq, per_query) keys, 0 where none) cut to
// its keep largest, sorted, and written in rank order with their ids; the
// ranks past the candidates hold (-1, -inf).
__global__ void __launch_bounds__(PR_THREADS)
pq_score_probes_kernel_merge(const unsigned long long* __restrict__ cand, int per_query,
                             const int64_t* __restrict__ parts,
                             const int32_t* __restrict__ part_ids, int t, int pmax, int keep,
                             int32_t* __restrict__ out_ids, float* __restrict__ out_scores) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ PrSelect st;
  const int nbuf = pr_merge_buffer(keep, per_query);
  unsigned long long* buf = reinterpret_cast<unsigned long long*>(smem);
  int* hist = reinterpret_cast<int*>(buf + nbuf);
  int* holes = hist + PR_BINS;
  const int q = blockIdx.x, tid = threadIdx.x;
  if (tid == 0) pr_start(st);
  __syncthreads();
  const unsigned long long* src = cand + (size_t)q * per_query;
  constexpr int ROUND = PR_THREADS * PR_MERGE_LOADS;
  for (int base = 0; base < per_query; base += ROUND) {
    unsigned long long k[PR_MERGE_LOADS];   // the round's loads in flight together
#pragma unroll
    for (int u = 0; u < PR_MERGE_LOADS; ++u) {
      const int e = base + u * PR_THREADS + tid;
      k[u] = e < per_query ? src[e] : 0ull;
    }
    const bool full = st.cnt > nbuf - ROUND;   // every thread reads before any push
    __syncthreads();
    if (full) pr_cut(buf, hist, holes, st, keep);
#pragma unroll
    for (int u = 0; u < PR_MERGE_LOADS; ++u) pr_push(k[u] >= st.thr, k[u], buf, st);
    __syncthreads();
  }
  if (st.cnt > keep) pr_cut(buf, hist, holes, st, keep);
  const int n = st.cnt;
  // bitonic sort, greatest key first, of the n keys padded with 0 to a power of two
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  for (int e = n + tid; e < p2; e += PR_THREADS) buf[e] = 0ull;
  __syncthreads();
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p2; i += PR_THREADS) {
        const int x = i ^ j;
        if (x > i) {
          const unsigned long long a = buf[i], b = buf[x];
          if ((a < b) == ((i & k) == 0)) {
            buf[i] = b;
            buf[x] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int32_t* oi = out_ids + (size_t)q * keep;
  float* os = out_scores + (size_t)q * keep;
  for (int e = tid; e < n; e += PR_THREADS) {
    const unsigned long long key = buf[e];
    const int slot = pr_key_slot(key);
    const int j = slot / pmax, i = slot - j * pmax;
    oi[e] = part_ids[(size_t)parts[(size_t)q * t + j] * pmax + i];
    os[e] = pr_key_score(key);
  }
  for (int e = n + tid; e < keep; e += PR_THREADS) {
    oi[e] = -1;
    os[e] = -CUDART_INF_F;
  }
}

template <typename K>
static cudaError_t pr_allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int W>
static int launch_w(const float* luts, const uint8_t* codes, const int32_t* extent,
                    const int64_t* parts, const float* psc, int nq, int c, int pmax, int m, int t,
                    float* out, cudaStream_t stream) {
  const size_t smem = (size_t)m * PR_CENTERS * sizeof(float) + 2 * (size_t)pr_chunk_bytes(m);
  cudaError_t err = pr_allow_smem(pq_score_probes_kernel<W, false>, smem);
  if (err != cudaSuccess) return (int)err;
  // enough probes per block that a tile's grid stays near PR_TARGET_BLOCKS
  const long long per = ((long long)nq * t + PR_TARGET_BLOCKS - 1) / PR_TARGET_BLOCKS;
  const int group = per < 1 ? 1 : per > PR_MAX_GROUP ? PR_MAX_GROUP : (int)per;
  const int ngroups = (t + group - 1) / group;
  const long long table_bytes = (long long)c * pmax * m;
  pq_score_probes_kernel<W, false><<<(unsigned)((long long)nq * ngroups), PR_THREADS, smem, stream>>>(
      luts, codes, extent, parts, psc, t, pmax, m, group, table_bytes, out, nullptr, nullptr, 0,
      nullptr);
  return (int)cudaGetLastError();
}

template <int W>
static int launch_select_w(const float* luts, const uint8_t* codes, const int32_t* extent,
                           const int64_t* parts, const float* psc, const int32_t* part_ids,
                           const uint8_t* filter, int nq, int c, int pmax, int m, int t,
                           int group, int keep, unsigned long long* cand, int32_t* out_ids,
                           float* out_scores, cudaStream_t stream) {
  const size_t smem = (size_t)m * PR_CENTERS * sizeof(float) + 2 * (size_t)pr_chunk_bytes(m) +
                      pr_select_smem(pr_buffer(keep), keep);
  cudaError_t err = pr_allow_smem(pq_score_probes_kernel<W, true>, smem);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (t + group - 1) / group;
  const long long table_bytes = (long long)c * pmax * m;
  pq_score_probes_kernel<W, true><<<(unsigned)((long long)nq * ngroups), PR_THREADS, smem, stream>>>(
      luts, codes, extent, parts, psc, t, pmax, m, group, table_bytes, nullptr, part_ids, filter,
      keep, cand);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = pr_select_smem(pr_merge_buffer(keep, ngroups * keep), keep);
  err = pr_allow_smem(pq_score_probes_kernel_merge, msmem);
  if (err != cudaSuccess) return (int)err;
  pq_score_probes_kernel_merge<<<(unsigned)nq, PR_THREADS, msmem, stream>>>(
      cand, ngroups * keep, parts, part_ids, t, pmax, keep, out_ids, out_scores);
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

// The selecting form. As above, plus part_ids (c, pmax) int32, filter (n,)
// uint8 or null, group (probes a block, 1 .. 8), keep (1 .. 2,048) and the
// scratch cand (nq, ceil(t / group) * keep) uint64 -> out_ids (nq, keep)
// int32, out_scores (nq, keep) f32.
extern "C" int pq_score_probes_select_launch(const float* luts, const uint8_t* codes,
                                             const int32_t* extent, const int64_t* parts,
                                             const float* psc, const int32_t* part_ids,
                                             const uint8_t* filter, int nq, int c, int pmax,
                                             int m, int t, int group, int keep,
                                             unsigned long long* cand, int32_t* out_ids,
                                             float* out_scores, cudaStream_t stream) {
  if (nq < 1 || c < 1 || pmax < 1 || m < 1 || t < 1 || group < 1 || group > PR_MAX_GROUP ||
      keep < 1 || keep > PR_SELECT_MAX)
    return (int)cudaErrorInvalidValue;
#define PR_SELECT(W)                                                                          \
  launch_select_w<W>(luts, codes, extent, parts, psc, part_ids, filter, nq, c, pmax, m, t, group, \
                     keep, cand, out_ids, out_scores, stream)
  if (m % 4 == 0) return PR_SELECT(4);
  if (m % 2 == 0) return PR_SELECT(2);
  return PR_SELECT(1);
#undef PR_SELECT
}
