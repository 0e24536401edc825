// The sampler's dependency cone for Hopper (sm_90a): which rows of a block's
// last call each layer must compute when only the ligand outputs are read
// (need_full_h=False).
//
// Replaces: the per-layer liveness half of
// targetdiff_tpu/ops/pallas/block_denoiser.py:compute_tile_flags (num_layers
// = L, the v10 flags _block_kernel skips x2h tiles by), at row granularity:
// the row rule that function's tiles are a superset of.
//
// The rule, per complex. hop(r) = 0 on every ligand-tail row r >= N -
// n_ligand (masked or not); a row s that a row d lists as a valid neighbour
// (an edge d <- s) gets hop(s) = 1 + min hop(d); rows the sweep does not
// reach within L + 1 steps get L + 2. Layer l (0-based) of the block then
// needs h' on the rows with hop <= L - l, and node projections (nj) on the
// rows with hop <= L - l + 1: the sets only shrink with l, so a row left
// stale at one layer is never read again.
//
// Outputs: hop [B*N]; order [B*N], the rows b*N + i sorted by hop, ties by
// row (a stable sort), so that the rows of hop <= k are order[0, counts[k]);
// counts [L + 2], counts[k] = the rows of hop <= k over the batch. Everything
// stays on the device: the block kernels read their row counts from counts.
//
// What bounds it: each row's neighbour list is read once (its K indices and
// mask bytes, ~9 bytes a slot) and hop and order written once; at kNN B=100
// (60,800 rows, K = 32) ~17.8 MB, ~5 us at the memory rate. At small B the
// time is latency: a complex's breadth-first search is a chain of levels,
// each behind block barriers. Measured while designing this kernel
// (clock64 stamps, cone_variants.py; NVIDIA H100 80GB HBM3, 700 W): one SM
// pulled the int64 lists at ~12 bytes a clock whatever the loads in flight
// (staging them with a warp ballot a row took ~14k clocks a complex);
// sweeps that claim sources slot by slot in
// shared memory (atomicCAS on a hop array, warp appends to a level queue)
// cost ~1 clock a valid slot, ~19k clocks a complex at N = 608, K = 32,
// whatever the claims' ILP; on bitsets a level costs ~1.4-1.9k clocks
// whatever its rows.
//
// Design: one cooperative launch, a persistent grid of the co-resident
// blocks (one an SM); block g owns the complexes g, g + grid, ...
//  * Adjacency bitsets: row d's valid sources as a bitset of N bits (W =
//    ceil(N / 32) words), built by one warp a row (a lane a slot, kStageLoads
//    rows' loads in flight, then each valid source's bit set by a shared
//    atomicOr into the row's zeroed words). For a small batch (2 B <= grid)
//    every block builds rows of the whole batch into device memory (each
//    row staged in the warp's shared scratch, then stored whole) and a grid
//    barrier follows: the int64 lists are read by the whole card, not by
//    one SM a complex. For a large one each block builds its own
//    complexes' bitsets straight into its shared memory, kStageLoads rows
//    at a time. When a complex's bitsets do not fit in shared memory (N >
//    ~1,300) they stay in device memory and the sweeps read them there.
//  * Sweeps, a block a complex, on bitsets: the visited rows V and the
//    levels as row lists in a queue (the ligand tail first). Sweep k ORs
//    the adjacency words of level k - 1's rows (each warp its share of the
//    rows, lane = word, kSweepRows rows' loads in flight), the warps' ORs
//    into one word array; then level k is its bits not in V: warp 0 takes
//    the words and a warp scan of their popcounts, every thread writes its
//    rows to the queue in row order, and V takes them. No atomic decides a
//    result: each word's OR and each level's row order are fixed. The
//    sweeps stop at the first empty level; the rows never reached follow in
//    row order, so the queue is the complex's rows sorted by (hop, row), and
//    the level sizes are its histogram of hops (L + 3 bins).
//  * A second grid barrier, then each block places its complexes' rows:
//    the first position of each bin from the batch's totals and its
//    predecessors' histograms (read once, coalesced, summed with shared
//    integer atomics), then the queue copied to those positions and each
//    row's hop written. A block's last complex keeps its queue in shared
//    memory across the barrier; an earlier one left it in device memory.
//    Block 0 writes counts.
// The barriers are cooperative_groups' grid sync (no state of ours). Every
// sum is an integer sum and no result depends on an atomic's order: two
// launches give the same bits. kStamps (cone_phase_cycles) also writes each
// block's clock64 cycles in its phases and, for its first complex, each
// sweep's cycles and new rows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kConeThreads = 512;
constexpr int kConeWarps = kConeThreads / 32;
constexpr int kMaxBins = 32;  // hop values 0 .. L + 2: L <= 29
constexpr int kMaxSmem = 232448;
constexpr int kStageLoads = 8;  // rows' list loads in flight a lane (adjacency)
constexpr int kCopyLoads = 8;   // 16-byte loads in flight a thread (bitsets to shared memory)
constexpr int kSweepRows = 4;   // level rows' words in flight a lane (sweeps)
// kStamps: adjacency, the first barrier, the bitsets into shared memory,
// sweeps, the second barrier, placement; then, for each block's first
// complex, each sweep's cycles and its level's rows
constexpr int kPhases = 6;
constexpr int kStampWords = kPhases + 2 * kMaxBins;

__host__ __device__ constexpr int row_words(int N) { return (N + 31) / 32; }
// a complex's adjacency words, padded to 16 bytes
__host__ __device__ constexpr long long adj_words(int N) {
  return ((long long)N * row_words(N) + 3) / 4 * 4;
}

// Shared memory for N rows: kCached, the adjacency bitsets first (16 bytes
// aligned); the visited, next and level words and the levels' word
// prefixes; scan, level counts, batch totals, next positions, bin starts
// (ints); the queue (uint16). The adjacency build's warp scratch
// (kConeWarps rows) overlaps it.
__host__ __device__ constexpr size_t cone_smem(int N, bool cached) {
  const size_t W = row_words(N);
  const size_t layout = (cached ? (size_t)adj_words(N) * 4 : 0) + 4 * W * 4 +
                        6 * kMaxBins * 4 + (size_t)N * 2;
  const size_t scratch = (size_t)kConeWarps * W * 4;
  return layout > scratch ? layout : scratch;
}

__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// The warp's valid sources s (one a lane) as bits of `row` (zeroed, W
// words). __match_any_sync on the word with __reduce_or_sync of the bits
// measured slower at kNN B=4 and B=100.
__device__ __forceinline__ void set_bits(unsigned* row, int64_t s, bool valid, int N) {
  if (valid && s >= 0 && s < N) atomicOr(&row[s >> 5], 1u << (s & 31));
}

// The adjacency bitsets of rows [0, rows) of the batch (global row g = b *
// N + i at dst + b * adj_words(N) + i * W, device memory), this warp's
// rows first, first + step, ...: each row's words staged in the warp's
// `scratch` (W words of shared memory), then stored whole.
__device__ __forceinline__ void build_spread(const int64_t* __restrict__ idx,
                                             const bool* __restrict__ nmask, long long rows,
                                             long long first, long long step, int N, int K,
                                             unsigned* dst, unsigned* scratch) {
  const int lane = threadIdx.x & 31, W = row_words(N);
  for (long long r = first; r < rows; r += step * kStageLoads) {
    int64_t v[kStageLoads];
    bool m[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {  // the first 32 slots of the rows, in flight
      const long long rr = r + u * step, e = rr * K + lane;
      const bool in = rr < rows && lane < K;
      v[u] = in ? idx[e] : -1;
      m[u] = in && nmask[e];
    }
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {
      const long long rr = r + u * step;
      if (rr >= rows) break;
      for (int w = lane; w < W; w += 32) scratch[w] = 0u;
      __syncwarp();
      set_bits(scratch, v[u], m[u], N);
      for (int c = 32; c < K; c += 32) {  // K > 32: the row's other slots
        const long long e = rr * K + c + lane;
        const bool in = c + lane < K;
        __syncwarp();
        set_bits(scratch, in ? idx[e] : -1, in && nmask[e], N);
      }
      __syncwarp();
      const int b = (int)rr / N;  // B * N < 2^31
      unsigned* out = dst + b * adj_words(N) + (long long)((int)rr - b * N) * W;
      for (int w = lane; w < W; w += 32) out[w] = scratch[w];
      __syncwarp();
    }
  }
}

// The adjacency bitsets of one complex's N rows (global rows g0 ..) into
// shared memory (row i at dst + i * W): each warp kStageLoads rows in a row
// at a time, their loads in flight, their words zeroed and then set
// together.
__device__ __forceinline__ void build_own(const int64_t* __restrict__ idx,
                                          const bool* __restrict__ nmask, long long g0, int N,
                                          int K, unsigned* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = row_words(N);
  for (int r = warp * kStageLoads; r < N; r += kConeWarps * kStageLoads) {
    int64_t v[kStageLoads];
    bool m[kStageLoads];
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u) {  // the first 32 slots of the rows, in flight
      const long long e = (g0 + r + u) * K + lane;
      const bool in = r + u < N && lane < K;
      v[u] = in ? idx[e] : -1;
      m[u] = in && nmask[e];
    }
    const int n = N - r < kStageLoads ? N - r : kStageLoads;
    for (int w = lane; w < n * W; w += 32) dst[r * W + w] = 0u;
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kStageLoads; ++u)
      if (r + u < N) set_bits(dst + (r + u) * W, v[u], m[u], N);
    for (int u = 0; u < n; ++u)
      for (int c = 32; c < K; c += 32) {  // K > 32: the rows' other slots
        const long long e = (g0 + r + u) * K + c + lane;
        const bool in = c + lane < K;
        __syncwarp();
        set_bits(dst + (r + u) * W, in ? idx[e] : -1, in && nmask[e], N);
      }
    __syncwarp();
  }
}

// The rows of a level, given by word_of(w) (its W words; called once per
// word, by warp 0), appended to `queue` at `at` in row order: warp 0 keeps
// each word in fw and its rows' prefix in wpre (a warp scan of the
// popcounts), then every thread places its rows. *count takes the level's
// rows, which the function returns. Contains a block barrier.
template <typename F>
__device__ __forceinline__ int append_level(F word_of, int W, int N, unsigned* fw, int* wpre,
                                            uint16_t* queue, int at, int* count) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = (W + 31) / 32, w0 = lane * per;
    int mine = 0;
    for (int j = 0; j < per && w0 + j < W; ++j) {
      fw[w0 + j] = word_of(w0 + j);
      mine += __popc(fw[w0 + j]);
    }
    int x = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    int run = x - mine;
    for (int j = 0; j < per && w0 + j < W; ++j) {
      wpre[w0 + j] = run;
      run += __popc(fw[w0 + j]);
    }
    if (lane == 31) *count = x;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < N; r += kConeThreads) {
    const unsigned f = fw[r >> 5];
    if ((f >> (r & 31)) & 1u) queue[at + wpre[r >> 5] + __popc(f & lanes_below(r & 31))] = r;
  }
  return *count;
}

// total[k] = the batch's rows of hop k (when total is not null) and
// before[k] = those of the complexes bb < upto, for k < bins: hist read by
// every thread, coalesced, summed with shared atomics (integer sums: no
// order shows). Both must be zero on entry.
__device__ __forceinline__ void bin_sums(const int* hist, int B, int upto, int bins, int* total,
                                         int* before) {
  const int n = B * bins, lim = upto * bins;
  for (int j = threadIdx.x; j < n; j += kConeThreads) {
    if (total == nullptr && j >= lim) break;
    const int v = __ldcg(&hist[j]), k = j % bins;
    if (v == 0) continue;
    if (total != nullptr) atomicAdd(&total[k], v);
    if (j < lim) atomicAdd(&before[k], v);
  }
}

template <bool kStamps>
__device__ __forceinline__ void stamp(long long* clk, long long& t0, int p) {
  if constexpr (kStamps) {
    const long long now = clock64();
    clk[p] += now - t0;
    t0 = now;
  }
}

template <bool kCached, bool kSpread, bool kStamps>
__global__ void __launch_bounds__(kConeThreads, 1)
cone_kernel(const int64_t* __restrict__ idx, const bool* __restrict__ nmask, int B, int N, int K,
            int n_ligand, int L, int* hop, int* __restrict__ order, int* __restrict__ counts,
            int* hist, unsigned* adj, uint16_t* rowlist, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char cone_smem_raw[];
  const int W = row_words(N);
  const long long P = adj_words(N);
  unsigned* adj_s = reinterpret_cast<unsigned*>(cone_smem_raw);  // kCached: [P]
  unsigned* V = adj_s + (kCached ? P : 0);  // [W] visited rows
  unsigned* nxt = V + W;                    // [W] the next level's candidates
  unsigned* fw = nxt + W;                   // [W] a level's rows
  int* wpre = reinterpret_cast<int*>(fw + W);  // [W] a level's rows before each word
  int* scan = wpre + W;                        // [kMaxBins] a complex's rows of each hop
  int* cnt = scan + kMaxBins;                  // [kMaxBins] the complex's rows of each hop
  int* total = cnt + kMaxBins;                 // [kMaxBins] the batch's rows of each hop
  int* next = total + kMaxBins;                // [kMaxBins] the complex's first position in each bin
  int* cum = next + kMaxBins;                  // [2 * kMaxBins] the complex's bin starts
  uint16_t* queue = reinterpret_cast<uint16_t*>(cum + 2 * kMaxBins);  // [N] rows by (hop, row)
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int bins = L + 3, far = L + 2, G = gridDim.x, lig0 = N - n_ligand;
  const int last = (int)blockIdx.x < B ? blockIdx.x + (B - 1 - (int)blockIdx.x) / G * G : -1;
  long long clk[kPhases] = {}, t0 = 0;
  if constexpr (kStamps) t0 = clock64();

  if constexpr (kSpread) {
    build_spread(idx, nmask, (long long)B * N, (long long)blockIdx.x * kConeWarps + warp,
                 (long long)G * kConeWarps, N, K, adj,
                 reinterpret_cast<unsigned*>(cone_smem_raw) + warp * W);
    stamp<kStamps>(clk, t0, 0);
    cg::this_grid().sync();
    stamp<kStamps>(clk, t0, 1);
  }

  for (int b = blockIdx.x; b < B; b += G) {
    const long long base = (long long)b * N;
    const unsigned* words = adj + b * P;
    if constexpr (kCached) {
      if constexpr (kSpread) {  // the complex's bitsets into shared memory
        const uint4* from = reinterpret_cast<const uint4*>(words);
        uint4* to = reinterpret_cast<uint4*>(adj_s);
        for (long long j0 = t; j0 < P / 4; j0 += kConeThreads * kCopyLoads) {
          uint4 x[kCopyLoads];
#pragma unroll
          for (int u = 0; u < kCopyLoads; ++u)
            if (j0 + u * kConeThreads < P / 4) x[u] = __ldcg(&from[j0 + u * kConeThreads]);
#pragma unroll
          for (int u = 0; u < kCopyLoads; ++u)
            if (j0 + u * kConeThreads < P / 4) to[j0 + u * kConeThreads] = x[u];
        }
      } else {
        build_own(idx, nmask, base, N, K, adj_s);
        stamp<kStamps>(clk, t0, 0);
      }
      words = adj_s;
    }
    for (int i = lig0 + t; i < N; i += kConeThreads) queue[i - lig0] = (uint16_t)i;
    for (int w = t; w < W; w += kConeThreads) {
      const int r0 = w * 32;  // the ligand tail's bits
      const int lo = lig0 > r0 ? lig0 - r0 : 0, hi = N - r0 < 32 ? N - r0 : 32;
      V[w] = lo >= hi ? 0u : (hi - lo == 32 ? 0xffffffffu : ((1u << (hi - lo)) - 1u) << lo);
      nxt[w] = 0u;
    }
    if (t < kMaxBins) cnt[t] = t == 0 ? n_ligand : 0;
    __syncthreads();
    stamp<kStamps>(clk, t0, 2);
    const bool traced = kStamps && b == (int)blockIdx.x;  // the block's first complex
    // sweep k: the words of level k - 1 = queue[s0, s1) ORed into nxt
    int s0 = 0, s1 = n_ligand;
    for (int k = 1; k <= L + 1 && s0 < s1; ++k) {
      const long long lvl0 = kStamps ? clock64() : 0;
      for (int w0 = 0; w0 < W; w0 += 32) {
        const int w = w0 + lane;
        unsigned acc = 0u;
        for (int f = s0 + warp; f < s1; f += kConeWarps * kSweepRows) {
#pragma unroll
          for (int u = 0; u < kSweepRows; ++u) {
            const int ff = f + u * kConeWarps;
            if (ff < s1 && w < W) {
              const unsigned* row = words + (long long)queue[ff] * W;
              acc |= kCached ? row[w] : __ldcg(&row[w]);
            }
          }
        }
        if (w < W && acc != 0u) atomicOr(&nxt[w], acc);
      }
      __syncthreads();
      const int n = append_level(
          [&](int w) {
            const unsigned f = nxt[w] & ~V[w];
            nxt[w] = 0u;
            V[w] |= f;
            return f;
          },
          W, N, fw, wpre, queue, s1, &cnt[k]);
      if (traced && t == 0) {
        stamps[(long long)blockIdx.x * kStampWords + kPhases + k] = clock64() - lvl0;
        stamps[(long long)blockIdx.x * kStampWords + kPhases + kMaxBins + k] = n;
      }
      __syncthreads();
      s0 = s1;
      s1 += n;
    }
    // the rows never reached, in row order, close the queue
    append_level(
        [&](int w) {
          const int hi = N - w * 32 < 32 ? N - w * 32 : 32;
          return ~V[w] & (hi == 32 ? 0xffffffffu : (1u << hi) - 1u);
        },
        W, N, fw, wpre, queue, s1, &scan[0]);
    __syncthreads();
    if (b != last)
      for (int i = t; i < N; i += kConeThreads) rowlist[base + i] = queue[i];
    if (t < bins) hist[(long long)b * bins + t] = t == far ? N - s1 : cnt[t];
    if (b != last) __syncthreads();  // the block's shared arrays serve its next complex
    stamp<kStamps>(clk, t0, 3);
  }

  if (t < kMaxBins) total[t] = next[t] = 0;
  cg::this_grid().sync();
  stamp<kStamps>(clk, t0, 4);
  for (int b = last; b >= 0; b -= G) {  // the last complex first: its queue is in shared memory
    const long long base = (long long)b * N;
    bin_sums(hist, B, b, bins, b == last ? total : nullptr, next);
    if (t < bins) scan[t] = __ldcg(&hist[(long long)b * bins + t]);
    __syncthreads();
    if (b == last && blockIdx.x == 0 && t <= L + 1) {
      int run = 0;
      for (int k = 0; k <= t; ++k) run += total[k];
      counts[t] = run;
    }
    if (t < bins) {
      int run = next[t], start = 0;
      for (int k = 0; k < t; ++k) {
        run += total[k];
        start += scan[k];
      }
      next[t] = run;
      cum[t] = start;
    }
    if (t == 0) cum[bins] = N;
    __syncthreads();
    const uint16_t* rows = b == last ? queue : rowlist + base;
    int k = 0;
    for (int j = t; j < N; j += kConeThreads) {
      while (j >= cum[k + 1]) ++k;
      const int i = b == last ? rows[j] : __ldcg(&rows[j]);
      order[next[k] + j - cum[k]] = (int)(base + i);
      hop[base + i] = k;
    }
    __syncthreads();
    if (t < kMaxBins) next[t] = 0;  // for the next complex's bin_sums
    __syncthreads();
  }
  stamp<kStamps>(clk, t0, 5);
  if constexpr (kStamps) {
    if (t == 0)
      for (int p = 0; p < kPhases; ++p) stamps[(long long)blockIdx.x * kStampWords + p] = clk[p];
  }
}

// The grid of a launch: the blocks that fit on the card at once (the
// cooperative launch's grid must be co-resident). The occupancy query is
// kept per device and instantiation.
int cone_grid(const void* fn, size_t smem, int* grid, int* per_sm) {
  struct Seen {
    int dev = -1;
    const void* fn = nullptr;
    size_t smem = 0;
    int per_sm = 0, sms = 0;
  };
  static Seen seen[8];
  int dev = 0;
  if (const cudaError_t e = cudaGetDevice(&dev); e != cudaSuccess) return (int)e;
  Seen* hit = nullptr;
  for (Seen& s : seen)
    if (s.dev == dev && s.fn == fn && s.smem == smem) hit = &s;
  if (hit == nullptr) {
    Seen s;
    s.dev = dev;
    s.fn = fn;
    s.smem = smem;
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kMaxSmem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, fn, kConeThreads, smem);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (s.per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    static int slot = 0;
    hit = &seen[slot];
    slot = (slot + 1) % 8;
    *hit = s;
  }
  *grid = hit->per_sm * hit->sms;
  if (per_sm) *per_sm = hit->per_sm;
  return 0;
}

bool cone_args_ok(int B, int N, int K, int n_ligand, int L) {
  return B > 0 && N > 0 && N <= 65535 && K > 0 && n_ligand > 0 && n_ligand <= N && L > 0 &&
         L + 3 <= kMaxBins && (long long)B * N < (1ll << 31);
}

// The instantiation for B complexes of N rows, its shared memory and grid.
// The whole card builds the bitsets of a small batch (2 B <= the
// co-resident blocks) and of lists too long for shared memory (kSpread);
// else each block builds its own complexes' (separate instantiations: the
// two paths in one kernel cost registers, and spills, in both).
int cone_fn(int B, int N, bool stamps, const void** fn, size_t* smem, bool* cached, bool* spread,
            int* grid, int* per_sm) {
  *cached = cone_smem(N, true) <= (size_t)kMaxSmem;
  *smem = cone_smem(N, *cached);
  if (*smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  *fn = *cached ? (stamps ? (const void*)cone_kernel<true, true, true>
                          : (const void*)cone_kernel<true, true, false>)
                : (stamps ? (const void*)cone_kernel<false, true, true>
                          : (const void*)cone_kernel<false, true, false>);
  if (const int e = cone_grid(*fn, *smem, grid, per_sm)) return e;
  *spread = !*cached || 2 * B <= *grid;
  if (*spread) return 0;
  *fn = stamps ? (const void*)cone_kernel<true, false, true>
               : (const void*)cone_kernel<true, false, false>;
  return cone_grid(*fn, *smem, grid, per_sm);
}

}  // namespace

// hop [B*N], order [B*N], counts [L + 2] and the scratch hist [B * (L + 3)]
// (int32), adj [B * adj_words(N)] (uint32, 16-byte aligned) and rowlist
// [B*N] (uint16) on the device, from idx [B][N][K] int64 and nmask
// [B][N][K]; ligand rows are the last n_ligand of each complex. One
// cooperative launch on `stream`, no host synchronisation; its error is
// returned. stamps: null, or [grid][kStampWords] int64 (zeroed) for the
// clock64 cycles of each block's phases and its first complex's sweeps (the
// stamped instantiation).
extern "C" int td_cone(const int64_t* idx, const bool* nmask, int B, int N, int K, int n_ligand,
                       int L, int* hop, int* order, int* counts, int* hist, unsigned* adj,
                       uint16_t* rowlist, long long* stamps, void* stream) {
  if (!cone_args_ok(B, N, K, n_ligand, L) || ((uintptr_t)adj & 15))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  bool cached = false, spread = false;
  const void* fn = nullptr;
  int grid = 0;
  if (const int e = cone_fn(B, N, stamps != nullptr, &fn, &smem, &cached, &spread, &grid, nullptr))
    return e;
  void* args[] = {&idx, &nmask, &B, &N, &K, &n_ligand, &L, &hop, &order, &counts, &hist,
                  &adj, &rowlist, &stamps};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kConeThreads), args, smem,
                                          (cudaStream_t)stream);
}

// The launch td_cone makes for B complexes of N rows: out[0] its grid,
// out[1] its blocks an SM, out[2] whether the adjacency bitsets are cached
// in shared memory, out[3] its shared memory a block, out[4] a complex's
// uint32 adjacency words in the scratch, out[5] kStampWords, int64 stamps a
// block, out[6] whether the whole card builds the bitsets (kSpread).
extern "C" int td_cone_grid(int B, int N, int* out) {
  if (!cone_args_ok(B, N, 1, 1, 1)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  bool cached = false, spread = false;
  const void* fn = nullptr;
  if (const int e = cone_fn(B, N, false, &fn, &smem, &cached, &spread, &out[0], &out[1])) return e;
  out[2] = cached;
  out[3] = (int)smem;
  out[4] = (int)adj_words(N);
  out[5] = kStampWords;
  out[6] = spread;
  return 0;
}
