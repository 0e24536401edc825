// What the bf16 edge passes on warpgroup products (wgmma, sm_90a) share:
// x2h_edge_bf16.cuh (x2h_edge_mma_kernel) and h2x_edge_bf16.cuh
// (h2x_edge_mma_kernel). Both run persistent blocks of a producer warpgroup
// and consumer warpgroups on a ring of 64-slot tiles in shared memory,
// handed over on mbarriers; a tile is two live 32-slot chunks of the
// consumer's rows. Here: the mbarriers, the staging of the first-layer table
// [w_et; w_rbf] and the second layers as K-major wgmma B operands, the
// producer's slot geometry
// and A rows [one-hot type | type x RBF | 0] (RBF features rounded to bf16),
// the walk of a consumer's live chunks, and the consumer's pieces of one
// edge-MLP half: the first layer on wgmma plus ni + nj, LayerNorm + ReLU on
// the accumulator registers rounded to bf16 A fragments, and the k half's
// logits and 16-slot softmax partials.
#pragma once

#include "tc_common.cuh"

namespace {

constexpr int kMmaTile = 64;                // edge slots per tile: two 32-slot chunks
constexpr int kT1K = 96;                    // first-layer depth: 4 one-hot + 4 R RBF columns + 0
constexpr int kT1KSteps = kT1K / 16;
constexpr int kSboT1 = kT1K / 8 * 128;      // bytes between 8-row groups of a 96-deep operand
constexpr int kSboW2 = H / 8 * 128;         // ... of a 128-deep operand
static_assert(4 + 4 * R <= kT1K && kT1K % 16 == 0, "the one-hot and RBF columns fill the depth");

__device__ __forceinline__ void mbar_init(unsigned long long* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed; traps
// (the launch fails) after ~2^34 clocks, so that a broken handshake cannot
// hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* b, unsigned parity) {
  unsigned done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(b)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  } while (!done);
}

// Stages the kdepth x ncols bf16 matrix whose row k is row(k) (ncols bf16
// values, 16-byte aligned; nullptr: a row of zeros) as a wgmma B operand
// (B[n][k] = row(k)[n], K-major 8x8 core matrices, 8-row groups sbo bytes
// apart) at dst, by threads t of nthreads. Unit u is one core matrix (8 k x
// 8 n): its eight rows are read 16 bytes at a time, all in flight together,
// transposed in registers and written as eight 16-byte rows; neighbouring
// threads take neighbouring column groups (coalesced reads, conflict-free
// writes).
template <typename Row>
__device__ __forceinline__ void stage_b_operand(unsigned char* dst, Row row, int kdepth, int ncols,
                                                int sbo, int t, int nthreads) {
  for (int u = t; u < (kdepth / 8) * (ncols / 8); u += nthreads) {
    const int nb = u % (ncols / 8), kc = u / (ncols / 8);
    uint32_t c[8][4];  // [k][column pair]
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned short* w = row(8 * kc + i);
      const uint4 x = w == nullptr ? make_uint4(0u, 0u, 0u, 0u)
                                   : *reinterpret_cast<const uint4*>(w + 8 * nb);
      c[i][0] = x.x;
      c[i][1] = x.y;
      c[i][2] = x.z;
      c[i][3] = x.w;
    }
    unsigned char* cm = dst + nb * sbo + kc * 128;
#pragma unroll
    for (int n = 0; n < 8; ++n) {  // row n of the core matrix: column 8 nb + n, k 8 kc .. + 7
      const unsigned sel = (n & 1) ? 0x7632u : 0x5410u;
      *reinterpret_cast<uint4*>(cm + 16 * n) = make_uint4(
          __byte_perm(c[0][n >> 1], c[1][n >> 1], sel), __byte_perm(c[2][n >> 1], c[3][n >> 1], sel),
          __byte_perm(c[4][n >> 1], c[5][n >> 1], sel), __byte_perm(c[6][n >> 1], c[7][n >> 1], sel));
    }
  }
}

// Both halves' first-layer tables [w_et; w_rbf; 0] (k < 4: w_et[k], k < 4 +
// 4R: w_rbf[(k - 4) / R][(k - 4) % R], type-major as the reference's r_feat;
// ops/kernels/block_denoiser.py pack_first_layer_table) and the 128-deep
// second layers w2k and w2v (w2v nv wide) as wgmma B operands, by threads t
// of nthreads.
__device__ __forceinline__ void stage_edge_tables(unsigned char (&t1)[2][H * kT1K * 2],
                                                  unsigned char* w2k, unsigned char* w2v, int nv,
                                                  const PassParams& p, int t, int nthreads) {
  const unsigned short* w_et = reinterpret_cast<const unsigned short*>(p.w_et);
  const unsigned short* w_rbf = reinterpret_cast<const unsigned short*>(p.w_rbf);
#pragma unroll 1
  for (int kv = 0; kv < 2; ++kv)
    stage_b_operand(
        t1[kv],
        [=](int k) {
          return k < 4 ? w_et + k * H2 + kv * H
                       : (k < 4 + 4 * R ? w_rbf + (k - 4) * H2 + kv * H : nullptr);
        },
        kT1K, H, kSboT1, t, nthreads);
  const unsigned short* wk = reinterpret_cast<const unsigned short*>(p.w2k);
  const unsigned short* wv = reinterpret_cast<const unsigned short*>(p.w2v);
  stage_b_operand(w2k, [=](int k) { return wk + k * H; }, H, H, kSboW2, t, nthreads);
  stage_b_operand(w2v, [=](int k) { return wv + k * nv; }, H, nv, kSboW2, t, nthreads);
}

// Column k of a slot's first-layer row: its one-hot edge type (et; -1 for an
// invalid slot: a zero row), then its RBF features in its type's block.
__device__ __forceinline__ uint32_t feature_bits(int k, int et, const unsigned short (&rb)[R]) {
  if (k < 4) return et == k ? 0x3F80u : 0u;  // bf16 1.0
  if (k < 4 + 4 * R) return et == (k - 4) / R ? rb[(k - 4) % R] : 0u;
  return 0u;
}

// A slot's geometry: edge type (0 l->l, 1 l->p, 2 p->l, 3 p->p by (src,
// dst) ligand; -1 for an invalid slot), source node b*N + j, e_w, distance,
// rel = x_dst - x_src (0 for an invalid slot).
struct SlotGeom {
  int et;
  long long jn;
  float w, dist;
  float rel[3];
};

__device__ __forceinline__ SlotGeom slot_geometry(const EdgeInputs& in, int N, long long bn,
                                                  const EdgeSlot& s) {
  SlotGeom g{-1, -1, 0.f, 0.f, {0.f, 0.f, 0.f}};
  if (s.valid) {
    g.jn = bn / N * N + s.idx;
    const bool src_lig = in.mlig[g.jn], dst_lig = in.mlig[bn];
    g.et = src_lig ? (dst_lig ? 0 : 1) : (dst_lig ? 2 : 3);
    const float* x = in.x;
    const float rx = x[3 * bn] - x[3 * g.jn], ry = x[3 * bn + 1] - x[3 * g.jn + 1],
                rz = x[3 * bn + 2] - x[3 * g.jn + 2];
    g.dist = sqrtf(rx * rx + ry * ry + rz * rz + 1e-16f);
    g.w = s.w;
    g.rel[0] = rx;
    g.rel[1] = ry;
    g.rel[2] = rz;
  }
  return g;
}

// Slot m of tile T: its source, e_w and A row [one-hot type | type x RBF |
// 0], the RBF features rounded to bf16; rel where the tile keeps it
// (Tile::kRel).
template <typename Tile>
__device__ __forceinline__ void write_slot(Tile& T, const EdgeInputs& in, const SlotGeom& g,
                                           int m) {
  unsigned short rb[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float d = g.dist - in.offsets[r];
    rb[r] = g.et < 0 ? 0 : __bfloat16_as_ushort(__float2bfloat16_rn(expf(in.coeff * d * d)));
  }
#pragma unroll
  for (int kc = 0; kc < kT1K / 8; ++kc) {
    uint32_t w[4];
#pragma unroll
    for (int pr = 0; pr < 4; ++pr)
      w[pr] = feature_bits(8 * kc + 2 * pr, g.et, rb) |
              feature_bits(8 * kc + 2 * pr + 1, g.et, rb) << 16;
    *reinterpret_cast<uint4*>(T.a + kmajor_off(m, 8 * kc, kSboT1)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  T.src[m] = (int)g.jn;
  T.ew[m] = g.w;
  if constexpr (Tile::kRel) {
    T.rel[m][0] = g.rel[0];
    T.rel[m][1] = g.rel[1];
    T.rel[m][2] = g.rel[2];
  }
}

// Bit c set when chunk c of row bn holds a valid edge, by one thread: 16
// bytes a load where the row's mask is 16-byte aligned (K a multiple of 16),
// else byte by byte.
__device__ __forceinline__ unsigned row_live_chunks(const bool* nmask, long long bn, int K) {
  const unsigned char* m = reinterpret_cast<const unsigned char*>(nmask + bn * K);
  unsigned bits = 0;
  if ((K & 15) == 0 && (reinterpret_cast<uintptr_t>(m) & 15) == 0) {
#pragma unroll 4
    for (int e = 0; e < K; e += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(m + e);
      bits |= ((v.x | v.y | v.z | v.w) != 0u ? 1u : 0u) << (e / KC);
    }
  } else {
#pragma unroll 8
    for (int e = 0; e < K; ++e) bits |= (m[e] ? 1u : 0u) << (e / KC);
  }
  return bits;
}

// A row's live chunk as its producer hands it on.
struct LiveChunk {
  long long row;  // -1: none left
  int c;          // chunk index within the row
  int first, last;
};

// The live chunks of one consumer's rows in order, as each of its producer
// warps walks them (warp-wide): rows u = wbase, wbase + stride, ... of [0,
// total), 32 at a time (lane i reads the live chunks of the window's row i);
// node(u) is row u's node b*N + i. start() and next() pass each row they
// skip for having no live chunk to dead(node), on every lane; next() hands
// on the next live chunk (row -1: none left).
template <typename Node>
struct ChunkWalk {
  const bool* nmask;
  Node node;
  long long total, stride, wbase;  // row i of the window: wbase + i stride
  int K, lane;
  unsigned wbits = 0;  // lane i: the live chunks of the window's row i
  int wi = -1;
  long long cur = 0;  // the current row (total: none left)
  unsigned todo = 0;
  bool fresh = false;

  __device__ __forceinline__ void load_window() {
    const long long r = wbase + lane * stride;
    wbits = r < total ? row_live_chunks(nmask, node(r), K) : 0u;
  }

  template <typename Dead>
  __device__ __forceinline__ void seek(Dead dead) {  // to the next row with a live chunk
    for (;;) {
      if (++wi == 32) {
        wbase += 32 * stride;
        wi = 0;
        load_window();
      }
      cur = wbase + wi * stride;
      if (cur >= total) {
        cur = total;
        return;
      }
      todo = __shfl_sync(0xffffffffu, wbits, wi);
      if (todo) {
        fresh = true;
        return;
      }
      dead(node(cur));
    }
  }

  template <typename Dead>
  __device__ __forceinline__ void start(Dead dead) {
    load_window();
    seek(dead);
  }

  template <typename Dead>
  __device__ __forceinline__ LiveChunk next(Dead dead) {
    LiveChunk ch{-1, 0, 0, 0};
    if (cur >= total) return ch;
    ch.row = node(cur);
    ch.c = __ffs(todo) - 1;
    ch.first = fresh;
    todo &= todo - 1;
    ch.last = todo == 0;
    fresh = false;
    if (todo == 0) seek(dead);
    return ch;
  }
};

// Tile T of chunks a and b (row -1: absent) by one producer warp: each
// slot's geometry and A row, each chunk's ni and q rows (cp.async), rows,
// valid slots and first / last flags. The slots are loaded before the stage
// is waited for (empty, phase parity); then the stage is marked full.
template <typename Tile>
__device__ __forceinline__ void fill_tile(Tile& T, const EdgeInputs& in,
                                          const float* __restrict__ qn, int N, int K,
                                          const LiveChunk& a, const LiveChunk& b,
                                          unsigned long long* empty, unsigned parity,
                                          unsigned long long* full, int lane) {
  const EdgeSlot sa = load_slot(in, a.row, K, KC * a.c + lane);
  const EdgeSlot sb = load_slot(in, b.row, K, KC * b.c + lane);
  const SlotGeom ga = slot_geometry(in, N, a.row, sa), gb = slot_geometry(in, N, b.row, sb);
  const unsigned va = __ballot_sync(0xffffffffu, sa.valid);
  const unsigned vb = __ballot_sync(0xffffffffu, sb.valid);
  mbar_wait(empty, parity);
  const long long rows[2] = {a.row, b.row};
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (rows[p] < 0) continue;
    for (int u = lane; u < (H2 + H) / 4; u += 32)
      cp_async16(u < H2 / 4 ? &T.ni[p][4 * u] : &T.q[p][4 * u - H2],
                 u < H2 / 4 ? in.ni + rows[p] * H2 + 4 * u : qn + rows[p] * H + 4 * u - H2);
  }
  write_slot(T, in, ga, lane);
  write_slot(T, in, gb, KC + lane);
  if (lane == 0) {
    T.row[0] = a.row;
    T.row[1] = b.row;
    T.valid[0] = va;
    T.valid[1] = vb;
    T.first[0] = a.first;
    T.first[1] = b.first;
    T.last[0] = a.last;
    T.last[1] = b.last;
  }
  cp_async_wait_all();
  fence_proxy_async();
  __syncwarp();
  if (lane == 0) mbar_arrive(full);
}

// ni of the chunk's row (staged: nirow, null where the chunk is absent) +
// nj of the thread's two slots' sources (0 where there is none) for half
// kv, in the accumulator's layout.
__device__ __forceinline__ void node_sums(float2 (&ns)[2][H / 8], const EdgeInputs& in,
                                          const float* nirow, const int (&src)[2], int kv,
                                          int tig) {
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const float2 a = nirow == nullptr
                         ? make_float2(0.f, 0.f)
                         : *reinterpret_cast<const float2*>(nirow + kv * H + 8 * nt + 2 * tig);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 b = src[r] < 0 ? make_float2(0.f, 0.f)
                                  : *reinterpret_cast<const float2*>(
                                        in.nj + (size_t)src[r] * H2 + kv * H + 8 * nt + 2 * tig);
      ns[r][nt] = make_float2(a.x + b.x, a.y + b.y);
    }
  }
}

// The tile's first layer for one half: its A operand (da) times the half's
// table (t1), 6 wgmma m64n128k16 into acc, committed but not waited for.
__device__ __forceinline__ void first_layer_mma(float (&acc)[64], uint64_t da,
                                                const unsigned char* t1) {
  const uint64_t db = mma_desc(t1, kSboT1);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kT1KSteps; ++ks) wgmma_ss(acc, desc_ks(da, ks), desc_ks(db, ks), ks);
  wgmma_commit();
}

// acc += ns (the half's ni + nj of the thread's rows m0 (r = 0), m0 + 8).
__device__ __forceinline__ void add_node_sums(float (&acc)[64], const float2 (&ns)[2][H / 8]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      acc[4 * nt + 2 * r] += ns[r][nt].x;
      acc[4 * nt + 2 * r + 1] += ns[r][nt].y;
    }
}

// LayerNorm + ReLU of rows m0 (r = 0) and m0 + 8 (r = 1) of the half's
// first-layer sums (ln: kv_ln's scale and bias rows of k|v), rounded to
// bf16 as the second layer's A fragments: k-step ks takes n-tiles 2 ks
// (registers 0, 1) and 2 ks + 1 (2, 3).
__device__ __forceinline__ void ln_relu_frags(uint32_t (&fr)[H / 16][4], const float (&acc)[64],
                                              const float (&ln)[2][H2], int kv, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lsum[4] = {};  // four independent partial sums: short dependency chains
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt)
      lsum[nt & 3] += acc[4 * nt + 2 * r] + acc[4 * nt + 2 * r + 1];
    float sum = (lsum[0] + lsum[1]) + (lsum[2] + lsum[3]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mean = sum * (1.f / H);
    float sqp[4] = {};
#pragma unroll
    for (int i = 0; i < 2 * (H / 8); ++i) {
      const float dlt = acc[4 * (i >> 1) + 2 * r + (i & 1)] - mean;
      sqp[i & 3] = fmaf(dlt, dlt, sqp[i & 3]);
    }
    float sq = (sqp[0] + sqp[1]) + (sqp[2] + sqp[3]);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    const float rstd = rsqrtf(sq * (1.f / H) + kLnEps);
#pragma unroll
    for (int nt = 0; nt < H / 8; ++nt) {
      const int col = kv * H + 8 * nt + 2 * tig;
      const float2 sc = *reinterpret_cast<const float2*>(&ln[0][col]);
      const float2 bi = *reinterpret_cast<const float2*>(&ln[1][col]);
      const float z0 = fmaxf((acc[4 * nt + 2 * r] - mean) * rstd * sc.x + bi.x, 0.f);
      const float z1 = fmaxf((acc[4 * nt + 2 * r + 1] - mean) * rstd * sc.y + bi.y, 0.f);
      fr[nt >> 1][(nt & 1) * 2 + r] = bf16_pair(z0, z1);
    }
  }
}

// The k half's softmax partials over the warp's 16 slots (rows m0 = 16 w +
// g and m0 + 8 of acc, k with its bias): the logits q . k / sqrt(8) of the
// quad reduce-scattered (thread tig keeps heads 4 tig .. 4 tig + 3), masked
// where a slot is not valid; per head the warp's max (xm) and exp-sum (xs,
// by g = 0) and pw[slot][head] = e_w exp(logit - max) for the v half.
__device__ __forceinline__ void softmax_partials(const float (&acc)[64], const float2 (&qv)[NH],
                                                 const bool (&valid)[2], const float (&ew)[2],
                                                 float (*pw)[NH], float* xm, float* xs, int g,
                                                 int tig) {
  const float lscale = rsqrtf((float)DH);
  float lg[2][NH];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int nt = 0; nt < NH; ++nt)
      lg[r][nt] = acc[4 * nt + 2 * r] * qv[nt].x + acc[4 * nt + 2 * r + 1] * qv[nt].y;
  const bool hi2 = (tig & 2) != 0, hi1 = (tig & 1) != 0;
  float l1[2][8], l2[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float keep = hi2 ? lg[r][i + 8] : lg[r][i], send = hi2 ? lg[r][i] : lg[r][i + 8];
      l1[r][i] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float keep = hi1 ? l1[r][i + 4] : l1[r][i], send = hi1 ? l1[r][i] : l1[r][i + 4];
      l2[r][i] = keep + __shfl_xor_sync(0xffffffffu, send, 1);
    }
  }
  // per head over the warp's 16 slots: max, exp-sum; e_w * p for the v half
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l0 = valid[0] ? l2[0][i] * lscale : -INFINITY;
    const float l1v = valid[1] ? l2[1][i] * lscale : -INFINITY;
    float mx = fmaxf(l0, l1v);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    const float p0 = mx == -INFINITY ? 0.f : expf(l0 - mx);
    const float p1 = mx == -INFINITY ? 0.f : expf(l1v - mx);
    float sm = p0 + p1;
    sm += __shfl_xor_sync(0xffffffffu, sm, 4);
    sm += __shfl_xor_sync(0xffffffffu, sm, 8);
    sm += __shfl_xor_sync(0xffffffffu, sm, 16);
    pw[g][4 * tig + i] = p0 * ew[0];
    pw[g + 8][4 * tig + i] = p1 * ew[1];
    if (g == 0) {
      xm[4 * tig + i] = mx;
      xs[4 * tig + i] = sm;
    }
  }
}

}  // namespace
