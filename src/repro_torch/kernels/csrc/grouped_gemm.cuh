// Grouped int8 x int8 -> exact int32 products for the MoE experts: G2
// (the gate and up products with K2's CORDIC SwiGLU epilogue) and G1
// (the down projection with K1's epilogues).
//
// Replaces no TPU kernel: the reference computes the experts as XLA
// batched dots (src/repro/models/moe.py:64, _fused_expert_mlp).  A launch
// runs G problems of one shape, A (G, M, K) and each B (G, K, N),
// row-major int8, with RAGGED rows: the M rows of a group are L lane
// blocks of C = M / L, and row l*C + j of group g is live iff j <
// rows[g, l] (rows == null: every row live).  A dead row reads as zero,
// so its output is the epilogue of a zero accumulator, written exactly
// (the caller's combine and the next quantization read every row).
//
// What bounds it on the H100: at decode (a lane's token picks an expert
// at most once, so a group holds at most L live rows) the bytes of the
// LIVE experts' weights, read once; at the long prefills the int8
// operations of the live rows (G2 also its CORDIC epilogue, ~300
// integer operations an output).  What the design does about it:
//   * the rows are read on the device: every block sums its groups'
//     live rows and tiles only those, compacted (a tile's rows come from
//     a row map, not from M padded rows), so a group with no live row
//     reads none of its weights and no work waits on a host sync;
//   * tiles are sized to the capacity: 32 rows for C <= 16 (decode,
//     segments) with an 8-deep cp.async ring, 64 rows otherwise
//     (granite's 120 in two), 128 where K >= 4096 and they pad no more
//     rows than 64 would (jamba's 80, mixtral's 4500-token 1408), by 128
//     bytes of columns (G2: 64 of each of its B);
//   * a persistent scheduler: 1 or 2 blocks an SM, each of two consumer
//     groups of four warps with a ring of its own, walk the (group,
//     column tile, row tile) items that hold a live row round robin (the
//     row tiles of one column tile side by side, so the second reads B
//     from L2), then the dead rows;
//   * a group's k loop is int8_gemm.cuh's (mma.sync s8, B read k-major
//     out of its row-major tile by the permuted ldmatrix .trans); the
//     groups run unsynchronised, so one's epilogue overlaps the others'
//     k loops (forcing them to take turns, a ping-pong on named
//     barriers, was slower on most grouped shapes on the card);
//   * the epilogue goes through shared memory: the accumulators are
//     staged in the group's (now idle) ring, a thread takes 4 adjacent
//     columns of a row, computes them together (G2: cordic.cuh's
//     sigmoid_q16_n, one rotation and one division a gate whatever its
//     path) and stores 16 bytes.
// Integer sums are exact in any order (K <= 2**17), so neither the tile
// shape nor the compaction changes a bit.
#pragma once

#include "int8_gemm.cuh"

namespace rq {

// the rows contract: rows (G, L) int32 on the device or null, C = M / L
struct Ragged {
  const int32_t* rows;
  int L, C;
};

constexpr int GG_THREADS = 256, GG_GROUP = 128;  // two consumer groups of four warps
// blocks an SM: two of 64-row tiles; one of 128-row tiles (128
// accumulators a thread) and of decode's 32-row tiles (an 8-deep ring)
constexpr int gg_blocks_per_sm(int mt) { return mt == 2 ? 2 : 1; }
constexpr int GG_DEAD_ROWS = 8;           // rows of a dead-row item
// bytes of the block's schedule in shared memory (two blocks of 64-row
// tiles still fit an SM; a launch past it returns cudaErrorInvalidValue)
constexpr int GG_MAX_SCHEDULE = 8192;

// a named barrier of n threads (one consumer group's)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <int NB, int MT, int STAGES>
struct GgTile {
  static constexpr int BM = 32 * MT;               // rows of a tile
  static constexpr int BN = TC_ROW / NB;           // columns of each B in a tile
  static constexpr int STAGE = BM * TC_BK + TC_B_BYTES;
  static constexpr int RING = STAGES * STAGE;      // bytes of one group's ring
  static constexpr int SP = BN + 16;               // staged row pitch (ints; 64 mod 128 bytes)
  static_assert(NB * BM * SP * 4 <= RING, "the staged accumulators fit the idle ring");
};

// one consumer group's cp.async stage: A's rows through the row map
// (-1: a zero row), B's 64 k rows of the tile's columns
template <int NB, int MT>
__device__ __forceinline__ void load_stage_rows(int8_t* st, const int8_t* __restrict__ A,
                                                BMats<NB> B, const int* rmap, int N, int K,
                                                int n0, int k0, bool vec, int tid) {
  constexpr int BM = 32 * MT, BCH = TC_ROW / NB / 16;
  for (int i = tid; i < BM * (TC_BK / 16); i += GG_GROUP) {
    const int r = i / (TC_BK / 16), c = i % (TC_BK / 16), k = k0 + 16 * c, src = rmap[r];
    copy16(st + a_off(r, c), A + static_cast<size_t>(src < 0 ? 0 : src) * K + k, A, src >= 0,
           K - k, vec);
  }
  int8_t* bs = st + BM * TC_BK;
  for (int i = tid; i < TC_BK * (TC_ROW / 16); i += GG_GROUP) {
    const int r = i / (TC_ROW / 16), c = i % (TC_ROW / 16), k = k0 + r;
    const int n = n0 + 16 * (c % BCH);
    const int8_t* b = c < BCH ? B.b[0] : B.b[NB - 1];
    copy16(bs + b_off(r, c), b + static_cast<size_t>(k) * N + n, b, k < K, N - n, vec);
  }
}

// Epi: quad(z, m, n, acc4, acc4') writes the 4 outputs at columns n..n+3
// of group z's row m (16-byte stores); zero_quad(z, m, n, zc) the same
// for a zero accumulator, with zc = zero_consts() computed once.
template <int NB, int MT, int STAGES, class Epi>
__global__ void __launch_bounds__(GG_THREADS, gg_blocks_per_sm(MT))
    grouped_tc(const int8_t* __restrict__ A, BMats<NB> B, int G, int M, int N, int K, Ragged rg,
               Epi epi, int vec) {
  using T = GgTile<NB, MT, STAGES>;
  constexpr int BM = T::BM, BN = T::BN, WN = BN / 2, NG = WN / 16;
  extern __shared__ __align__(128) int8_t gg_smem[];
  // the schedule: cum[g * (L + 1) + l] live rows of group g before lane
  // block l; items[g] live items before group g; a row map per group
  const int L1 = rg.L + 1;
  int* cum = reinterpret_cast<int*>(gg_smem + 2 * T::RING);
  int* items = cum + G * L1;
  const int NT = (N + BN - 1) / BN;
  for (int g = threadIdx.x; g < G; g += GG_THREADS) {
    int s = 0;
    for (int l = 0; l < rg.L; ++l) {
      cum[g * L1 + l] = s;
      s += rg.rows ? imin(imax(rg.rows[g * rg.L + l], 0), rg.C) : rg.C;
    }
    cum[g * L1 + rg.L] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int g = 0; g < G; ++g) {
      items[g] = s;
      s += (cum[g * L1 + rg.L] + BM - 1) / BM * NT;
    }
    items[G] = s;
  }
  __syncthreads();
  const int n_items = items[G];
  const int cg = threadIdx.x / GG_GROUP, tid = threadIdx.x % GG_GROUP;
  const int workers = 2 * gridDim.x, me = 2 * blockIdx.x + cg;
  int8_t* ring = gg_smem + cg * T::RING;
  int* rmap = items + G + 1 + cg * BM;
  const int bar_own = 1 + cg;
  const int lane = tid % 32, gw = tid / 32, wm = gw / 2, wn = gw % 2;
  const int nk = (K + TC_BK - 1) / TC_BK;
  // ldmatrix .trans row of this lane within a 32-deep k step
  const int lm = lane / 8, lj = lane % 8;
  const int k_lane = (lm / 2) * 16 + (lj & 1) + ((lj >> 1) << 2) + 2 * (lm & 1);

  for (int it = me; it < n_items; it += workers) {
    int g = 0;
    for (int lo = 0, hi = G - 1; lo <= hi;) {  // the last group with items[g] <= it
      const int mid = (lo + hi) / 2;
      if (items[mid] <= it) g = mid, lo = mid + 1;
      else hi = mid - 1;
    }
    const int* cg_cum = cum + g * L1;
    const int live = cg_cum[rg.L], tiles = (live + BM - 1) / BM;
    const int local = it - items[g], t = local % tiles, n0 = (local / tiles) * BN;
    const int nlive = imin(BM, live - t * BM);
    for (int r = tid; r < BM; r += GG_GROUP) {
      int src = -1;
      if (r < nlive) {
        const int j = t * BM + r;
        int l = 0;
        while (cg_cum[l + 1] <= j) ++l;
        src = l * rg.C + (j - cg_cum[l]);
      }
      rmap[r] = src;
    }
    bar_sync(bar_own, GG_GROUP);
    const int8_t* Ag = A + static_cast<size_t>(g) * M * K;
    BMats<NB> Bg;
#pragma unroll
    for (int b = 0; b < NB; ++b) Bg.b[b] = B.b[b] + static_cast<size_t>(g) * K * N;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage_rows<NB, MT>(ring + s * T::STAGE, Ag, Bg, rmap, N, K, n0, s * TC_BK, vec, tid);
      asm volatile("cp.async.commit_group;\n" ::);
    }

    int acc[NB][MT][2 * NG][4];
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * NG; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[b][mt][nt][e] = 0;
    for (int kt = 0; kt < nk; ++kt) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
      // tile kt has landed; the group is done with tile kt - 1's stage
      bar_sync(bar_own, GG_GROUP);
      const int nxt = kt + STAGES - 1;
      if (nxt < nk)
        load_stage_rows<NB, MT>(ring + (nxt % STAGES) * T::STAGE, Ag, Bg, rmap, N, K, n0,
                                nxt * TC_BK, vec, tid);
      asm volatile("cp.async.commit_group;\n" ::);
      const int8_t* as = ring + (kt % STAGES) * T::STAGE;
      const int8_t* bs = as + BM * TC_BK;
#pragma unroll
      for (int ks = 0; ks < TC_BK / 32; ++ks) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldsm_x4(af[mt], as + a_off(wm * 16 * MT + mt * 16 + lane % 16, 2 * ks + lane / 16));
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int ng = 0; ng < NG; ++ng) {
            uint32_t r[4];
            ldsm_x4_t(r, bs + b_off(32 * ks + k_lane, b * (BN / 16) + wn * (WN / 16) + ng));
            const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), o0 = __byte_perm(r[0], r[1], 0x7531);
            const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420), o1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_s8(acc[b][mt][2 * ng], af[mt], e0, e1);
              mma_s8(acc[b][mt][2 * ng + 1], af[mt], o0, o1);
            }
          }
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    bar_sync(bar_own, GG_GROUP);  // every warp is done reading the ring

    // stage the accumulators: lane (g, t) holds columns 16 ng + 4t .. +3
    // of rows g and g + 8 of each m16 tile (even tile: +0, +2; odd: +1, +3)
    int* stg = reinterpret_cast<int*>(ring);
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int ng = 0; ng < NG; ++ng)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * 16 * MT + mt * 16 + lane / 4 + 8 * h;
            const int col = wn * WN + 16 * ng + 4 * (lane % 4);
            const int4 v = make_int4(acc[b][mt][2 * ng][2 * h], acc[b][mt][2 * ng + 1][2 * h],
                                     acc[b][mt][2 * ng][2 * h + 1],
                                     acc[b][mt][2 * ng + 1][2 * h + 1]);
            *reinterpret_cast<int4*>(stg + (b * BM + row) * T::SP + col) = v;
          }
    bar_sync(bar_own, GG_GROUP);
    // a warp's lanes walk a row's column quads: 16-byte reads and stores
    constexpr int QR = BN / 4;
    for (int q = tid; q < nlive * QR; q += GG_GROUP) {
      const int r = q / QR, c = 4 * (q % QR), n = n0 + c;
      if (n < N)
        epi.quad(g, rmap[r], n, *reinterpret_cast<const int4*>(stg + r * T::SP + c),
                 *reinterpret_cast<const int4*>(stg + ((NB - 1) * BM + r) * T::SP + c));
    }
    bar_sync(bar_own, GG_GROUP);  // the staging is read before the ring refills
  }

  // the dead rows: a zero accumulator's outputs, every column
  if (rg.rows == nullptr) return;
  const auto zc = epi.zero_consts();
  const int chunks = (M + GG_DEAD_ROWS - 1) / GG_DEAD_ROWS;
  for (int d = me; d < G * chunks; d += workers) {
    const int g = d / chunks, r1 = imin((d % chunks + 1) * GG_DEAD_ROWS, M);
    for (int r = (d % chunks) * GG_DEAD_ROWS; r < r1; ++r) {
      const int l = r / rg.C;
      if (r - l * rg.C < cum[g * L1 + l + 1] - cum[g * L1 + l]) continue;  // live
      for (int n = 4 * tid; n < N; n += 4 * GG_GROUP) epi.zero_quad(g, r, n, zc);
    }
  }
}

template <int NB, int MT, int STAGES, class Epi>
int launch_grouped_tiles(const int8_t* A, BMats<NB> B, int G, int M, int N, int K, Ragged rg,
                         Epi epi, bool vec, cudaStream_t stream) {
  using T = GgTile<NB, MT, STAGES>;
  const size_t schedule = (static_cast<size_t>(G) * (rg.L + 1) + G + 1 + 2 * T::BM) * 4;
  if (schedule > GG_MAX_SCHEDULE) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * T::RING + schedule;
  cudaError_t err = cudaFuncSetAttribute(grouped_tc<NB, MT, STAGES, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  static int sms = 0;  // one card a process
  if (sms == 0) {
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  grouped_tc<NB, MT, STAGES, Epi><<<gg_blocks_per_sm(MT) * sms, GG_THREADS, smem, stream>>>(
      A, B, G, M, N, K, rg, epi, vec);
  return static_cast<int>(cudaGetLastError());
}

// launch G ragged problems on `stream` (N and K multiples of 4, M = L *
// C); returns the first CUDA error
template <int NB, class Epi>
int launch_grouped(const int8_t* A, BMats<NB> B, int G, int M, int N, int K, Ragged rg, Epi epi,
                   cudaStream_t stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool vec = K % 16 == 0 && N % 16 == 0 && aligned(A);
  for (int b = 0; b < NB; ++b) vec = vec && aligned(B.b[b]);
  // decode and segments: 32-row tiles, an 8-deep ring (bytes in flight)
  if (rg.C <= 16) return launch_grouped_tiles<NB, 1, 8>(A, B, G, M, N, K, rg, epi, vec, stream);
  // deep K (the long k loops pay for the taller tile) where 128-row tiles
  // pad no more rows than 64-row ones: jamba's C = 80, mixtral's 1408
  if (K >= 4096 && (rg.C + 127) / 128 * 128 <= (rg.C + 63) / 64 * 64)
    return launch_grouped_tiles<NB, 4, 5>(A, B, G, M, N, K, rg, epi, vec, stream);
  return launch_grouped_tiles<NB, 2, 4>(A, B, G, M, N, K, rg, epi, vec, stream);
}

}  // namespace rq
