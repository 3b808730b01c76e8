// Fused tied-embedding exit head (token, confidence, entropy), for sm_90a.
//
// Replaces exit_confidence_pallas (src/repro/kernels/exit_head/kernel.py:78).
//
// Per row of h [rows, D] against the embedding emb [V, D], with scores
// s_v = h . emb_v, it keeps only the running max m, Z = sum e^(s-m),
// W = sum s e^(s-m) and the argmax (the first index wins on ties), and
// returns token, conf = 1/Z and entropy = m + log Z - W/Z.  The [rows, V]
// logits never reach memory.
//
// What bounds it on this card: the table read.  At the served shapes (2-4
// rows against a 32000-202112 x 2048-5120 bf16 table, 0.16-2.07 GB) it does
// 2 FLOPs a row for each 2-byte table element it reads once: 2-4 FLOPs a
// byte, against the ~295 at which the tensor cores, not HBM, would be the
// limit.
// So the design keeps HBM streaming on every SM from the first byte to the
// last, and keeps the fixed cost of a call (start, epilogue, merge) small.
//
// The Pallas grid sweeps the whole vocab in one sequence per row tile,
// carrying the accumulators in VMEM (kernel.py:17-18).  Here the vocab is
// split to fill the card:
//  * Tiles of kTile = 128 vocab rows; chunk c of n_chunks is a contiguous
//    run of whole tiles (chunk_tiles: runs differ by at most one tile, and
//    chunk c lies wholly before chunk c + 1).  The wrapper picks n_chunks =
//    min(tiles, 2 x SMs) (ops.exit_head_plan): two blocks an SM in one
//    wave, whatever V.
//  * bfloat16 (exit_head_wgmma): one producer thread streams the chunk's
//    table through a ring of TMA stages, each two 64-column K-slices of a
//    128-row table tile (2 x 16 KB, 128-byte swizzle) and the matching
//    N x 64 slices of h (h is small and stays in L2; TMA zero-fills its
//    rows past `rows`, the table's rows past V and both past D).  It fills
//    the ring before the block first synchronises.  Two blocks of 2 stages
//    keep 128 KB of table in flight on each SM, with no register spent on
//    the copy (on the H100 2 stages of 2 K-slices ran faster than 3 stages
//    of 2 and 5 stages of 1: PERF.md §6).  Two consumer
//    warpgroups take the tile's two 64-row halves on the tensor cores with
//    the operands swapped: the table tile is wgmma's A (64 x K, K-major, as
//    emb lies in memory) and h its B (N x K, K-major), so S^T [64 vocab, N
//    rows] accumulates in f32 over the tile's K-slices.  N is 16 for rows
//    <= 16 (every served call: one read of the table), 64 for 17-64; more
//    rows take row groups of N in grid.y, each reading the table again.
//  * The epilogue, once a tile: each thread folds its fragment's scores
//    (2 vocab rows x N/4 hidden rows) into one running state per hidden
//    row, skipping vocab rows >= V and hidden rows >= rows.  The fragment
//    layout visits vocab indices in no useful order, so the fold keeps the
//    larger score and on equal scores the smaller index, in any order.  At
//    the chunk's end the 8 lanes that hold a hidden row merge by shuffles,
//    then the 8 consumer warps through shared memory in warp order, both
//    max-first (merge_lanes, merge_warps).
//  * float32 (exit_head_f32): CUDA cores, as wgmma has no exact f32.  A
//    warp streams whole embedding rows with 16-byte loads against 4 rows
//    of h in shared memory (row groups of 4 in grid.y), on the same chunk
//    plan and the same merges.
//  * One launch: each block writes one partial (m, Z, W, argmax) per row,
//    takes a ticket, and the block that draws the last ticket of its row
//    group merges the group's partials (finish), writes the outputs and
//    returns the ticket to 0.  The order of every sum is fixed, so a call
//    is deterministic: the same inputs give the same bits.
#include <climits>

#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps

namespace {

using namespace rk;

constexpr int kTile = 128;        // vocab rows a tile (two wgmma M-halves of 64)
constexpr int kMergeBatch = 16;   // most partials a lane of the merging block loads

struct Acc {
  float m, z, w;
  int a;
};

__device__ __forceinline__ Acc acc_empty() { return {kNegInf, 0.f, 0.f, INT_MAX}; }

// Fold one score s at vocab index v into a running state, v in any order:
// the larger score wins the argmax, on equal scores the smaller index.
__device__ __forceinline__ void acc_fold(Acc& x, float s, int v) {
  if (s > x.m || (s == x.m && v < x.a)) {
    const float c = expf(x.m - s);
    x.z = x.z * c + 1.f;
    x.w = x.w * c + s;
    x.m = s;
    x.a = v;
  } else {
    const float e = expf(s - x.m);
    x.z += e;
    x.w += s * e;
  }
}

// Every merge of states below runs max-first: the largest maximum M, then
// the sums Z e^(m - M) and W e^(m - M) added in a fixed order, and the
// least argmax among the states whose maximum is M (so the first index
// wins a tie, whatever the order).

// A state merged across the lanes o0, 2 o0, ... < 32 apart (a butterfly:
// neighbours first); every lane of a group ends with the same bits.
__device__ __forceinline__ Acc merge_lanes(const Acc& x, int o0) {
  float mx = x.m;
#pragma unroll
  for (int o = o0; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float e = expf(x.m - mx);
  Acc r{mx, x.z * e, x.w * e, x.m == mx ? x.a : INT_MAX};
#pragma unroll
  for (int o = o0; o < 32; o <<= 1) {
    r.z += __shfl_xor_sync(0xffffffffu, r.z, o);
    r.w += __shfl_xor_sync(0xffffffffu, r.w, o);
    r.a = min(r.a, __shfl_xor_sync(0xffffffffu, r.a, o));
  }
  return r;
}

// Row i's states left in shared memory by the block's W warps, merged in
// warp order.
template <int W, int R>
__device__ __forceinline__ Acc merge_warps(const Acc (&s)[W][R], int i) {
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < W; ++w) mx = fmaxf(mx, s[w][i].m);
  Acc r{mx, 0.f, 0.f, INT_MAX};
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const Acc x = s[w][i];
    const float e = expf(x.m - mx);
    r.z += x.z * e;
    r.w += x.w * e;
    if (x.m == mx) r.a = min(r.a, x.a);
  }
  return r;
}

// Tiles [t0, t1) of chunk c: n_tiles = ceil(V / kTile) split into n_chunks
// contiguous runs, the first n_tiles % n_chunks one tile longer
// (ops.chunk_tiles is the same function).
__device__ __forceinline__ void chunk_tiles(int c, int V, int n_chunks, int& t0, int& t1) {
  const int n_tiles = (V + kTile - 1) / kTile;
  const int q = n_tiles / n_chunks, r = n_tiles % n_chunks;
  t0 = c * q + min(c, r);
  t1 = t0 + q + (c < r ? 1 : 0);
}

// Called by every thread of the block; thread i < nrows holds the block's
// state of row r0 + i.  Writes the block's partials to part [rows,
// n_chunks], takes a ticket, and in the block that draws the last one
// merges each row's partials (a warp a row): lane l merges its own
// contiguous run of chunks in chunk order, then merge_lanes joins the
// lanes, neighbouring runs first.  That block writes the outputs and
// returns the ticket to 0.
__device__ void finish(const Acc& mine, int r0, int nrows, int c, int n_chunks,
                       float4* __restrict__ part, int* __restrict__ ticket,
                       int* __restrict__ tok, float* __restrict__ conf,
                       float* __restrict__ ent) {
  __shared__ int s_last;
  if (static_cast<int>(threadIdx.x) < nrows)
    part[static_cast<size_t>(r0 + threadIdx.x) * n_chunks + c] =
        make_float4(mine.m, mine.z, mine.w, __int_as_float(mine.a));
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == n_chunks - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per = (n_chunks + 31) / 32;   // <= kMergeBatch (exit_head_fwd)
  const int c0 = min(n_chunks, lane * per), n = min(n_chunks, c0 + per) - c0;
  for (int r = warp; r < nrows; r += blockDim.x / 32) {
    const float4* pr = part + static_cast<size_t>(r0 + r) * n_chunks + c0;
    float4 p[kMergeBatch];   // (m, Z, W, argmax bits) of the lane's chunks, loaded at once
    Acc t = acc_empty();
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      if (i < n) {
        p[i] = __ldcg(pr + i);
        t.m = fmaxf(t.m, p[i].x);
      }
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i)
      if (i < n) {
        const float e = expf(p[i].x - t.m);
        t.z += p[i].y * e;
        t.w += p[i].z * e;
        if (p[i].x == t.m) t.a = min(t.a, __float_as_int(p[i].w));
      }
    t = merge_lanes(t, 1);
    if (lane == 0) {
      const float z = fmaxf(t.z, 1e-30f);
      tok[r0 + r] = t.a;
      conf[r0 + r] = 1.f / z;
      ent[r0 + r] = t.m + logf(z) - t.w / z;
    }
  }
  if (threadIdx.x == 0) *ticket = 0;   // ready for the next call
}

// ------------------------------------------------------------------ bf16

constexpr int kK = 64;                       // hidden columns a K-slice: one 128-byte swizzle span
constexpr int kTabBytes = kTile * kK * 2;    // one K-slice of a table tile, 16 KB
constexpr int kSlices = 2;                   // K-slices a stage
constexpr int kStages16 = 2;                 // ring stages at N = 16
constexpr int kConsumers = 256;              // warpgroups 0-1: the tile's two 64-row halves
constexpr int kThreads = kConsumers + 32;    // warp 8: the producer

// Shared memory: `stages` stages of [kSlices table K-slices | kSlices h
// slices], each 1024-byte aligned (the 128-byte swizzle repeats every 8
// rows of 128 bytes), then the full and empty mbarriers.
template <int N>
struct Smem {
  static constexpr int stages = N == 16 ? kStages16 : 4;
  static constexpr int h_off = kSlices * kTabBytes;
  static constexpr int h_bytes = N * kK * 2;
  static constexpr int stage = kSlices * (kTabBytes + h_bytes);
  static constexpr int bar_off = stages * stage;
  static constexpr int alloc = bar_off + 8 * 2 * stages + 1024;   // + room to align the base
};

// d (+)= A B for one K-slice of 16: m64n16k16 or m64n64k16
template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 16) wgmma_ss_n16(d, da, db, scale_d);
  else wgmma_ss(d, da, db, scale_d);
}

// grid (n_chunks, ceil(rows / N)).  Accumulator fragment of m64nN (f32),
// thread `lane` of warp w of the warpgroup: d[4j + e] is vocab row 16w +
// lane/4 + 8 (e >> 1) of the warpgroup's 64 and hidden row (column) 8j +
// 2 (lane % 4) + (e & 1); st[2j + (e & 1)] is this thread's state of that
// hidden row.
template <int N>
__global__ void __launch_bounds__(kThreads, N == 16 ? 2 : 1)
exit_head_wgmma(const __grid_constant__ CUtensorMap tm_e, const __grid_constant__ CUtensorMap tm_h,
                int rows, int D, int V, int n_chunks, float4* __restrict__ part,
                int* __restrict__ tickets, int* __restrict__ tok, float* __restrict__ conf,
                float* __restrict__ ent) {
  using L = Smem<N>;
  constexpr int ST = L::stages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Acc sAcc[kConsumers / 32][N];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar_off;
  const auto bar_full = [&](int s) { return bars + 8u * s; };
  const auto bar_empty = [&](int s) { return bars + 8u * (ST + s); };

  const int c = blockIdx.x;
  const int r0 = blockIdx.y * N;
  const int nrows = min(N, rows - r0);
  int t0, t1;
  chunk_tiles(c, V, n_chunks, t0, t1);
  const int nk = (D + kSlices * kK - 1) / (kSlices * kK);   // stages a tile
  const int n_it = (t1 - t0) * nk;                           // stages the block consumes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == kConsumers;   // one thread issues every TMA load

  // stage `it` of the block: tile t0 + it / nk, K-columns from (it % nk) kSlices kK
  const auto load = [&](int it) {
    const int s = it % ST, t = t0 + it / nk;
    mbar_expect_tx(bar_full(s), L::stage);
    for (int j = 0; j < kSlices; ++j) {
      const int col = (it % nk * kSlices + j) * kK;   // past D: zero fill
      tma_load_2d(base + s * L::stage + j * kTabBytes, &tm_e, bar_full(s), col, t * kTile);
      tma_load_2d(base + s * L::stage + L::h_off + j * L::h_bytes, &tm_h, bar_full(s), col, r0);
    }
  };
  // the producer sets up the barriers and fills the ring before the block
  // first synchronises, so the first bytes are on their way at once
  if (producer) {
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_e)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_h)) : "memory");
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumers / 32);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < min(ST, n_it); ++it) load(it);
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: the rest of the ring, a stage as soon as it is empty
    if (producer) {
      for (int it = ST; it < n_it; ++it) {
        mbar_wait(bar_empty(it % ST), ((it / ST) - 1) & 1);
        load(it);
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: warpgroup g owns vocab rows 64 g ... 64 g + 63 of a tile
    const int g = warp / 4, q = lane % 4;
    const int vrow = g * 64 + (warp % 4) * 16 + lane / 4;   // and vrow + 8
    Acc st[N / 4];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) st[i] = acc_empty();
    float acc[N / 2];
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
    int it = 0;
    for (int t = t0; t < t1; ++t) {
      for (int k = 0; k < nk; ++k, ++it) {
        const int s = it % ST;
        mbar_wait(bar_full(s), (it / ST) & 1);
        const uint32_t a = base + s * L::stage + g * (kTabBytes / 2);
        const uint32_t b = base + s * L::stage + L::h_off;
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kSlices; ++j)
#pragma unroll
          for (int kk = 0; kk < kK / 16; ++kk)
            mma<N>(acc, desc_kmajor(a + j * kTabBytes + kk * 32),
                   desc_kmajor(b + j * L::h_bytes + kk * 32), (k | j | kk) != 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(s));
      }
      // the tile's scores are complete: fold them
      const int v = t * kTile + vrow;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2) {
          if (8 * j + 2 * q + b2 >= nrows) continue;
#pragma unroll
          for (int h8 = 0; h8 < 2; ++h8)
            if (v + 8 * h8 < V) acc_fold(st[2 * j + b2], acc[4 * j + 2 * h8 + b2], v + 8 * h8);
        }
    }
    // the 8 lanes holding a hidden row (lane / 4 = 0..7), then the warps
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      if (8 * (i / 2) < nrows) st[i] = merge_lanes(st[i], 4);   // a group of 8 rows holding one
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int b2 = 0; b2 < 2; ++b2) sAcc[warp][8 * j + 2 * lane + b2] = st[2 * j + b2];
    }
  }
  __syncthreads();
  const Acc mine = static_cast<int>(threadIdx.x) < nrows ? merge_warps(sAcc, threadIdx.x)
                                                          : acc_empty();
  finish(mine, r0, nrows, c, n_chunks, part, tickets + blockIdx.y, tok, conf, ent);
}

template <int N>
int launch_bf16(const void* h, const void* emb, int rows, int D, int V, int n_chunks,
                float4* part, int* tickets, int* tok, float* conf, float* ent,
                cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoDriverEntry;
  CUtensorMap te, th;
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  if (!encode_2d(fn, &te, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, emb, D, V, row, kK, kTile,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(fn, &th, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, D, rows, row, kK, N,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return kTensorMap;
  auto kern = exit_head_wgmma<N>;
  constexpr size_t smem = Smem<N>::alloc;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_chunks, (rows + N - 1) / N);
  kern<<<grid, kThreads, smem, stream>>>(te, th, rows, D, V, n_chunks, part, tickets, tok,
                                         conf, ent);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ f32

constexpr int kRowsF32 = 4;          // rows of h a block (gridDim.y covers the rest)
constexpr int kThreadsF32 = 256;     // 8 warps

// grid (n_chunks, ceil(rows / kRowsF32)); dynamic smem: kRowsF32 * D floats.
__global__ void __launch_bounds__(kThreadsF32)
exit_head_f32(const float* __restrict__ h, const float* __restrict__ emb, int rows, int D,
              int V, int n_chunks, float4* __restrict__ part, int* __restrict__ tickets,
              int* __restrict__ tok, float* __restrict__ conf, float* __restrict__ ent) {
  constexpr int N = Vec<float>::N;
  extern __shared__ __align__(16) float sH[];
  __shared__ Acc sAcc[kThreadsF32 / 32][kRowsF32];

  const int c = blockIdx.x;
  const int r0 = blockIdx.y * kRowsF32;
  const int nrows = min(kRowsF32, rows - r0);
  for (int i = threadIdx.x; i < kRowsF32 * D; i += kThreadsF32)
    sH[i] = i / D < nrows ? h[static_cast<size_t>(r0) * D + i] : 0.f;
  __syncthreads();

  int t0, t1;
  chunk_tiles(c, V, n_chunks, t0, t1);
  const int v0 = t0 * kTile, v1 = min(V, t1 * kTile);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  Acc st = acc_empty();   // lane r < kRowsF32 holds row r's state
  for (int vi = v0 + warp; vi < v1; vi += kThreadsF32 / 32) {
    const float* e = emb + static_cast<size_t>(vi) * D;
    float s[kRowsF32];
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = lane * N; d < D; d += 32 * N) {
      float ev[N], hv[N];
      Vec<float>::load(e + d, ev);
#pragma unroll
      for (int r = 0; r < kRowsF32; ++r) {
        Vec<float>::load(sH + r * D + d, hv);
#pragma unroll
        for (int i = 0; i < N; ++i) s[r] = fmaf(hv[i], ev[i], s[r]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kRowsF32; ++r) {
      const float t = warp_sum(s[r]);
      if (lane == r) mine = t;
    }
    if (lane < nrows) acc_fold(st, mine, vi);
  }
  if (lane < kRowsF32) sAcc[warp][lane] = st;
  __syncthreads();
  const Acc mine = static_cast<int>(threadIdx.x) < nrows ? merge_warps(sAcc, threadIdx.x)
                                                          : acc_empty();
  finish(mine, r0, nrows, c, n_chunks, part, tickets + blockIdx.y, tok, conf, ent);
}

int launch_f32(const void* h, const void* emb, int rows, int D, int V, int n_chunks,
               float4* part, int* tickets, int* tok, float* conf, float* ent,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * kRowsF32 * static_cast<size_t>(D);
  cudaError_t err = allow_smem(exit_head_f32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_chunks, (rows + kRowsF32 - 1) / kRowsF32);
  exit_head_f32<<<grid, kThreadsF32, smem, stream>>>(static_cast<const float*>(h),
                                                     static_cast<const float*>(emb), rows, D,
                                                     V, n_chunks, part, tickets, tok, conf, ent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: [rows, D], emb: [V, D], both contiguous and 16-byte aligned, D a
// multiple of 8 (16-byte rows for TMA and the f32 loads).  n_chunks from
// ops.exit_head_plan, 1 <= n_chunks <= ceil(V / 128).  part: [rows,
// n_chunks] float4 scratch; tickets: at least ceil(rows / 4) int32
// counters, zero between calls (each call leaves them zero).
extern "C" int exit_head_fwd(const void* h, const void* emb, int rows, int D, int V,
                             int n_chunks, void* part, void* tickets, int* tok, float* conf,
                             float* ent, int dtype, void* stream) {
  if (rows <= 0 || V <= 0 || D <= 0 || D % 8 != 0) return kBadShape;
  if (n_chunks < 1 || n_chunks > (V + kTile - 1) / kTile || n_chunks > 32 * kMergeBatch)
    return kBadShape;
  if ((rows + kRowsF32 - 1) / kRowsF32 > 65535) return kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* pf = static_cast<float4*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == kF32) return launch_f32(h, emb, rows, D, V, n_chunks, pf, tk, tok, conf, ent, st);
  if (dtype == kBF16) {
    if (rows <= 16)
      return launch_bf16<16>(h, emb, rows, D, V, n_chunks, pf, tk, tok, conf, ent, st);
    return launch_bf16<64>(h, emb, rows, D, V, n_chunks, pf, tk, tok, conf, ent, st);
  }
  return kBadDType;
}
