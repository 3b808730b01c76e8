// Single-query GQA decode attention over a padded KV cache row, for sm_90a,
// with the keys split across blocks.
//
// Replaces decode_attention_pallas (src/repro/kernels/flash_attention/decode.py:69).
//
// What bounds it on this card: one query token per (slot, head) against
// lengths[b] cached keys and values: ~4*hd FLOPs per key per query head
// against 2*hd elements read per key per kv head, so it is bound by bytes
// (the K/V cache read), far below the tensor-core rate.  A bytes-bound
// kernel needs enough loads in flight over the whole card, not tensor cores.
//
// Design, against the TPU kernel:
//  * The key range is split across blocks: grid (n_split, KV, B), each
//    block holding all G = H/KV query heads of its group as one warp each,
//    so each K/V row is read once per group (the Pallas grid (B, H, n_k)
//    re-reads the k/v tile for every head of the group).  A split is one
//    tile of kBK = 64 keys, so n_split = ceil(T / 64) follows the cache
//    capacity T alone; the wrapper computes it on the host (ops.py
//    decode_splits) and never reads lengths back (a host read per layer
//    per step would stall the host-bound serve path).  B 4, KV 8, T 1017 is
//    512 blocks on 132 SMs, where one block per (kv head, slot) gave 32
//    blocks each walking 1016 keys in series; T 29 is one split.
//  * The Pallas kernel's sequential k-tile axis with VMEM accumulators
//    (decode.py:30-66) becomes the split axis of the grid: each block's
//    tile stops at lengths[b], and keys past the length are never read
//    (decode.py:61).  A split that starts at or past the length loads
//    nothing and leaves an empty partial (m = -1e30, l = 0, acc = 0).
//    Lengths past T clamp to T.
//  * The splits merge in the same launch.  Each block writes (m, l, acc[hd])
//    for its G heads to scratch, and the last block to finish for a (slot,
//    kv head) merges them and writes o: it knows it is last by an atomic
//    ticket taken after __threadfence(), and resets the ticket to 0 for the
//    next call.  The tickets live in a buffer per (device, stream) that
//    the wrapper zeroes once, at first use, and the scratch comes from
//    torch.empty, so a call stays one launch and no memset.  With one split the block writes
//    o directly.  A zero-length row merges empty partials into exact zeros.
//  * The cache is read in place through its strides ([B, T, KV, hd] view of
//    the [n_units, B, T, KV, hd] segment cache): no transposed copy per step.
//  * The tile's softmax and the merge in f32 for both dtypes, with the
//    finite -1e30 mask; the tile is read with 16-byte loads, several in
//    flight per thread.
//  * Head dims 64, 80 and 128.  Lane l of a head's warp owns the output
//    columns l, l + 32, ... below HD: ceil(HD / 32) of them, the last one
//    guarded when 32 does not divide HD (zamba2's 80: columns 64-79 on
//    lanes 0-15 only).  A key row is HD / N 16-byte loads (10 in bf16, 20
//    in f32 at hd 80), so HD only has to be a multiple of 8.
#include "common.cuh"

namespace {

constexpr int kBK = 64;   // keys per tile, and per split

inline size_t decode_smem_bytes(int G, int HD) {
  // sQ [G][HD], sK [BK][HD+1], sV [BK][HD], sP [G][BK]
  return sizeof(float) * (static_cast<size_t>(G) * HD + kBK * (HD + 1) + kBK * HD + G * kBK);
}

// q/o: [B, 1, H, HD] contiguous; k/v: element (b, t, kvh, d) at
// b*sb + t*st + kvh*sh + d for t < Tk, with 16-byte aligned rows (every
// stride a multiple of 16 bytes); lengths: [B] int32.
// part: [B, H, n_split, HD + 2] f32 scratch (m, l, acc), unused with one
// split; tickets: [B * KV] int32, zero between calls.  Split i holds keys
// [i * kBK, (i + 1) * kBK).
// grid (n_split, KV, B); blockDim.x = 32 * G.
template <typename T, int HD>
__global__ void decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const int* __restrict__ lengths,
                                   T* __restrict__ o, float* __restrict__ part,
                                   int* __restrict__ tickets, int Tk, int H, int KV,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   float scale) {
  static_assert(HD % 8 == 0, "head dim: whole 16-byte loads and 4-wide dot products");
  constexpr int LD = HD + 1;
  constexpr int DPL = (HD + 31) / 32;   // output columns per lane, the last guarded
  // lane `lane` owns column lane + 32 i while it lies below HD
  const auto owns = [](int d) { return HD % 32 == 0 || d < HD; };
  constexpr int N = rk::Vec<T>::N;      // elements per 16-byte load
  constexpr int VPR = HD / N;           // 16-byte loads per key row
  constexpr int PW = HD + 2;            // floats per partial
  const int G = H / KV;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + G * HD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * HD;
  __shared__ int s_last;

  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int h = kvh * G + warp;
  // lengths past the cache are clamped to it, as the reference's mask
  // (arange(T) < lengths[b]) treats them
  const int len = min(max(lengths[b], 0), Tk);
  const int lo = split * kBK;
  const int hi = min(lo + kBK, len);

  for (int d = lane; d < HD; d += 32)
    sQ[warp * HD + d] = rk::to_f32(q[(static_cast<size_t>(b) * H + h) * HD + d]);

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  float m = rk::kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  __syncthreads();

  if (lo < hi) {
    // 16-byte loads, several in flight per thread before the shared stores
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * VPR; i += nthreads) {
      const int j = i / VPR, d = (i % VPR) * N;
      const int kj = lo + j;
      float kk[N], vv[N];
      if (kj < hi) {
        rk::Vec<T>::load(kb + kj * k_st + d, kk);
        rk::Vec<T>::load(vb + kj * v_st + d, vv);
      } else {
#pragma unroll
        for (int n = 0; n < N; ++n) kk[n] = vv[n] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < N; ++n) {
        sK[j * LD + d + n] = kk[n];
        sV[j * HD + d + n] = vv[n];
      }
    }
    __syncthreads();

    // this warp's head: scores for keys lane and lane + 32, each dot
    // product summed in four interleaved partial sums (independent FMA
    // chains: the block is latency-bound here, not issue-bound)
    float* pw = sP + warp * kBK;
    const float* qw = sQ + warp * HD;
    float tile_max = rk::kNegInf;
#pragma unroll
    for (int u = 0; u < kBK / 32; ++u) {
      const int j = lane + 32 * u;
      const float* kr = sK + j * LD;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int d = 0; d < HD; d += 4)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[r] = fmaf(qw[d + r], kr[d + r], part[r]);
      const float s = (lo + j < hi) ? ((part[0] + part[1]) + (part[2] + part[3])) * scale
                                    : rk::kNegInf;
      pw[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    m = rk::warp_max(tile_max);
    float psum = 0.f;
    for (int j = lane; j < kBK; j += 32) {
      const float p = expf(pw[j] - m);
      pw[j] = p;
      psum += p;
    }
    l = rk::warp_sum(psum);
    __syncwarp();

#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (!owns(d)) continue;
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kBK; j += 4)
#pragma unroll
        for (int r = 0; r < 4; ++r) part[r] = fmaf(pw[j + r], sV[(j + r) * HD + d], part[r]);
      acc[i] = (part[0] + part[1]) + (part[2] + part[3]);
    }
  }

  T* ob = o + (static_cast<size_t>(b) * H + h) * HD;
  if (n_split == 1) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (owns(lane + 32 * i)) ob[lane + 32 * i] = rk::from_f32<T>(acc[i] * inv);
    return;
  }

  // this split's partial for head h
  float* ph = part + (static_cast<size_t>(b) * H + h) * n_split * PW;
  float* mine = ph + split * PW;
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (owns(lane + 32 * i)) mine[2 + lane + 32 * i] = acc[i];
  if (lane == 0) {
    mine[0] = m;
    mine[1] = l;
  }
  // publish the partial, then take a ticket: the block that draws the last
  // one sees every other block's partial
  __threadfence();
  __syncthreads();
  int* ticket = tickets + b * KV + kvh;
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1) == n_split - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  float mx = rk::kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, __ldcg(ph + s * PW));
  float L = 0.f;
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float* ps = ph + s * PW;
    const float w = expf(__ldcg(ps) - mx);
    L += __ldcg(ps + 1) * w;
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      if (owns(lane + 32 * i)) acc[i] += __ldcg(ps + 2 + lane + 32 * i) * w;
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    if (owns(lane + 32 * i)) ob[lane + 32 * i] = rk::from_f32<T>(acc[i] * inv);
  if (threadIdx.x == 0) *ticket = 0;   // ready for the next call
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           float* part, int* tickets, int B, int Tk, int H, int KV, int n_split,
           long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, HD>;
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, HD);
  cudaError_t err = rk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_split, KV, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), part, tickets, Tk, H, KV, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_split must be ceil(T / 64), one split per kBK tile (ops.py
// decode_splits); with more than one split, part and tickets must be given
// (see decode_attn_kernel).
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* lengths, void* o, void* part, void* tickets,
                                    int B, int T, int H, int KV, int hd, int n_split,
                                    long long k_sb, long long k_st, long long k_sh,
                                    long long v_sb, long long v_st, long long v_sh,
                                    int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 32 || B <= 0 || T <= 0) return rk::kBadShape;
  if (n_split != (T + kBK - 1) / kBK || n_split > 65535) return rk::kBadShape;
  if (n_split > 1 && (part == nullptr || tickets == nullptr)) return rk::kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
#define RK_DECODE(TYPE, DIM)                                                         \
  launch<TYPE, DIM>(q, k, v, lengths, o, pf, tk, B, T, H, KV, n_split, k_sb, k_st, k_sh, \
                    v_sb, v_st, v_sh, st)
  if (dtype == rk::kF32) {
    if (hd == 64) return RK_DECODE(float, 64);
    if (hd == 80) return RK_DECODE(float, 80);
    if (hd == 128) return RK_DECODE(float, 128);
    return rk::kBadHeadDim;
  }
  if (dtype == rk::kBF16) {
    if (hd == 64) return RK_DECODE(__nv_bfloat16, 64);
    if (hd == 80) return RK_DECODE(__nv_bfloat16, 80);
    if (hd == 128) return RK_DECODE(__nv_bfloat16, 128);
    return rk::kBadHeadDim;
  }
#undef RK_DECODE
  return rk::kBadDType;
}
