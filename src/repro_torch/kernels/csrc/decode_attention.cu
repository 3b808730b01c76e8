// Single-query GQA decode attention over a padded KV cache row, for sm_90a.
//
// Replaces decode_attention_pallas (src/repro/kernels/flash_attention/decode.py:69).
//
// What bounds it on this card: one query token per (slot, head) against
// lengths[b] cached keys and values: ~4*hd FLOPs per key per query head
// against 2*hd elements read per key per kv head, so it is bound by bytes
// (the K/V cache read), far below the tensor-core rate.
//
// Design, against the TPU kernel:
//  * One block per (kv head, slot), holding all G = H/KV query heads of the
//    group as one warp each, so each K/V row is read from memory once per
//    group instead of once per query head (the Pallas grid (B, H, n_k)
//    re-reads the k/v tile for every head of the group).
//  * The Pallas kernel's sequential k-tile axis with VMEM accumulators
//    (decode.py:30-66) becomes a loop inside the block that stops at
//    lengths[b]: tiles past the length are never read (decode.py:61).  A
//    zero-length row runs no tile and writes zeros.
//  * The cache is read in place through its strides ([B, T, KV, hd] view of
//    the [n_units, B, T, KV, hd] segment cache): no transposed copy per step.
//  * Online softmax in f32 with the finite -1e30 mask.
//  * Each K/V tile is read with 16-byte loads, several in flight per thread:
//    the block is latency-bound on these loads, not bandwidth-bound.
//  * Simple first: one block per (kv head, slot) gives only B*KV blocks, too
//    few to fill 132 SMs at small batch; splitting the key range across
//    blocks (a second merge pass) is later work.
#include "common.cuh"

namespace {

constexpr int kBK = 64;   // keys per tile

inline size_t decode_smem_bytes(int G, int HD) {
  // sQ [G][HD], sK [BK][HD+1], sV [BK][HD], sP [G][BK]
  return sizeof(float) * (static_cast<size_t>(G) * HD + kBK * (HD + 1) + kBK * HD + G * kBK);
}

// q/o: [B, 1, H, HD] contiguous; k/v: element (b, t, kvh, d) at
// b*sb + t*st + kvh*sh + d for t < Tk, with 16-byte aligned rows (every
// stride a multiple of 16 bytes); lengths: [B] int32.
// grid (KV, B); blockDim.x = 32 * G.
template <typename T, int HD>
__global__ void decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                   const T* __restrict__ v, const int* __restrict__ lengths,
                                   T* __restrict__ o, int Tk, int H, int KV,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh,
                                   float scale) {
  static_assert(HD % 32 == 0, "head dim");
  constexpr int LD = HD + 1;
  constexpr int DPL = HD / 32;          // output columns per lane
  constexpr int N = rk::Vec<T>::N;      // elements per 16-byte load
  constexpr int VPR = HD / N;           // 16-byte loads per key row
  const int G = H / KV;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + G * HD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * HD;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nthreads = blockDim.x;
  const int h = kvh * G + warp;
  // lengths past the cache are clamped to it, as the reference's mask
  // (arange(T) < lengths[b]) treats them
  const int len = min(max(lengths[b], 0), Tk);

  for (int d = lane; d < HD; d += 32)
    sQ[warp * HD + d] = rk::to_f32(q[(static_cast<size_t>(b) * H + h) * HD + d]);

  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;
  float m = rk::kNegInf, l = 0.f;
  float acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < len; k0 += kBK) {
    // 16-byte loads, several in flight per thread before the shared stores
#pragma unroll 4
    for (int i = threadIdx.x; i < kBK * VPR; i += nthreads) {
      const int j = i / VPR, d = (i % VPR) * N;
      const int kj = k0 + j;
      float kk[N], vv[N];
      if (kj < len) {
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

    // this warp's head: scores for keys lane, lane + 32, ...
    float* pw = sP + warp * kBK;
    const float* qw = sQ + warp * HD;
    float tile_max = rk::kNegInf;
    for (int j = lane; j < kBK; j += 32) {
      const float* kr = sK + j * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qw[d], kr[d], s);
      s = (k0 + j < len) ? s * scale : rk::kNegInf;
      pw[j] = s;
      tile_max = fmaxf(tile_max, s);
    }
    const float m_new = fmaxf(m, rk::warp_max(tile_max));
    float psum = 0.f;
    for (int j = lane; j < kBK; j += 32) {
      const float p = expf(pw[j] - m_new);
      pw[j] = p;
      psum += p;
    }
    psum = rk::warp_sum(psum);
    const float corr = expf(m - m_new);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();

#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < kBK; ++j) s = fmaf(pw[j], sV[j * HD + d], s);
      acc[i] = acc[i] * corr + s;
    }
    __syncthreads();
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i)
    o[(static_cast<size_t>(b) * H + h) * HD + lane + 32 * i] = rk::from_f32<T>(acc[i] * inv);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const int* lengths, void* o,
           int B, int Tk, int H, int KV, long long k_sb, long long k_st, long long k_sh,
           long long v_sb, long long v_st, long long v_sh, cudaStream_t stream) {
  auto kern = decode_attn_kernel<T, HD>;
  const int G = H / KV;
  const size_t smem = decode_smem_bytes(G, HD);
  cudaError_t err = rk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(KV, B);
  kern<<<grid, 32 * G, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(o), Tk, H, KV, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
      1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const int* lengths, void* o, int B, int T, int H, int KV,
                                    int hd,
                                    long long k_sb, long long k_st, long long k_sh,
                                    long long v_sb, long long v_st, long long v_sh,
                                    int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > 32 || B <= 0) return rk::kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RK_DECODE(TYPE, DIM) \
  launch<TYPE, DIM>(q, k, v, lengths, o, B, T, H, KV, k_sb, k_st, k_sh, v_sb, v_st, v_sh, st)
  if (dtype == rk::kF32) {
    if (hd == 64) return RK_DECODE(float, 64);
    if (hd == 128) return RK_DECODE(float, 128);
    return rk::kBadHeadDim;
  }
  if (dtype == rk::kBF16) {
    if (hd == 64) return RK_DECODE(__nv_bfloat16, 64);
    if (hd == 128) return RK_DECODE(__nv_bfloat16, 128);
    return rk::kBadHeadDim;
  }
#undef RK_DECODE
  return rk::kBadDType;
}
