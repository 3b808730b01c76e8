// Causal (or full) GQA flash-attention forward for prefill, for sm_90a.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:68).
//
// What bounds it on this card: at the serving shapes (B 4, H 32, KV 8,
// hd 64, S up to ~1000) the work is ~2*2*B*H*S*S/2*hd FLOPs against a few
// MB of q/k/v, so it is bound by operations, not bytes.  This first version
// does the products on the CUDA cores in f32 out of shared memory, which is
// far below the tensor-core peak; wgmma tiles, TMA loads and a persistent
// schedule are later work.
//
// Design, against the TPU kernel:
//  * One block per (q-tile, head, batch) reads kv head h / (H/KV): GQA needs
//    no repeated k/v.
//  * The Pallas grid walks k-tiles as a sequential grid axis and carries the
//    online-softmax state in VMEM scratch (kernel.py:31-35, :62-65).  Blocks
//    carry nothing between them on Hopper, so a loop over k-tiles inside the
//    block takes that place, and it stops at the causal diagonal: tiles
//    above it are never loaded (the block-pruned causality of kernel.py:58).
//  * Online softmax in f32 with the finite -1e30 mask, as the reference.
//  * The ragged last q- and k-tile are masked instead of asserting that S
//    and T divide into blocks (kernel.py:77): serving prompts are 12 long.
//  * The causal diagonal is aligned bottom-right (key j is visible to query
//    i when j <= i + T - S), as ref.attention; with S == T it is j <= i.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;

template <int HD>
constexpr size_t flash_smem_bytes() {
  // sQ [BQ][HD+1], sK [BK][HD+1], sV [BK][HD], sP [BQ][BK+1], m/l/corr [BQ]
  return sizeof(float) * (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
                          kBQ * (kBK + 1) + 3 * kBQ);
}

// q/o: [B, S, H, HD]; k/v: [B, T, KV, HD]; all contiguous and 16-byte
// aligned.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int H, int KV, int causal, float scale) {
  static_assert(HD % 32 == 0 && (kThreads % HD == 0 || HD % kThreads == 0), "head dim");
  constexpr int LD = HD + 1;           // padded rows: column reads hit distinct banks
  constexpr int LP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * HD;
  float* sM = sP + kBQ * LP;
  float* sL = sM + kBQ;
  float* sC = sL + kBQ;

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int off = Tk - S;

  // all loads are 16 bytes wide, all of a thread's loads of a tile unrolled
  constexpr int N = rk::Vec<T>::N;
  constexpr int VPR = HD / N;          // 16-byte loads per row
#pragma unroll
  for (int i = tid; i < kBQ * VPR; i += kThreads) {
    const int r = i / VPR, d = (i % VPR) * N;
    const int qi = q0 + r;
    float x[N];
    if (qi < S) {
      rk::Vec<T>::load(q + ((static_cast<size_t>(b) * S + qi) * H + h) * HD + d, x);
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) sQ[r * LD + d + n] = x[n];
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    sM[r] = rk::kNegInf;
    sL[r] = 0.f;
  }

  // Each thread owns output column d of rows r0, r0 + RSTEP, ...
  constexpr int RSTEP = kThreads / HD > 0 ? kThreads / HD : 1;
  constexpr int RPT = kBQ * HD / kThreads;   // accumulator entries per thread
  const int d_own = tid % HD;
  const int r_own = tid / HD;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  // One past the last key any live row of this tile may see; the loop
  // stops there.
  int kv_end = Tk;
  if (causal) kv_end = min(Tk, min(q0 + kBQ, S) + off);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;
  __syncthreads();

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * kBK;
#pragma unroll
    for (int i = tid; i < kBK * VPR; i += kThreads) {
      const int j = i / VPR, d = (i % VPR) * N;
      const int kj = k0 + j;
      float kk[N], vv[N];
      if (kj < Tk) {
        const size_t idx = ((static_cast<size_t>(b) * Tk + kj) * KV + kvh) * HD + d;
        rk::Vec<T>::load(k + idx, kk);
        rk::Vec<T>::load(v + idx, vv);
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

    // scores s = q k^T * scale, masked
    for (int i = tid; i < kBQ * kBK; i += kThreads) {
      const int r = i / kBK, j = i % kBK;
      const float* qr = sQ + r * LD;
      const float* kr = sK + j * LD;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      const int qi = q0 + r, kj = k0 + j;
      const bool ok = kj < Tk && (!causal || kj <= qi + off);
      sP[r * LP + j] = ok ? s : rk::kNegInf;
    }
    __syncthreads();

    // online softmax, one thread per query row
    for (int r = tid; r < kBQ; r += kThreads) {
      float* row = sP + r * LP;
      const float m_old = sM[r];
      float m_new = m_old;
      for (int j = 0; j < kBK; ++j) m_new = fmaxf(m_new, row[j]);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      const float corr = expf(m_old - m_new);
      sL[r] = sL[r] * corr + sum;
      sM[r] = m_new;
      sC[r] = corr;
    }
    __syncthreads();

    // acc = acc * corr + p v
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r_own + i * RSTEP;
      const float* pr = sP + r * LP;
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < kBK; ++j) s = fmaf(pr[j], sV[j * HD + d_own], s);
      acc[i] = acc[i] * sC[r] + s;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r_own + i * RSTEP;
    const int qi = q0 + r;
    if (qi < S) {
      const float l = fmaxf(sL[r], 1e-30f);
      o[((static_cast<size_t>(b) * S + qi) * H + h) * HD + d_own] = rk::from_f32<T>(acc[i] / l);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int Tk, int H, int KV, int causal, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = rk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, Tk, H, KV, causal, 1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T, int H, int KV, int hd, int causal,
                                   int dtype, void* stream) {
  if (H % KV != 0 || B <= 0 || S <= 0 || T <= 0) return rk::kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32) {
    if (hd == 64) return launch<float, 64>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 128) return launch<float, 128>(q, k, v, o, B, S, T, H, KV, causal, st);
    return rk::kBadHeadDim;
  }
  if (dtype == rk::kBF16) {
    if (hd == 64) return launch<__nv_bfloat16, 64>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 128) return launch<__nv_bfloat16, 128>(q, k, v, o, B, S, T, H, KV, causal, st);
    return rk::kBadHeadDim;
  }
  return rk::kBadDType;
}
