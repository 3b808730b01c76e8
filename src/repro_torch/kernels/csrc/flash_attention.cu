// Causal (or full) GQA flash-attention forward for prefill, for sm_90a.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention/kernel.py:68).
//
// What bounds it on this card: at the serving shapes (B 4, H 32, KV 8,
// hd 64, S up to ~1000) the work is ~2*2*B*H*S*S/2*hd FLOPs against a few
// MB of q/k/v, so it is bound by operations, not bytes: at S 1000 the
// tensor-core rate allows 0.0166 ms, and Hopper reaches that rate only
// through wgmma.
//
// What the Pallas kernel computes, kept by both kernels below:
//  * scores and an online softmax in f32 with the finite -1e30 mask;
//  * causal tiles above the diagonal never loaded (the block-pruned
//    causality of kernel.py:58): the loop over k-tiles stops at the last
//    key any live row of the block may see;
//  * the causal diagonal aligned bottom-right (key j is visible to query i
//    when j <= i + T - S), as ref.attention; with S == T it is j <= i;
//  * the ragged last q- and k-tile masked, instead of asserting that S and
//    T divide into blocks (kernel.py:77): serving prompts are 12 long;
//  * GQA by index: query head h reads kv head h / (H/KV), no repeated k/v.
// The Pallas grid walks k-tiles as a sequential grid axis and carries the
// softmax state in VMEM scratch (kernel.py:31-35, :62-65); blocks carry
// nothing between them on Hopper, so a loop over k-tiles inside the block
// takes that place.
//
// bfloat16 (flash_fwd_wgmma, the prefill of the served model): tensor cores.
//  * Work tiles of (head, batch, q-tile of 128 rows), each computed by two
//    consumer warpgroups of 64 rows and fed by one producer warpgroup,
//    whose registers setmaxnreg moves to the consumers (24 against 240 a
//    thread).  The registers allow one block an SM, so the kernel is
//    persistent: one block an SM walks the work tiles, heaviest first (the
//    last q-tiles, with the most keys under the causal mask, then the ones
//    before them), and the producer loads the next tile's Q (two slots)
//    and first keys while the consumers finish this one.  At S 1000 that is
//    1024 work tiles on 132 blocks; at S 12, 128 blocks of one tile.
//  * Loads by TMA (cp.async.bulk.tensor): 4-D tensor maps over the model
//    layout, {hd, H, S, B} for q and {hd, KV, T, B} for k and v, in boxes
//    of 64 columns x 64 rows with the 128-byte swizzle that the wgmma
//    descriptors read.  A 128-column head is two boxes, each with its own
//    wgmma K-slices (or N-halves).  TMA zero-fills rows past S or T, so the
//    ragged tile and a tile that would run into the next batch need nothing
//    beyond the score mask.  Q is loaded once a work tile; K and V tiles of
//    64 keys go through a ring of 4 stages (3 at hd 128), each with a
//    K-full, a V-full and an empty mbarrier.  The maps are encoded on the host once per call and
//    passed as __grid_constant__ parameters.  cuTensorMapEncodeTiled is a
//    driver-API function; it is looked up with cudaGetDriverEntryPoint, so
//    the library links the runtime alone, and a driver without it makes
//    the entry point return kNoDriverEntry, which the wrapper raises.
//  * S = Q K^T: wgmma m64n64k16, bf16 in, f32 accumulate, both operands
//    from shared memory (K [keys, hd] is K-major, as wgmma wants B).
//  * The softmax runs on the accumulator fragments in registers: row max
//    and row sum over the four threads of a quad, exp2f with log2 e folded
//    in, the correction applied to the O accumulator.
//  * O += P V with P as two bf16 terms, P_hi = bf16(P), P_lo = bf16(P -
//    P_hi), each a wgmma with A from registers (the S accumulator's
//    fragment layout is the A-fragment layout) and B the V tile, MN-major
//    (the descriptor's transpose bit).  The Pallas kernel multiplies P in
//    f32 (kernel.py:38-40); one bf16 rounding of P (2^-9 relative a term)
//    would move outputs near zero by more than the 2e-5 they are allowed,
//    two terms keep P to about 2^-17.  It costs 1.5x the FLOPs of one bf16
//    pass; the bound counts the function's FLOPs.
//  * Epilogue: divide by max(l, 1e-30), round once to bf16, store the rows
//    < S.
//
// float32 (flash_fwd_kernel): CUDA cores, by dtype.  For f32 inputs wgmma
// computes in TF32, about 3 decimal digits, which breaks the f32 checks
// (2e-5 against the plain version, 1e-4 on the f32 model's hidden states),
// so f32 keeps the products in f32 on the CUDA cores out of shared memory.
// This is dispatch by dtype, not a fallback: a bf16 launch that is refused
// or fails is returned as an error, never retried on this kernel.
#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps (shared with ssm_scan.cu)

// ------------------------------------------------------------------ f32

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
  static_assert(HD % 16 == 0 && kBQ * HD % kThreads == 0, "head dim");
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

  // Each thread owns the accumulator entries e = tid + i * kThreads of the
  // [kBQ][HD] tile, row e / HD and column e % HD.  Where HD divides
  // kThreads or kThreads divides HD (64, 128) that is one column of rows
  // r0, r0 + kThreads / HD, ...; at HD 80 a thread's column moves with i.
  constexpr int RPT = kBQ * HD / kThreads;   // accumulator entries per thread
  const auto own_row = [tid](int i) { return (tid + i * kThreads) / HD; };
  const auto own_col = [tid](int i) { return (tid + i * kThreads) % HD; };
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
      const int r = own_row(i), d = own_col(i);
      const float* pr = sP + r * LP;
      float s = 0.f;
#pragma unroll 16
      for (int j = 0; j < kBK; ++j) s = fmaf(pr[j], sV[j * HD + d], s);
      acc[i] = acc[i] * sC[r] + s;
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = own_row(i);
    const int qi = q0 + r;
    if (qi < S) {
      const float l = fmaxf(sL[r], 1e-30f);
      o[((static_cast<size_t>(b) * S + qi) * H + h) * HD + own_col(i)] =
          rk::from_f32<T>(acc[i] / l);
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

// ------------------------------------------------------------------ bf16
namespace wg {

using namespace rk;   // the Hopper helpers of hopper.cuh

constexpr int kRows = 64;            // q rows per consumer warpgroup (wgmma M)
constexpr int kBQ = 2 * kRows;       // q rows per block
constexpr int kBK = 64;              // keys per K/V tile
constexpr int kThreads = 384;        // consumer warpgroups 0-1, producer warpgroup 2
constexpr int kBox = 64 * 64 * 2;    // one TMA box: 64 rows of 64 bf16 (one 128-byte swizzle span)
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in 1024-byte aligned boxes (the 128-byte swizzle repeats
// every 8 rows of 128 bytes), then the mbarriers.  Q has two slots, so the
// next work tile's Q lands while this one's is read.
template <int HD>
struct Smem {
  static constexpr int NH = (HD + 63) / 64;               // boxes per row of a head
  static constexpr int stages = NH == 1 ? 4 : 3;          // K/V ring depth
  static constexpr int q_off = 0;                         // Q [slot][warpgroup][NH]
  static constexpr int k_off = q_off + 2 * 2 * NH * kBox; // K [stage][NH]
  static constexpr int v_off = k_off + stages * NH * kBox;    // V [stage][NH]
  static constexpr int bar_off = v_off + stages * NH * kBox;
  // Q-full[2], Q-empty[2], then K-full, V-full, KV-empty [stages] each
  static constexpr int n_bars = 4 + 3 * stages;
  static constexpr int bytes = bar_off + 8 * n_bars;
  static constexpr int alloc = bytes + 1024;              // room to align the base
};

// Work tile `item` of n_items = n_qt * H * B, heaviest first: the last
// q-tiles (the most keys under the causal mask) of every (head, batch), then
// the q-tiles before them.
struct Work {
  int q0, h, b, kvh, n_tiles, n_q;
  __device__ Work(int item, int n_qt, int S, int Tk, int H, int KV, int B, int causal) {
    const int per_qt = H * B;
    q0 = (n_qt - 1 - item / per_qt) * kBQ;
    h = item % per_qt % H;
    b = item % per_qt / H;
    kvh = h / (H / KV);
    // one past the last key any live row of the tile may see
    const int kv_end = causal ? min(Tk, min(q0 + kBQ, S) + Tk - S) : Tk;
    n_tiles = (kv_end + kBK - 1) / kBK;
    // the second warpgroup's rows may all lie past S (a short prompt): its Q
    // is then not loaded, and its rows are computed from stale shared memory
    // and never stored
    n_q = q0 + kRows < S ? 2 : 1;
  }
};

// Accumulator fragment of m64nN (f32), thread `lane` of warp `w` of the
// warpgroup: d[4j + e] is row 16w + lane/4 + 8*(e>>1), column 8j + 2*(lane%4)
// + (e&1).  The A fragment of m64k16 for K-slice kk is then
// {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
// {d[8kk+6], d[8kk+7]}, each pair packed low column first.
//
// Persistent: each block walks work tiles blockIdx.x, blockIdx.x + gridDim.x,
// ...; the K/V ring and the Q slots run on across work tiles, so the
// producer loads the next tile's Q and first keys while the consumers finish
// this one.
//
// HD is the true head dim; a head row is NH = ceil(HD / 64) boxes of 64
// columns.  At HD 80 (zamba2) that is the hd-128 layout on tensor maps whose
// innermost dimension is 80: TMA fills columns 80-127 of the second box
// with zeros (the map's dims[0] keeps the next head's columns out, and the
// transaction count is still the whole box).  Q K^T then runs HD / 16 = 5
// K-slices, none over the zero columns; P V runs both 64-column N-halves,
// the second's columns 16-63 coming out zero and never stored.  Scores are
// scaled by 1 / sqrt(HD) and rows are HD apart in o.
//
// HD 16 and 32 (the smoke configs' 16, the reference kernel tests' 32) take
// the hd-64 layout the same way: one box whose columns HD-63 TMA fills with
// zeros (a row of 32 or 64 bytes is narrower than the box, which TMA
// allows).  Q K^T runs HD / 16 = 1 or 2 K-slices, P V the one 64-column
// N-half, whose columns HD-63 come out zero and are never stored.  The
// 32- and 64-byte swizzles would fit the rows exactly, but need descriptors
// of their own for both operands; these head dims serve only the smoke
// stacks, where the 4x or 2x of P V over zero columns costs little, so they
// share the descriptors the other head dims are checked on.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                int B, int S, int Tk, int H, int KV, int causal, float scale) {
  using L = Smem<HD>;
  constexpr int NH = L::NH;
  constexpr int ST = L::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + L::bar_off;
  const auto bar_qfull = [&](int slot) { return bars + 8u * slot; };
  const auto bar_qempty = [&](int slot) { return bars + 8u * (2 + slot); };
  const auto bar_kfull = [&](int s) { return bars + 8u * (4 + s); };
  const auto bar_vfull = [&](int s) { return bars + 8u * (4 + ST + s); };
  const auto bar_empty = [&](int s) { return bars + 8u * (4 + 2 * ST + s); };

  const int n_qt = (S + kBQ - 1) / kBQ;
  const int n_items = n_qt * H * B;
  const int off = Tk - S;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int slot = 0; slot < 2; ++slot) {
      mbar_init(bar_qfull(slot), 1);
      mbar_init(bar_qempty(slot), 8);   // lane 0 of each consumer warp
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_kfull(s), 1);
      mbar_init(bar_vfull(s), 1);
      mbar_init(bar_empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      int kv_it = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const Work w(item, n_qt, S, Tk, H, KV, B, causal);
        const int slot = it & 1;
        if (it >= 2) mbar_wait(bar_qempty(slot), ((it >> 1) - 1) & 1);
        mbar_expect_tx(bar_qfull(slot), w.n_q * NH * kBox);
        for (int g = 0; g < w.n_q; ++g)
          for (int hh = 0; hh < NH; ++hh)
            tma_load_4d(base + L::q_off + ((slot * 2 + g) * NH + hh) * kBox, &tm_q,
                        bar_qfull(slot), hh * 64, w.h, w.q0 + g * kRows, w.b);
        for (int jt = 0; jt < w.n_tiles; ++jt, ++kv_it) {
          const int s = kv_it % ST;
          if (kv_it >= ST) mbar_wait(bar_empty(s), ((kv_it / ST) - 1) & 1);
          mbar_expect_tx(bar_kfull(s), NH * kBox);
          for (int hh = 0; hh < NH; ++hh)
            tma_load_4d(base + L::k_off + (s * NH + hh) * kBox, &tm_k, bar_kfull(s),
                        hh * 64, w.kvh, jt * kBK, w.b);
          mbar_expect_tx(bar_vfull(s), NH * kBox);
          for (int hh = 0; hh < NH; ++hh)
            tma_load_4d(base + L::v_off + (s * NH + hh) * kBox, &tm_v, bar_vfull(s),
                        hh * 64, w.kvh, jt * kBK, w.b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns q rows q0 + 64 wg ... + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad_t = lane % 4;
    int kv_it = 0;
    for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
      const Work w(item, n_qt, S, Tk, H, KV, B, causal);
      const int slot = it & 1;
      const int wrow0 = w.q0 + wg * kRows + warp * 16;   // this warp's first row
      const int row0 = wrow0 + lane / 4;                 // this thread's rows: row0, row0 + 8
      const uint32_t q_base = base + L::q_off + (slot * 2 + wg) * NH * kBox;

      float oacc[NH][32];
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int i = 0; i < 32; ++i) oacc[hh][i] = 0.f;
      float m_r[2] = {rk::kNegInf, rk::kNegInf};
      float l_r[2] = {0.f, 0.f};

      mbar_wait(bar_qfull(slot), (it >> 1) & 1);
      for (int jt = 0; jt < w.n_tiles; ++jt, ++kv_it) {
        const int s = kv_it % ST;
        const uint32_t ph = (kv_it / ST) & 1;
        const int k0 = jt * kBK;

        // S = Q K^T
        float sacc[32];
        mbar_wait(bar_kfull(s), ph);
        wgmma_fence();
        static_assert(HD % 16 == 0, "K-slices of 16 columns");
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t slice = (kk / 4) * kBox + (kk % 4) * 32;
          wgmma_ss(sacc, desc_kmajor(q_base + slice),
                   desc_kmajor(base + L::k_off + s * NH * kBox + slice), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sacc);

        // scale and mask; only tiles on the diagonal or the ragged end mask
        const bool edge = k0 + kBK > Tk || (causal && k0 + kBK - 1 > wrow0 + off);
        float mx[2] = {rk::kNegInf, rk::kNegInf};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sacc[i] * scale;
          if (edge) {
            const int row = row0 + 8 * ((i >> 1) & 1);
            const int col = k0 + 8 * (i >> 2) + 2 * quad_t + (i & 1);
            if (col >= Tk || (causal && col > row + off)) x = rk::kNegInf;
          }
          sacc[i] = x;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
        }
        float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_r[r], mx[r]);
          corr[r] = exp2f((m_r[r] - m_new) * kLog2e);
          m_r[r] = m_new;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = exp2f((sacc[i] - m_r[r]) * kLog2e);
          sacc[i] = p;
          rsum[r] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + rsum[r];
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int i = 0; i < 32; ++i) oacc[hh][i] *= corr[(i >> 1) & 1];

        // P = P_hi + P_lo, both bf16, as A fragments of the four K-slices
        uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float x0 = sacc[8 * kk + 2 * r], x1 = sacc[8 * kk + 2 * r + 1];
            const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
            const float2 hf = __bfloat1622float2(hi);
            p_hi[kk][r] = bf16x2_bits(hi);
            p_lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
          }

        // O += P_hi V + P_lo V
        mbar_wait(bar_vfull(s), ph);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) reg_fence(oacc[hh]);
        wgmma_fence();
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv =
                desc_mnmajor(base + L::v_off + (s * NH + hh) * kBox + kk * 2048);
            wgmma_rs_bt(oacc[hh], p_hi[kk], dv);
            wgmma_rs_bt(oacc[hh], p_lo[kk], dv);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int hh = 0; hh < NH; ++hh) reg_fence(oacc[hh]);
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty(s));
      }
      // this tile's Q is read: its slot may take the tile after next
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_qempty(slot));

      // epilogue: o = O / l, rows < S, one bf16 rounding
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
        l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
        l_r[r] = fmaxf(l_r[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S) {
          __nv_bfloat16* orow = o + ((static_cast<size_t>(w.b) * S + row) * H + w.h) * HD;
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = hh * 64 + 8 * j + 2 * quad_t;   // even, as HD: a pair is in or out
              if (HD % 64 != 0 && col >= HD) continue;
              *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                  oacc[hh][4 * j + 2 * r] / l_r[r], oacc[hh][4 * j + 2 * r + 1] / l_r[r]);
            }
        }
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Tk, int H,
           int KV, int causal, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return rk::kNoDriverEntry;
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, S, H, HD) || !encode(fn, &tk, k, B, Tk, KV, HD) ||
      !encode(fn, &tv, v, B, Tk, KV, HD))
    return rk::kTensorMap;
  auto kern = flash_fwd_wgmma<HD>;
  constexpr size_t smem = Smem<HD>::alloc;
  cudaError_t err = rk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_items = static_cast<long long>((S + kBQ - 1) / kBQ) * H * B;
  if (n_items > (1ll << 30)) return rk::kBadShape;
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one block an SM (the registers allow no more), each walking work tiles
  const int grid = static_cast<int>(n_items < n_sm ? n_items : n_sm);
  kern<<<grid, kThreads, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), B, S,
                                         Tk, H, KV, causal,
                                         1.0f / sqrtf(static_cast<float>(HD)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int S, int T, int H, int KV, int hd, int causal,
                                   int dtype, void* stream) {
  if (H % KV != 0 || B <= 0 || S <= 0 || T <= 0) return rk::kBadShape;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32) {
    if (hd == 16) return launch<float, 16>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 32) return launch<float, 32>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 64) return launch<float, 64>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 80) return launch<float, 80>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 128) return launch<float, 128>(q, k, v, o, B, S, T, H, KV, causal, st);
    return rk::kBadHeadDim;
  }
  if (dtype == rk::kBF16) {
    if (hd == 16) return wg::launch<16>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 32) return wg::launch<32>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 64) return wg::launch<64>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 80) return wg::launch<80>(q, k, v, o, B, S, T, H, KV, causal, st);
    if (hd == 128) return wg::launch<128>(q, k, v, o, B, S, T, H, KV, causal, st);
    return rk::kBadHeadDim;
  }
  return rk::kBadDType;
}
