// Diagonal-decay linear scan (RWKV-6 and Mamba-2), for sm_90a.
//
// Replaces ssm_scan_pallas (src/repro/kernels/ssm_scan/kernel.py:80).
//
// What it computes, per (b, h), with the state S [dk, dv] in f32:
//     S_t = diag(w_t) S_{t-1} + k_t v_t^T,   w_t = exp(max(log_w_t, -8))
//     RWKV:    o_t = q_t (S_{t-1} + diag(u) k_t v_t^T)
//     Mamba-2: o_t = q_t S_t
// which is the reference's scan_sequential (src/repro/models/linear_scan.py).
//
// What bounds it on this card: a token reads q, k, log_w (dk values) and v
// (dv values), writes o (dv values), and costs ~6 dk dv FLOPs: at 64 x 64 in
// bf16 that is ~24 FLOPs a byte, far below the ~295 at which the tensor
// cores would be the limit, so the bound is bytes.  What keeps a kernel
// from it is the serial dependence over time.
//
// Three kernels, chosen by the wrapper (ops.py) by dtype and shape:
//
// bfloat16 with dk = dv = 64 and S >= one chunk (the served prefill of
// rwkv6-3b, and Mamba-2's shapes): the chunked form.  Time is cut into
// chunks of kC = 16 tokens, and each block (one a (b, h)) passes the state
// from chunk to chunk: 63 dependent updates at S 1000, not 1000 dependent
// steps.  With c_t the running sum of the clamped log_w over the chunk, e_t
// = c_{t-1}, x = e (RWKV) or c (Mamba-2), and S_0 the state entering it:
//     o_t = (q_t e^{x_t}) S_0 + sum_{j<t} A_tj v_j  [+ (q_t u k_t) v_t, RWKV]
//     A_tj = sum_d q_td k_jd e^{x_td - c_jd}        [j <= t for Mamba-2]
//     S_16 = diag(e^{c_15}) S_0 + sum_j (k_j e^{c_15 - c_j}) v_j^T
// Every exponent is <= 0 (log_w <= 0: both models give -exp(.)), so nothing
// overflows at any decay; the Pallas kernel's ratio trick divides by e^{c_t}
// instead and is not finite at log_w = -8 (ROADMAP.md section 3).  A is
// factored through the chunk's token kMid: q_t e^{x_t - c_7} times
// k_j e^{c_7 - c_j}, each exponent at most 8 * 8 = 64 in size, so both
// factors are finite in f32; a masked pair (j > t) could reach e^{128} and is
// never computed: its A_tj is zero by selection.  The decays that reach the
// state (e^{x_t}, e^{c_15 - c_j}, e^{c_15}) are products of the per-token
// w_t, as the plain scan multiplies them: one exponential of a sum a chunk
// was measured to carry its rounding (a bias of a few ulp) into every later
// chunk, past the state's allowance at the served model's weak decay.
//  * Tensor cores: the state lives transposed, S^T [dv, dk], in the f32
//    accumulator layout of wgmma m64n64, so every product has dv = 64 as its
//    M.  The read-out o^T [dv, 16] = S^T Q'^T is wgmma with A from registers
//    (the accumulator layout is the A fragment layout, as flash's P); the
//    intra-chunk output V^T A^T and the update dS^T = V^T K' [dv, dk] are
//    wgmma with V^T read MN-major from the TMA tile.  dS goes to a fresh
//    accumulator that the CUDA cores add to the decayed state in f32.
//  * Precision: the f32 operands of the tensor cores (S, Q', K', A) are split
//    into three bf16 terms (hi, lo, lo2; exact products, f32 sums), two
//    neighbouring values a conversion instruction: two terms (~2^-17 of each operand) move outputs
//    near zero past the 3e-4 they are allowed at the served model's weak
//    decay (tests/test_torch_scan_design.py).  The three terms of one operand
//    are stacked along N (m64n48), so one wgmma takes them all, and the
//    output's three 16-column blocks are summed.  q, k and v are exact bf16.
//  * Loads by TMA: kStages chunks of q, k, v (bf16, 16 rows of 64, 128-byte
//    swizzle, the layout the wgmma descriptors read) and log_w in an
//    mbarrier ring, a stage refilled as soon as its chunk is done.  Maps are
//    built on the tensors the model passes: a stride-0 head axis (Mamba-2's
//    B and C, broadcast over heads) maps a single head; Mamba-2's per-head
//    decay (broadcast over channels) is read from its [B, S, H] source in
//    boxes of 4 heads (16 bytes) from a multiple of 4 (an unaligned box start
//    faults), and only its own column used.  TMA zero-fills rows past S:
//    there k = v = 0 and log_w = 0 (w = 1), which add nothing and decay
//    nothing, so a ragged last chunk is masked only where o is stored.
//  * Per-channel decay (ssm_scan_chunked, RWKV-6): two warpgroups, 160
//    blocks at rwkv6-3b's B 4, H 40, two an SM.  Warpgroup 1 prepares chunk
//    n + 1 (the decays and factors of each channel on the CUDA cores, K's
//    bf16 terms, A as 4 x 2 blocks of 64-channel f32 dot products) while
//    warpgroup 0, which holds the state, runs chunk n (Q's bf16 terms, the
//    wgmmas, update and output); two sets of prepared buffers alternate.
//    setmaxnreg moves registers to the state's warpgroup.
//  * Per-head decay (ssm_scan_chunked_head, Mamba-2): the decays are
//    per-token scalars, computed by each warp's lanes.  So the read-out takes
//    the raw q tile and scales each token's column afterwards, and A is
//    (q k^T) e^{c_t - c_j} with q k^T itself a wgmma on the raw tiles.  One
//    warpgroup, 320 blocks at zamba2's B 4, H 80, three an SM.
//
// float32, decode (S 1), short prompts and other widths (ssm_scan_kernel):
// the recurrence stepped one token at a time on the CUDA cores, which only
// multiplies by w <= 1 and so is finite at any decay.  f32 stays off the
// tensor cores (wgmma would compute in TF32; the f32 path is held at f32
// tolerances).
//  * The state's columns (the dv axis) never interact, so blocks split them:
//    grid (B*H, dv / 32), 128 threads.  A warp holds 8 columns; the 4 lanes
//    of a column each keep a quarter of its dk rows in registers (rows in
//    16-byte groups, interleaved so the 4 lanes read 64 contiguous bytes of
//    shared memory), and o_t[j] is summed across the 4 lanes by shuffles.
//  * The state's update rounds w S and then adds k v, two roundings, as the
//    plain scan does: an f32 state then follows the plain one bit for bit,
//    where a fused multiply-add drifted past the f32 output allowance over
//    1000 tokens of weak decay.
//  * Time is staged in chunks of TC steps: q, k, w = exp(max(log_w, -8))
//    and the block's v columns go to shared memory once per chunk, with one
//    pair of barriers per chunk, not per step.
//  * q, k, v and log_w are read through their [B, S, H, *] strides, and the
//    Mamba-2 block's stride-0 broadcasts are read in place.
#include "hopper.cuh"   // mbarriers, TMA, wgmma, tensor maps (shared with flash_attention.cu)

namespace {

constexpr int kThreads = 128;                 // 4 warps
constexpr int kColsPerWarp = 8;               // lanes 4c..4c+3 share column c
constexpr int kCols = kColsPerWarp * (kThreads / 32);   // 32 columns a block
constexpr float kMinLogW = -8.0f;

// Element strides of a [B, S, H, D] operand.
struct Strides {
  long long b, s, h, d;
};

template <typename T, int DK, int TC, bool RWKV>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ lw, const float* __restrict__ s0,
                const float* __restrict__ u, T* __restrict__ o, float* __restrict__ s_out,
                int S, int H, int dv, Strides qs, Strides ks, Strides vs, Strides ws) {
  constexpr int kGroups = DK / 16;            // 16-byte row groups per lane
  __shared__ __align__(16) float q_s[TC][DK];
  __shared__ __align__(16) float k_s[TC][DK];
  __shared__ __align__(16) float w_s[TC][DK];
  __shared__ float v_s[TC][kCols];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = lane & 3;                     // row quarter of this lane
  const int cl = (tid >> 5) * kColsPerWarp + (lane >> 2);   // column in block
  const int j0 = blockIdx.y * kCols;
  const int j = j0 + cl;
  const bool live = j < dv;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + h * ks.h;
  const T* vb = v + b * vs.b + h * vs.h;
  const float* wb = lw + b * ws.b + h * ws.h;
  const size_t o_step = static_cast<size_t>(H) * dv;      // o: [B, S, H, dv]
  T* ob = o + (static_cast<size_t>(b) * S * H + h) * dv;

  // this lane's rows: groups g = gi * 4 + r, rows 4g .. 4g + 3
  float st[kGroups][4];
  float ub[kGroups][4];
  const float* sb = s0 + static_cast<size_t>(bh) * DK * dv;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 4 * (gi * 4 + r) + e;
      st[gi][e] = live ? sb[static_cast<size_t>(row) * dv + j] : 0.0f;
      ub[gi][e] = RWKV ? u[h * DK + row] : 0.0f;
    }
  }

  for (int t0 = 0; t0 < S; t0 += TC) {
    const int n = min(TC, S - t0);
    __syncthreads();                          // the previous chunk is consumed
    for (int idx = tid; idx < n * DK; idx += kThreads) {
      const int t = idx / DK, i = idx % DK;
      const long long ts = t0 + t;
      q_s[t][i] = rk::to_f32(qb[ts * qs.s + i * qs.d]);
      k_s[t][i] = rk::to_f32(kb[ts * ks.s + i * ks.d]);
      w_s[t][i] = expf(fmaxf(wb[ts * ws.s + i * ws.d], kMinLogW));
    }
    for (int idx = tid; idx < n * kCols; idx += kThreads) {
      const int t = idx / kCols, c = idx % kCols;
      const long long ts = t0 + t;
      v_s[t][c] = (j0 + c < dv) ? rk::to_f32(vb[ts * vs.s + (j0 + c) * vs.d]) : 0.0f;
    }
    __syncthreads();
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][cl];
      const float4* q4 = reinterpret_cast<const float4*>(q_s[t]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[t]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[t]);
      float acc = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) {
        const float4 qq = q4[gi * 4 + r], kk = k4[gi * 4 + r], ww = w4[gi * 4 + r];
        const float qa[4] = {qq.x, qq.y, qq.z, qq.w};
        const float ka[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wa[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kv = __fmul_rn(ka[e], vj);
          if (RWKV) {
            acc = fmaf(qa[e], fmaf(ub[gi][e], kv, st[gi][e]), acc);
            st[gi][e] = __fadd_rn(__fmul_rn(wa[e], st[gi][e]), kv);
          } else {
            st[gi][e] = __fadd_rn(__fmul_rn(wa[e], st[gi][e]), kv);
            acc = fmaf(qa[e], st[gi][e], acc);
          }
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (live && r == 0) ob[static_cast<size_t>(t0 + t) * o_step + j] = rk::from_f32<T>(acc);
    }
  }

  if (live) {
    float* so = s_out + static_cast<size_t>(bh) * DK * dv;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 4 * (gi * 4 + r) + e;
        so[static_cast<size_t>(row) * dv + j] = st[gi][e];
      }
    }
  }
}

template <typename T, int DK, int TC>
int launch(const void* q, const void* k, const void* v, const float* lw, const float* s0,
           const float* u, void* o, float* s_out, int B, int S, int H, int dv,
           const Strides& qs, const Strides& ks, const Strides& vs, const Strides& ws,
           cudaStream_t stream) {
  dim3 grid(B * H, (dv + kCols - 1) / kCols);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(o);
  if (u != nullptr) {
    ssm_scan_kernel<T, DK, TC, true><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, lw, s0, u, op, s_out, S, H, dv, qs, ks, vs, ws);
  } else {
    ssm_scan_kernel<T, DK, TC, false><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, lw, s0, u, op, s_out, S, H, dv, qs, ks, vs, ws);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dk(int dk, const void* q, const void* k, const void* v, const float* lw,
              const float* s0, const float* u, void* o, float* s_out, int B, int S, int H,
              int dv, const Strides& qs, const Strides& ks, const Strides& vs,
              const Strides& ws, cudaStream_t stream) {
  // TC steps a chunk: q, k, w and v staged in at most 28 KB of shared memory
#define RK_SCAN(DIM, TCH) \
  launch<T, DIM, TCH>(q, k, v, lw, s0, u, o, s_out, B, S, H, dv, qs, ks, vs, ws, stream)
  switch (dk) {
    case 16: return RK_SCAN(16, 32);
    case 32: return RK_SCAN(32, 32);
    case 64: return RK_SCAN(64, 32);
    case 128: return RK_SCAN(128, 16);
    default: return rk::kBadHeadDim;
  }
#undef RK_SCAN
}

}  // namespace

// q/k/lw: [B, S, H, dk] and v: [B, S, H, dv], each read through its element
// strides (b, s, h, d); s0 and s_out: [B, H, dk, dv] f32 contiguous; u:
// [H, dk] f32 contiguous, or null for the Mamba-2 mode; o: [B, S, H, dv]
// contiguous in q/k/v's dtype.
extern "C" int ssm_scan_fwd(const void* q, const void* k, const void* v, const float* lw,
                            const float* s0, const float* u, void* o, float* s_out,
                            int B, int S, int H, int dk, int dv,
                            long long q_sb, long long q_ss, long long q_sh, long long q_sd,
                            long long k_sb, long long k_ss, long long k_sh, long long k_sd,
                            long long v_sb, long long v_ss, long long v_sh, long long v_sd,
                            long long w_sb, long long w_ss, long long w_sh, long long w_sd,
                            int dtype, void* stream) {
  if (B <= 0 || H <= 0 || S < 0 || dv <= 0) return rk::kBadShape;
  const Strides qs{q_sb, q_ss, q_sh, q_sd}, ks{k_sb, k_ss, k_sh, k_sd};
  const Strides vs{v_sb, v_ss, v_sh, v_sd}, ws{w_sb, w_ss, w_sh, w_sd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32)
    return launch_dk<float>(dk, q, k, v, lw, s0, u, o, s_out, B, S, H, dv, qs, ks, vs, ws, st);
  if (dtype == rk::kBF16)
    return launch_dk<__nv_bfloat16>(dk, q, k, v, lw, s0, u, o, s_out, B, S, H, dv, qs, ks,
                                    vs, ws, st);
  return rk::kBadDType;
}

// ------------------------------------------------------------ chunked, bf16
namespace chunked {

using namespace rk;

constexpr int kC = 16;                 // tokens a chunk
constexpr int kMid = 7;                // the token A's factors are referred to
constexpr int kD = 64;                 // dk = dv
constexpr int kThreads = 128;          // one warpgroup
constexpr int kStages = 3;             // chunks in flight in the TMA ring
constexpr int kTerms = 3;              // bf16 terms of a split f32 operand
constexpr int kTile = kC * kD * 2;     // a bf16 tile [16][64]: 2048 bytes
constexpr int kLd = 68;                // padded f32 row [16][68] (float4 reads)
constexpr int kF32Tile = kC * kLd * 4;
constexpr float kMinLogW = -8.0f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle repeats
// every 8 rows of 128 bytes), for NB chunks in preparation at once: the TMA
// ring, each stage q, k, v then log_w (f32 [16][64], or [16][4] for a
// per-head decay); NB sets of the bf16 terms of Q' = q e^{x} (per-channel
// decay), K' = k e^{c_15 - c} and A (its 16 columns in tiles of 64, read by
// the same kind of descriptor), of the output tile and of the decay; u; the
// mbarriers (the ring's, then NB prepared and NB consumed); q k^T of the
// per-head kernel; the per-channel kernel's f32 Q' and K' (two sets), qm =
// q e^{x - c_7} and km = k e^{c_7 - c}.
template <int NB>
struct Smem {
  static constexpr int stage = 3 * kTile + kC * kD * 4;     // 10240
  static constexpr int qs_off = kStages * stage;
  static constexpr int ks_off = qs_off + NB * kTerms * kTile;
  static constexpr int as_off = ks_off + NB * kTerms * kTile;
  static constexpr int os_off = as_off + NB * kTerms * kTile;
  static constexpr int dec_off = os_off + NB * kTile;
  static constexpr int u_off = dec_off + NB * kD * 4;
  static constexpr int bar_off = u_off + kD * 4;
  static constexpr int qk_off = bar_off + 8 * (kStages + 2 * NB + 1);   // f32 [16][17]
  static constexpr int qf_off = (qk_off + kC * (kC + 1) * 4 + 15) / 16 * 16;
  static constexpr int kf_off = qf_off + NB * kF32Tile;
  static constexpr int qm_off = kf_off + NB * kF32Tile;
  static constexpr int km_off = qm_off + kF32Tile;
  static constexpr int head_alloc = qf_off + 1024;            // room to align the base
  static constexpr int channel_alloc = km_off + kF32Tile + 1024;
  static_assert(stage % 1024 == 0 && qs_off % 1024 == 0, "swizzled tiles");
  static_assert(os_off % 16 == 0 && bar_off % 8 == 0 && qf_off % 16 == 0, "alignment");
};
using HeadSmem = Smem<1>;
using ChannelSmem = Smem<2>;

// byte offset of bf16 element (row, col) of a [rows][64] tile written with
// the 128-byte swizzle: 16-byte chunk col / 8 of a row is stored at chunk
// (col / 8) ^ (row % 8)
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

__device__ __forceinline__ float tile_f32(const unsigned char* tile, int row, int col) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(tile + swz(row, col)));
}

// The bits of x rounded to the nearest bf16 (ties to even), as an f32 bit
// pattern: integer arithmetic, not the conversion unit.  x is finite.
__device__ __forceinline__ uint32_t bf16_hi(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
}

// x as kTerms bf16 terms, term i into tile i at byte offset off
__device__ __forceinline__ void split_store(unsigned char* tiles, int off, float x) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const uint32_t hb = bf16_hi(x);
    *reinterpret_cast<uint16_t*>(tiles + i * kTile + off) = static_cast<uint16_t>(hb >> 16);
    x -= __uint_as_float(hb);
  }
}

// x0 and x1 rounded to bf16 (ties to even) in one packed conversion, x0 in
// the low half; the residuals are left in x0 and x1
__device__ __forceinline__ uint32_t split_pair(float& x0, float& x1) {
  const __nv_bfloat162 hx = __floats2bfloat162_rn(x0, x1);
  const uint32_t bits = *reinterpret_cast<const uint32_t*>(&hx);
  x0 -= __uint_as_float(bits << 16);
  x1 -= __uint_as_float(bits & 0xFFFF0000u);
  return bits;
}

// x0 and x1, two neighbouring columns of a row (x0 at an even column), as
// kTerms bf16 terms: term i into tile i at byte offset off
__device__ __forceinline__ void split_store2(unsigned char* tiles, int off, float x0, float x1) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i)
    *reinterpret_cast<uint32_t*>(tiles + i * kTile + off) = split_pair(x0, x1);
}

// x[0..7], eight consecutive columns of one row, as kTerms bf16 terms: term i
// into tile i at byte offset off (one 16-byte store a term)
__device__ __forceinline__ void split_store8(unsigned char* tiles, int off, float (&x)[8]) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    uint32_t w[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) w[p] = split_pair(x[2 * p], x[2 * p + 1]);
    *reinterpret_cast<uint4*>(tiles + i * kTile + off) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the f32 tile [16][kLd] src split into the kTerms bf16 tiles at dst: eight
// columns of one row a thread (t of a warpgroup's 128)
__device__ __forceinline__ void split_tile(unsigned char* dst, const float* src, int t128) {
  const int t = t128 / 8, c8 = t128 % 8;
  const float4 a = *reinterpret_cast<const float4*>(src + t * kLd + 8 * c8);
  const float4 b = *reinterpret_cast<const float4*>(src + t * kLd + 8 * c8 + 4);
  float x[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  split_store8(dst, swz(t, 8 * c8), x);
}

// The state in kTerms bf16 terms, as the A fragments of wgmma's four dk
// slices: the m64n64 accumulator layout is the A fragment layout, pairs of
// columns packed low first.
__device__ __forceinline__ void split_state(const float (&st)[32], uint32_t (&sa)[kTerms][4][4]) {
  float r[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) r[i] = st[i];
#pragma unroll
  for (int term = 0; term < kTerms; ++term)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int i0 = 8 * kk + 2 * p;
        sa[term][kk][p] = split_pair(r[i0], r[i0 + 1]);
      }
}

// barrier of one warpgroup (id 1 or 2; __syncthreads is 0)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// What both kernels share, for warpgroup 0's thread tid: the TMA ring, the
// state in the m64n64 accumulator layout (st[4j + e] is S[dk][dv] at dv
// row r0 + 8 (e >> 1), dk column 8j + 2 quad + (e & 1)), and the output
// store.
template <int NB>
struct Block {
  using L = Smem<NB>;
  const CUtensorMap* tm_q;
  const CUtensorMap* tm_k;
  const CUtensorMap* tm_v;
  const CUtensorMap* tm_w;
  uint32_t base;
  unsigned char* sm;
  int b, h, hq, hk, hv, S, H, n_chunks, tid, lane, quad, r0;
  bool scalar_w;

  __device__ Block(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                   const CUtensorMap* tw, int S_, int H_, int hq_, int hk_, int hv_,
                   bool scalar) {
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    base = (raw + 1023u) & ~1023u;
    sm = smem_raw + (base - raw);
    tm_q = tq, tm_k = tk, tm_v = tv, tm_w = tw;
    b = blockIdx.x / H_, h = blockIdx.x % H_;
    hq = hq_, hk = hk_, hv = hv_, S = S_, H = H_;
    n_chunks = (S + kC - 1) / kC;
    tid = threadIdx.x, lane = threadIdx.x % 32, quad = lane % 4;
    r0 = 16 * (threadIdx.x / 32 % 4) + lane / 4;
    scalar_w = scalar;
  }

  __device__ uint32_t full(int s) const { return base + L::bar_off + 8u * s; }
  __device__ uint32_t prepared(int p) const { return base + L::bar_off + 8u * (kStages + p); }
  __device__ uint32_t consumed(int p) const {
    return base + L::bar_off + 8u * (kStages + NB + p);
  }

  // the TMA loads of chunk n into stage n % kStages.  A per-head decay box
  // starts at a multiple of 4 heads: its global rows must start 16-byte
  // aligned.
  __device__ void issue(int n) const {
    const int s = n % kStages;
    const uint32_t st = base + s * L::stage, br = full(s);
    mbar_expect_tx(br, 3 * kTile + (scalar_w ? kC * 4 * 4 : kC * kD * 4));
    tma_load_4d(st, tm_q, br, 0, h * hq, n * kC, b);
    tma_load_4d(st + kTile, tm_k, br, 0, h * hk, n * kC, b);
    tma_load_4d(st + 2 * kTile, tm_v, br, 0, h * hv, n * kC, b);
    if (scalar_w)
      tma_load_4d(st + 3 * kTile, tm_w, br, h & ~3, n * kC, b, 0);
    else
      tma_load_4d(st + 3 * kTile, tm_w, br, 0, h, n * kC, b);
  }

  // every thread of the block: barriers, A's zero pairs, the first loads
  __device__ void start() const {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) mbar_init(full(s), 1);
      if constexpr (NB > 1)   // the two-warpgroup kernel's hand-over
        for (int p = 0; p < NB; ++p) mbar_init(prepared(p), 1), mbar_init(consumed(p), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // A's pairs above the diagonal are never written: zero, by selection
    for (int i = tid; i < NB * kTerms * kTile / 16; i += blockDim.x)
      reinterpret_cast<uint4*>(sm + L::as_off)[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    if (tid == 0)
      for (int n = 0; n < kStages && n < n_chunks; ++n) issue(n);
  }

  __device__ void load_state(const float* s0, float (&st)[32]) const {
    const float* sb = s0 + static_cast<size_t>(b * H + h) * kD * kD;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      st[i] = sb[(8 * (i >> 2) + 2 * quad + (i & 1)) * kD + r0 + 8 * ((i >> 1) & 1)];
  }

  __device__ void store_state(float* s_out, const float (&st)[32]) const {
    float* so = s_out + static_cast<size_t>(b * H + h) * kD * kD;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      so[(8 * (i >> 2) + 2 * quad + (i & 1)) * kD + r0 + 8 * ((i >> 1) & 1)] = st[i];
  }

  // o[t][dv] for this thread's accumulator positions (index i of an m64n16
  // fragment: dv row r0 + 8 ((i >> 1) & 1), token 8 (i >> 2) + 2 quad +
  // (i & 1)) through output tile p to rows < S of o (sync: warpgroup 0's
  // barrier); then refill the chunk's stage
  template <typename Sync>
  __device__ void store(const float (&out)[8], __nv_bfloat16* o, int n, int p, Sync sync) const {
    __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(sm + L::os_off + p * kTile);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      os[(8 * (i >> 2) + 2 * quad + (i & 1)) * kD + r0 + 8 * ((i >> 1) & 1)] =
          __float2bfloat16(out[i]);
    sync();
    const int t = tid / 8, c8 = tid % 8, ts = n * kC + t;
    if (ts < S)
      *reinterpret_cast<uint4*>(o + ((static_cast<size_t>(b) * S + ts) * H + h) * kD + c8 * 8) =
          *reinterpret_cast<const uint4*>(os + t * kD + c8 * 8);
    // every read of the stage is done: refill it
    if (tid == 0 && n + kStages < n_chunks) issue(n + kStages);
  }
};

// Per-channel decay (RWKV-6; Mamba-2 mode when given a per-channel log_w).
// Two warpgroups.  Warpgroup 1 prepares chunk n + 1 while warpgroup 0,
// which holds the state, runs chunk n: the preparation does not depend on
// the state, and two sets of its buffers alternate (mbarriers `prepared`
// and `consumed`).  setmaxnreg gives warpgroup 0 the registers of the
// state and its tensor-core operands.
//  Warpgroup 1, chunk n: (1) each thread takes channel d of q (threads 0-63
//  of the group) or k (64-127): the decays and the factors, in f32 tiles;
//  (2) K' split into its bf16 tiles, eight columns a thread; A: threads
//  0-79 a 4 x 2 block of pairs (t, j) over a quarter of the channels each,
//  warp 3 RWKV's bonus from the raw q and k tiles; A split into its tiles,
//  neighbouring pairs in one packed conversion.
//  Warpgroup 0, chunk n: Q' split into its bf16 tiles (the two groups'
//  work balanced so), then one batch of wgmmas into an m64n48 output
//  accumulator whose three 16-column blocks are the terms' parts (summed):
//  S^T Q'^T over the 3 x 3 terms (S from registers) and V^T [A terms]^T;
//  and dS^T = V^T K' over K's terms; then the state decayed and dS added in
//  f32, o stored, the stage refilled.
template <bool RWKV>
__global__ void __launch_bounds__(2 * kThreads, 2)
ssm_scan_chunked(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s0,
                 const float* __restrict__ u, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ s_out, int S, int H, int hq, int hk, int hv) {
  using L = ChannelSmem;
  const Block<2> blk(&tm_q, &tm_k, &tm_v, &tm_w, S, H, hq, hk, hv, false);
  unsigned char* sm = blk.sm;
  float* dec = reinterpret_cast<float*>(sm + L::dec_off);
  float* us = reinterpret_cast<float*>(sm + L::u_off);
  if (RWKV && blk.tid < kD) us[blk.tid] = u[blk.h * kD + blk.tid];
  blk.start();

  if (blk.tid < kThreads) {
    // ---- warpgroup 0: the state
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    const int quad = blk.quad;
    float st[32];
    blk.load_state(s0, st);
    float oacc[24], dacc[32];
#pragma unroll
    for (int i = 0; i < 24; ++i) oacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) dacc[i] = 0.f;
    for (int n = 0; n < blk.n_chunks; ++n) {
      const int s = n % kStages, p = n & 1;
      mbar_wait(blk.prepared(p), (n >> 1) & 1);
      mbar_wait(blk.full(s), (n / kStages) & 1);
      // Q' in bf16 terms, eight columns a thread
      split_tile(sm + L::qs_off + p * kTerms * kTile,
                 reinterpret_cast<const float*>(sm + L::qf_off) + p * kC * kLd, blk.tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(2);
      uint32_t sa[kTerms][4][4];
      split_state(st, sa);
      reg_fence(oacc);
      reg_fence(dacc);
      wgmma_fence();
      const uint32_t qs_b = blk.base + L::qs_off + p * kTerms * kTile;
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_n48(oacc, sa[i][kk], desc_kmajor(qs_b + kk * 32), (i | kk) != 0);
      const uint64_t dv_desc = desc_mnmajor(blk.base + s * L::stage + 2 * kTile);
      wgmma_ss_tn_n48(oacc, dv_desc, desc_kmajor(blk.base + L::as_off + p * kTerms * kTile), 1);
      const uint32_t ks_b = blk.base + L::ks_off + p * kTerms * kTile;
#pragma unroll
      for (int j = 0; j < kTerms; ++j)
        wgmma_ss_tt(dacc, dv_desc, desc_mnmajor(ks_b + j * kTile), j != 0);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(oacc);
      reg_fence(dacc);
      // S <- diag(e^{c_15}) S + dS in f32; o = the sum of the three blocks
#pragma unroll
      for (int i = 0; i < 32; ++i)
        st[i] = fmaf(st[i], dec[p * kD + 8 * (i >> 2) + 2 * quad + (i & 1)], dacc[i]);
      float out[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) out[i] = oacc[i] + oacc[i + 8] + oacc[i + 16];
      blk.store(out, o, n, p, [] { wg_sync(2); });
      if (blk.tid == 0) mbar_arrive(blk.consumed(p));   // set p may take chunk n + 2
    }
    blk.store_state(s_out, st);
  } else {
    // ---- warpgroup 1: the preparation
    asm volatile("setmaxnreg.dec.sync.aligned.u32 96;\n" ::: "memory");
    const int t1 = blk.tid - kThreads;
    float* qf = reinterpret_cast<float*>(sm + L::qf_off);
    float* kf = reinterpret_cast<float*>(sm + L::kf_off);
    float* qm = reinterpret_cast<float*>(sm + L::qm_off);
    float* km = reinterpret_cast<float*>(sm + L::km_off);
    const int d = t1 % kD;            // the channel of this thread's factors
    const bool qside = t1 < kD;       // threads 0-63: q's factors; 64-127: k's
    // this thread's 4 x 2 block of A (threads 0-79, four to a block): rows
    // 4 tg .. 4 tg + 3, columns 2 jp, 2 jp + 1, jp <= 2 tg + 1; a quarter of
    // the channels each (float4 q4, q4 + 4, ...)
    const int pb = t1 / 4, q4 = t1 % 4;
    const int tg = static_cast<int>((sqrtf(4.f * pb + 1.f) - 1.f) * 0.5f);
    const int jp = pb - tg * (tg + 1);
    for (int n = 0; n < blk.n_chunks; ++n) {
      const int s = n % kStages, p = n & 1;
      const unsigned char* stg = sm + s * L::stage;
      mbar_wait(blk.full(s), (n / kStages) & 1);

      // -- (1) factors of channel d; every load before any store.  The
      //    decays that reach the state (Q', K', e^{c_15}) are products of
      //    the per-token w_t = exp(max(log_w, -8)), the factors the plain
      //    scan multiplies by: one exponential of a sum would carry its
      //    rounding into every later chunk.  A's factors, which reach only
      //    this chunk's output, are exponentials of sums of log2 w.
      const float* lws = reinterpret_cast<const float*>(stg + 3 * kTile);
      float x[kC], w[kC], c[kC];
#pragma unroll
      for (int t = 0; t < kC; ++t) x[t] = tile_f32(stg + (qside ? 0 : kTile), t, d);
      float run = 0.f;
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        const float lwt = fmaxf(lws[t * kD + d], kMinLogW);
        w[t] = expf(lwt);
        const float e = run;          // the exclusive sum, RWKV's
        run += lwt * kLog2e;
        c[t] = RWKV && qside ? e : run;
      }
      // q side: Q' = q prod_{tau < t} w (RWKV) or prod_{tau <= t} w
      // (Mamba-2); k side: K' = k prod_{tau > t} w.  A's reference c_7 is an
      // inclusive sum.
      float prod = 1.f;
      const float c_mid = RWKV && qside ? c[kMid + 1] : c[kMid];
      // set p is free once chunk n - 2 is consumed
      if (n >= 2) mbar_wait(blk.consumed(p), ((n >> 1) - 1) & 1);
      float* fo = (qside ? qf : kf) + p * kC * kLd;
      float* fm = qside ? qm : km;
      if (qside) {
#pragma unroll
        for (int t = 0; t < kC; ++t) {
          if (!RWKV) prod *= w[t];
          fo[t * kLd + d] = x[t] * prod;
          if (RWKV) prod *= w[t];
        }
      } else {
#pragma unroll
        for (int t = kC - 1; t >= 0; --t) {
          fo[t * kLd + d] = x[t] * prod;
          prod *= w[t];
        }
      }
#pragma unroll
      for (int t = 0; t < kC; ++t) {
        fm[t * kLd + d] = x[t] * exp2f(qside ? c[t] - c_mid : c_mid - c[t]);
      }
      if (!qside) dec[p * kD + d] = prod;   // prod_{all 16} w
      wg_sync(1);

      // -- (2) K' and A in bf16 terms
      split_tile(sm + L::ks_off + p * kTerms * kTile, kf + p * kC * kLd, t1);
      unsigned char* as = sm + L::as_off + p * kTerms * kTile;
      //    A: pairs (t, j), j < t (and j == t for Mamba-2) from qm and km;
      //    RWKV's j == t is its bonus q_t . (u k_t).  Above the diagonal A
      //    stays zero: a masked pair's factors may reach e^{128}.
      float a[4][2] = {};
      if (t1 < 80) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int f = 4 * i + q4;
          const float4 y0 = reinterpret_cast<const float4*>(km + (2 * jp) * kLd)[f];
          const float4 y1 = reinterpret_cast<const float4*>(km + (2 * jp + 1) * kLd)[f];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 xv = reinterpret_cast<const float4*>(qm + (4 * tg + r) * kLd)[f];
            a[r][0] += xv.x * y0.x + xv.y * y0.y + xv.z * y0.z + xv.w * y0.w;
            a[r][1] += xv.x * y1.x + xv.y * y1.y + xv.z * y1.z + xv.w * y1.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {   // the whole warp shuffles; a block's 4 lanes sum
          a[r][cc] += __shfl_xor_sync(0xffffffffu, a[r][cc], 1);
          a[r][cc] += __shfl_xor_sync(0xffffffffu, a[r][cc], 2);
        }
      if (t1 < 80) {                       // lane q4 writes row 4 tg + q4
        const int t = 4 * tg + q4, j = 2 * jp;
        float v0 = q4 == 0 ? a[0][0] : q4 == 1 ? a[1][0] : q4 == 2 ? a[2][0] : a[3][0];
        float v1 = q4 == 0 ? a[0][1] : q4 == 1 ? a[1][1] : q4 == 2 ? a[2][1] : a[3][1];
        if (j + 1 < t || (!RWKV && j + 1 == t))
          split_store2(as, swz(t, j), v0, v1);
        else if (j < t || (!RWKV && j == t))
          split_store(as, swz(t, j), v0);
      }
      if (RWKV && t1 >= 96) {   // the bonus of token t from the raw tiles, half the channels a lane
        const int t = (t1 - 96) / 2, half = t1 % 2;
        float b4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c8 = 4 * half + i;   // eight channels 8 c8 .. 8 c8 + 7
          const uint4 qv = *reinterpret_cast<const uint4*>(stg + swz(t, 8 * c8));
          const uint4 kv = *reinterpret_cast<const uint4*>(stg + kTile + swz(t, 8 * c8));
          const __nv_bfloat162* q2 = reinterpret_cast<const __nv_bfloat162*>(&qv);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 qf2 = __bfloat1622float2(q2[e]), kf2 = __bfloat1622float2(k2[e]);
            b4[e] = fmaf(qf2.x, kf2.x * us[8 * c8 + 2 * e], b4[e]);
            b4[e] = fmaf(qf2.y, kf2.y * us[8 * c8 + 2 * e + 1], b4[e]);
          }
        }
        float bonus = (b4[0] + b4[1]) + (b4[2] + b4[3]);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
        if (half == 0) split_store(as, swz(t, t), bonus);
      }
      // the split tiles are read by wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg_sync(1);
      if (t1 == 0) mbar_arrive(blk.prepared(p));
    }
  }
}

// Per-head decay (Mamba-2: one w_t for every channel of a head).  The
// decays are per-token scalars: each warp computes the chunk's 16 on lanes
// 0-15 (and again on 16-31).  A chunk: (1) on the tensor cores Q K^T from
// the raw tiles (exact bf16) and the read-out S^T Q^T over S's 3 terms
// (raw q: each token's column is scaled by prod_{tau <= t} w afterwards);
// meanwhile K' = k prod_{tau > t} w split into its tiles, eight columns a
// thread; (2) Q K^T's first 16 rows (warp 0) through shared memory, scaled
// by e^{c_t - c_j} for j <= t and split into A's tiles, two pairs a thread;
// (3) V^T [A terms]^T and dS^T = V^T K'; (4) the state decayed and dS added
// in f32, o stored.
__global__ void __launch_bounds__(kThreads, 3)
ssm_scan_chunked_head(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_w, const float* __restrict__ s0,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ s_out, int S, int H,
                      int hq, int hk, int hv) {
  using L = HeadSmem;
  const Block<1> blk(&tm_q, &tm_k, &tm_v, &tm_w, S, H, hq, hk, hv, true);
  unsigned char* sm = blk.sm;
  float* qks = reinterpret_cast<float*>(sm + L::qk_off);
  const int tid = blk.tid, lane = blk.lane, quad = blk.quad;
  const int warp = tid / 32;
  blk.start();
  float st[32];
  blk.load_state(s0, st);
  float oq[8], qk[8], oacc[24], dacc[32];
#pragma unroll
  for (int i = 0; i < 8; ++i) oq[i] = qk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 24; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) dacc[i] = 0.f;

  const int tl = lane & 15;         // lane tl of each half-warp holds token tl's scalars
  const uint32_t ks_b = blk.base + L::ks_off, as_b = blk.base + L::as_off;
  for (int n = 0; n < blk.n_chunks; ++n) {
    const int s = n % kStages;
    const unsigned char* stg = sm + s * L::stage;
    const uint32_t stg_b = blk.base + s * L::stage;
    mbar_wait(blk.full(s), (n / kStages) & 1);

    // -- (1) Q K^T (rows 0-15 of the m64n16 product are the chunk's tokens;
    //    the descriptor's rows 16-63 run on into the stage's other tiles and
    //    are never read) and the read-out, on the tensor cores
    uint32_t sa[kTerms][4][4];
    split_state(st, sa);
    reg_fence(qk);
    reg_fence(oq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n16(qk, desc_kmajor(stg_b + kk * 32), desc_kmajor(stg_b + kTile + kk * 32),
                   kk != 0);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < kTerms; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_n16(oq, sa[i][kk], desc_kmajor(stg_b + kk * 32), (i | kk) != 0);
    wgmma_commit();

    //    the chunk's decays, in the plain scan's order of products:
    //    f_in = prod_{tau <= t} w, f_k = prod_{tau > t} w (from tau = 15 down),
    //    c2 = sum_{tau <= t} log2 w, and the chunk's decay f_k[0] w_0
    const float lwt =
        fmaxf(reinterpret_cast<const float*>(stg + 3 * kTile)[tl * 4 + (blk.h & 3)], kMinLogW);
    const float wt = expf(lwt);
    float f_in = 1.f, f_k = 1.f, c2 = 0.f;
#pragma unroll
    for (int tau = 0; tau < kC; ++tau) {
      const float wv = __shfl_sync(0xffffffffu, wt, tau, 16);
      const float lv = __shfl_sync(0xffffffffu, lwt, tau, 16);
      if (tau <= tl) f_in *= wv, c2 += lv * kLog2e;
    }
#pragma unroll
    for (int tau = kC - 1; tau > 0; --tau) {
      const float wv = __shfl_sync(0xffffffffu, wt, tau, 16);
      if (tau > tl) f_k *= wv;
    }
    const float decay = __shfl_sync(0xffffffffu, f_k * wt, 0, 16);
    {   // K' terms: token t = tid / 8, columns 8 (tid % 8) .. + 7
      const int t = tid / 8, c8 = tid % 8;
      const float fk = __shfl_sync(0xffffffffu, f_k, t & 15, 16);
      const uint4 raw = *reinterpret_cast<const uint4*>(stg + kTile + swz(t, 8 * c8));
      const __nv_bfloat162* kv2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kx[8];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float2 f = __bfloat1622float2(kv2[p]);
        kx[2 * p] = f.x * fk;
        kx[2 * p + 1] = f.y * fk;
      }
      split_store8(sm + L::ks_off, swz(t, 8 * c8), kx);
    }

    // -- (2) A = (q_t . k_j) e^{c_t - c_j}, j <= t, two pairs a thread
    wgmma_wait<1>();
    reg_fence(qk);
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        qks[(lane / 4 + 8 * ((i >> 1) & 1)) * (kC + 1) + 8 * (i >> 2) + 2 * quad + (i & 1)] = qk[i];
    }
    __syncthreads();
    {
      const int t = tid / 8, j0 = 2 * (tid % 8);
      const float ct = __shfl_sync(0xffffffffu, c2, t & 15, 16);
      float av[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float cj = __shfl_sync(0xffffffffu, c2, j0 + e, 16);
        av[e] = qks[t * (kC + 1) + j0 + e] * exp2f(ct - cj);
      }
      if (j0 + 1 <= t)
        split_store2(sm + L::as_off, swz(t, j0), av[0], av[1]);
      else if (j0 <= t)
        split_store(sm + L::as_off, swz(t, j0), av[0]);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // -- (3) the intra-chunk output and dS
    reg_fence(oacc);
    reg_fence(dacc);
    wgmma_fence();
    const uint64_t dv_desc = desc_mnmajor(stg_b + 2 * kTile);
    wgmma_ss_tn_n48(oacc, dv_desc, desc_kmajor(as_b), 0);
#pragma unroll
    for (int j = 0; j < kTerms; ++j)
      wgmma_ss_tt(dacc, dv_desc, desc_mnmajor(ks_b + j * kTile), j != 0);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(oq);
    reg_fence(oacc);
    reg_fence(dacc);

    // -- (4) S <- e^{c_15} S + dS in f32; o = f_in o_inter + the intra
    //    output's three 16-column blocks
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = fmaf(st[i], decay, dacc[i]);
    float out[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = 8 * (i >> 2) + 2 * quad + (i & 1);
      const float fin = __shfl_sync(0xffffffffu, f_in, t, 16);
      out[i] = oq[i] * fin + (oacc[i] + oacc[i + 8] + oacc[i + 16]);
    }
    blk.store(out, o, n, 0, [] { __syncthreads(); });
  }
  blk.store_state(s_out, st);
}

// Element strides of a [B, S, H, D] operand.
struct Str {
  long long b, s, h, d;
};

// a bf16 [B, S, H, 64] operand in boxes of 16 rows of 64, 128-byte swizzle;
// a stride-0 head axis maps one head (hmul = 0)
bool map_bf16(EncodeTiled fn, CUtensorMap* map, const void* p, const Str& st, int B, int S,
              int H, int* hmul) {
  *hmul = st.h != 0;
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(*hmul ? H : 1),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>((*hmul ? st.h : st.s) * 2),
                                 static_cast<cuuint64_t>(st.s * 2),
                                 static_cast<cuuint64_t>(st.b * 2)};
  const cuuint32_t box[4] = {kD, 1, kC, 1};
  return encode_4d(fn, map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// log_w: per channel, f32 [B, S, H, 64] in boxes of 16 rows of 64; per head
// (stride-0 channels), its [B, S, H] source in boxes of 16 rows of 4 heads
bool map_w(EncodeTiled fn, CUtensorMap* map, const float* p, const Str& st, int B, int S,
           int H, bool scalar) {
  if (scalar) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                                static_cast<cuuint64_t>(B), 1};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s * 4),
                                   static_cast<cuuint64_t>(st.b * 4),
                                   static_cast<cuuint64_t>(st.b * 4 * B)};
    const cuuint32_t box[4] = {4, kC, 1, 1};
    return encode_4d(fn, map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, dims, strides, box,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  const cuuint64_t dims[4] = {kD, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h * 4),
                                 static_cast<cuuint64_t>(st.s * 4),
                                 static_cast<cuuint64_t>(st.b * 4)};
  const cuuint32_t box[4] = {kD, 1, kC, 1};
  return encode_4d(fn, map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p, dims, strides, box,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename Kernel, typename... Args>
int launch(Kernel kern, int smem, int blocks, int threads, cudaStream_t stream, Args... args) {
  const cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<blocks, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace chunked

// The chunked tensor-core kernels: the arguments of ssm_scan_fwd, bf16
// only, dk = dv = 64.  q, k, v: unit channel stride, other strides whole 16
// bytes (or 0 on the head axis of q and k), 16-byte aligned.  log_w: unit
// channel stride (per channel), or, in the Mamba-2 mode only (u null),
// channel stride 0 with a unit head stride and at least 4 heads (one decay
// per head, read from its [B, S, H] source); other strides whole 16 bytes.
// The wrapper (ops.py) prepares them.
extern "C" int ssm_scan_chunked_fwd(const void* q, const void* k, const void* v,
                                    const float* lw, const float* s0, const float* u, void* o,
                                    float* s_out, int B, int S, int H, int dk, int dv,
                                    long long q_sb, long long q_ss, long long q_sh,
                                    long long q_sd, long long k_sb, long long k_ss,
                                    long long k_sh, long long k_sd, long long v_sb,
                                    long long v_ss, long long v_sh, long long v_sd,
                                    long long w_sb, long long w_ss, long long w_sh,
                                    long long w_sd, int dtype, void* stream) {
  if (dtype != rk::kBF16) return rk::kBadDType;
  if (dk != chunked::kD || dv != chunked::kD) return rk::kBadHeadDim;
  const bool scalar = w_sd == 0;
  if (B <= 0 || H <= 0 || S <= 0 || q_sd != 1 || k_sd != 1 || v_sd != 1 ||
      (scalar ? (w_sh != 1 || H < 4 || u != nullptr) : w_sd != 1))
    return rk::kBadShape;
  const rk::EncodeTiled fn = rk::encode_tiled();
  if (fn == nullptr) return rk::kNoDriverEntry;
  CUtensorMap tq, tk, tv, tw;
  int hq = 1, hk = 1, hv = 1;
  if (!chunked::map_bf16(fn, &tq, q, {q_sb, q_ss, q_sh, q_sd}, B, S, H, &hq) ||
      !chunked::map_bf16(fn, &tk, k, {k_sb, k_ss, k_sh, k_sd}, B, S, H, &hk) ||
      !chunked::map_bf16(fn, &tv, v, {v_sb, v_ss, v_sh, v_sd}, B, S, H, &hv) ||
      !chunked::map_w(fn, &tw, lw, {w_sb, w_ss, w_sh, w_sd}, B, S, H, scalar))
    return rk::kTensorMap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<__nv_bfloat16*>(o);
  using chunked::ChannelSmem;
  using chunked::HeadSmem;
  using chunked::kThreads;
  if (scalar)
    return chunked::launch(chunked::ssm_scan_chunked_head, HeadSmem::head_alloc, B * H,
                           kThreads, st, tq, tk, tv, tw, s0, out, s_out, S, H, hq, hk, hv);
  if (u != nullptr)
    return chunked::launch(chunked::ssm_scan_chunked<true>, ChannelSmem::channel_alloc, B * H,
                           2 * kThreads, st, tq, tk, tv, tw, s0, u, out, s_out, S, H, hq, hk,
                           hv);
  return chunked::launch(chunked::ssm_scan_chunked<false>, ChannelSmem::channel_alloc, B * H,
                         2 * kThreads, st, tq, tk, tv, tw, s0, u, out, s_out, S, H, hq, hk, hv);
}
