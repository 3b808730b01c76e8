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
// What bounds it on this card: each step reads q, k, log_w (dk values), v
// (dv values) and writes o (dv values), and does ~6 dk*dv FLOPs: 64 x 64 in
// bf16 is ~24 FLOPs per byte, far below the ~295 at which the tensor cores
// would be the limit, so the bound is bytes.  What holds this first version
// above it is the serial dependence over time: each step's update needs the
// previous state.
//
// Design, against the TPU kernel:
//  * The Pallas kernel walks a sequential grid of time chunks and folds each
//    chunk into the state with the "ratio trick" k_s / P_s, P the cumulative
//    decay (kernel.py:41-47).  That overflows: at log_w = -8 a 16-step chunk
//    reaches P = exp(-128), below f32's range, and k / P is inf.  Here the
//    recurrence is stepped one token at a time, which only ever multiplies
//    by w <= 1 (for log_w <= 0): strong decay stays finite, and any S (a
//    ragged prefill, S = 1 at decode) takes the same path.
//  * The state's columns (the dv axis) never interact, so blocks split them:
//    grid (B*H, dv / 32), 128 threads.  A warp holds 8 columns; the 4 lanes
//    of a column each keep a quarter of its dk rows in registers (rows in
//    16-byte groups, interleaved so the 4 lanes read 64 contiguous bytes of
//    shared memory), and o_t[j] is summed across the 4 lanes by shuffles.
//    At rwkv6-3b's B 4, H 40, 64 x 64 that is 320 blocks on 132 SMs.
//  * Time is staged in chunks of TC steps: q, k, w = exp(max(log_w, -8))
//    and the block's v columns go to shared memory once per chunk, with one
//    pair of barriers per chunk, not per step.
//  * q, k, v and log_w are read through their [B, S, H, *] strides: the
//    model layout is folded into (b, h) by indexing, not copies, and the
//    Mamba-2 block's stride-0 broadcasts (B and C over heads, the decay over
//    state channels) are read in place.
//  * Simple first: no tensor cores, no splitting of the time axis and no
//    overlap of a chunk's loads with the previous chunk's steps.
#include "common.cuh"

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
          const float kv = ka[e] * vj;
          if (RWKV) {
            acc = fmaf(qa[e], fmaf(ub[gi][e], kv, st[gi][e]), acc);
            st[gi][e] = fmaf(wa[e], st[gi][e], kv);
          } else {
            st[gi][e] = fmaf(wa[e], st[gi][e], kv);
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
