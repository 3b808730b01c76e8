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
// What bounds it on this card: at serving shapes (4 rows against a
// 128256 x 2048 bf16 table, ~525 MB) it does 2 FLOPs per row per table
// element it reads once, so it is bound by bytes: the table read.
//
// Design, against the TPU kernel: the Pallas grid sweeps the whole vocab in
// one sequence per row tile, carrying the accumulators in VMEM
// (kernel.py:17-18); copied as is that puts the whole head on one SM.  Here
// pass 1 splits the vocab into chunks, one block each: a warp streams whole
// embedding rows with 16-byte loads, the rows of h sit in shared memory, and
// the block writes one partial (m, Z, W, argmax) per row and chunk.  Pass 2
// merges the chunks of each row in chunk order: m = max(m1, m2), Z = Z1 e^(m1-m) +
// Z2 e^(m2-m), W likewise, and on equal maxima the smaller index.  Only the
// V rows of the table that exist are read: no padded tail past V.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kRows = 4;          // rows of h per block (gridDim.y covers the rest)
constexpr int kThreads = 256;     // 8 warps
constexpr int kMergeThreads = 256;

struct Acc {
  float m, z, w;
  int a;
};

__device__ __forceinline__ Acc acc_empty() { return {rk::kNegInf, 0.f, 0.f, INT_MAX}; }

// Merge two partial states; order-free for the argmax (ties -> smaller index).
__device__ __forceinline__ Acc acc_merge(Acc x, Acc y) {
  const float m = fmaxf(x.m, y.m);
  const float cx = expf(x.m - m), cy = expf(y.m - m);
  Acc r;
  r.m = m;
  r.z = x.z * cx + y.z * cy;
  r.w = x.w * cx + y.w * cy;
  r.a = (y.m > x.m || (y.m == x.m && y.a < x.a)) ? y.a : x.a;
  return r;
}

// Fold one score s at vocab index v into a running state (v increasing).
__device__ __forceinline__ void acc_push(Acc& x, float s, int v) {
  if (s > x.m) {
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

// grid (n_chunks, ceil(rows / kRows)); dynamic smem: kRows * D of T.
// Partials are [rows, n_chunks].
template <typename T>
__global__ void __launch_bounds__(kThreads)
exit_head_partial(const T* __restrict__ h, const T* __restrict__ emb, int rows, int D, int V,
                  int chunk, float* __restrict__ pm, float* __restrict__ pz,
                  float* __restrict__ pw, int* __restrict__ pa) {
  constexpr int N = rk::Vec<T>::N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sH = reinterpret_cast<T*>(smem_raw);
  __shared__ Acc sAcc[kThreads / 32][kRows];

  const int c = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int r0 = blockIdx.y * kRows;
  const int nrows = min(kRows, rows - r0);
  for (int i = threadIdx.x; i < kRows * D; i += kThreads) {
    const int r = i / D;
    sH[i] = r < nrows ? h[static_cast<size_t>(r0) * D + i] : rk::from_f32<T>(0.f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int v0 = c * chunk, v1 = min(V, v0 + chunk);
  Acc st = acc_empty();   // lane r < kRows holds row r's state
  for (int vi = v0 + warp; vi < v1; vi += kThreads / 32) {
    const T* e = emb + static_cast<size_t>(vi) * D;
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int d = lane * N; d < D; d += 32 * N) {
      float ev[N], hv[N];
      rk::Vec<T>::load(e + d, ev);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        rk::Vec<T>::load(sH + r * D + d, hv);
#pragma unroll
        for (int i = 0; i < N; ++i) s[r] = fmaf(hv[i], ev[i], s[r]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float t = rk::warp_sum(s[r]);
      if (lane == r) mine = t;
    }
    if (lane < nrows) acc_push(st, mine, vi);
  }
  if (lane < kRows) sAcc[warp][lane] = st;
  __syncthreads();
  if (threadIdx.x < nrows) {
    const int r = threadIdx.x;
    Acc t = sAcc[0][r];
    for (int w = 1; w < kThreads / 32; ++w) t = acc_merge(t, sAcc[w][r]);
    const size_t idx = static_cast<size_t>(r0 + r) * n_chunks + c;
    pm[idx] = t.m;
    pz[idx] = t.z;
    pw[idx] = t.w;
    pa[idx] = t.a;
  }
}

// grid (rows); merges one row's chunks in chunk order: thread i folds its
// own contiguous run of chunks left to right, then a tree joins neighbouring
// runs, always the earlier run on the left.
__global__ void __launch_bounds__(kMergeThreads)
exit_head_merge(const float* __restrict__ pm, const float* __restrict__ pz,
                const float* __restrict__ pw, const int* __restrict__ pa, int n_chunks,
                int* __restrict__ tok, float* __restrict__ conf, float* __restrict__ ent) {
  __shared__ Acc sAcc[kMergeThreads];
  const int r = blockIdx.x;
  const size_t base = static_cast<size_t>(r) * n_chunks;
  const int per = (n_chunks + kMergeThreads - 1) / kMergeThreads;
  const int c0 = threadIdx.x * per, c1 = min(n_chunks, c0 + per);
  Acc t = acc_empty();
  for (int c = c0; c < c1; ++c)
    t = acc_merge(t, Acc{pm[base + c], pz[base + c], pw[base + c], pa[base + c]});
  sAcc[threadIdx.x] = t;
  __syncthreads();
  for (int span = 1; span < kMergeThreads; span <<= 1) {
    if (threadIdx.x % (2 * span) == 0)
      sAcc[threadIdx.x] = acc_merge(sAcc[threadIdx.x], sAcc[threadIdx.x + span]);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const Acc f = sAcc[0];
    const float z = fmaxf(f.z, 1e-30f);
    tok[r] = f.a;
    conf[r] = 1.f / z;
    ent[r] = f.m + logf(z) - f.w / z;
  }
}

template <typename T>
int launch(const void* h, const void* emb, int rows, int D, int V, int chunk, int n_chunks,
           float* pm, float* pz, float* pw, int* pa, int* tok, float* conf, float* ent,
           cudaStream_t stream) {
  if (D % rk::Vec<T>::N != 0) return rk::kBadShape;
  auto kern = exit_head_partial<T>;
  const size_t smem = sizeof(T) * kRows * static_cast<size_t>(D);
  cudaError_t err = rk::allow_smem(kern, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_chunks, (rows + kRows - 1) / kRows);
  kern<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(h), static_cast<const T*>(emb),
                                         rows, D, V, chunk, pm, pz, pw, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  exit_head_merge<<<rows, kMergeThreads, 0, stream>>>(pm, pz, pw, pa, n_chunks, tok, conf, ent);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h: [rows, D], emb: [V, D], both contiguous and 16-byte aligned.  Scratch
// pm/pz/pw/pa: [rows, n_chunks] with n_chunks = ceil(V / chunk).
extern "C" int exit_head_fwd(const void* h, const void* emb, int rows, int D, int V, int chunk,
                             float* pm, float* pz, float* pw, int* pa, int* tok, float* conf,
                             float* ent, int dtype, void* stream) {
  if (rows <= 0 || V <= 0 || chunk <= 0) return rk::kBadShape;
  const int n_chunks = (V + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == rk::kF32)
    return launch<float>(h, emb, rows, D, V, chunk, n_chunks, pm, pz, pw, pa, tok, conf, ent, st);
  if (dtype == rk::kBF16)
    return launch<__nv_bfloat16>(h, emb, rows, D, V, chunk, n_chunks, pm, pz, pw, pa, tok, conf,
                                 ent, st);
  return rk::kBadDType;
}
