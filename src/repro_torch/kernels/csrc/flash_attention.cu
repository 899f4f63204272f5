// flash_attention_fwd: causal / sliding-window GQA attention forward with
// an online softmax, writing the output and the per-row log-sum-exp.
//
// Replaces the Pallas kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:101, body
// _flash_kernel :40). Semantics: the plain version pair_fwd
// (repro_torch/kernels/flash_attention/xla_ref.py), itself the reference's
// _pair_fwd: q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), q head h reads kv
// head h / (Hq / Hkv); query row i sits at position q_offset + i and sees
// key j iff (not causal or j <= pos) and (no window or j > pos - window).
// Running (m, l, acc) in float32, masked scores at -1e30, l clamped at
// 1e-30, o cast to q's type, lse = m + log(l) in float32.
//
// Design (simple first; tensor cores are later work): one CTA of 4 warps
// per (b * Hq + h, 32-row q tile); each warp owns 8 rows. The CTA loops
// over the visible 32-key tiles only (the Pallas skip rule, :55-59):
// causal skips tiles that start after the tile's last row, a window skips
// tiles that end at or before its first row's window. Q, K and V tiles are
// staged in shared memory as float32 (K rows padded by 4 floats so each
// lane's float4 reads of its own key row hit distinct banks). Scores: lane
// j computes the dot products of key j with the warp's 8 rows; the row max
// and sum are warp shuffles; P.V: each lane accumulates D/32 output
// columns of the 8 rows, taking p_j by shuffle. Products run in float32 on
// the CUDA cores. Edges of Sq and Skv are guarded (rows not stored, keys
// masked and zero-filled). Head dims 16, 32, 64, 128 and 256 are built;
// D = 256 needs 97 KB of shared memory, above the 48 KB default, so the
// kernel opts in to dynamic shared memory.
//
// Bound on the H100: operations (4 D flops per visible (q, k) pair) over
// bytes (q, k, v read, o and lse written once), at the 67 TFLOP/s float32
// rate these products use.
#include "common.cuh"
#include "dtype.cuh"

namespace {

constexpr int kBQ = 32, kBK = 32, kWarps = 4, kRows = kBQ / kWarps;
constexpr int kFlashThreads = kWarps * 32;
constexpr float kNeg = -1e30f;

// K rows are padded by 4 floats (see above)
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + kBK * (D + 4) + kBK * D);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                 float scale, int causal, int window, int q_offset) {
  constexpr int KS = D + 4;
  constexpr int NI = (D + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // kBQ x D
  float* ks = qs + kBQ * D;     // kBK x KS
  float* vs = ks + kBK * KS;    // kBK x D

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = bh / hq * hkv + (bh % hq) / (hq / hkv);
  const T* qp = q + static_cast<int64_t>(bh) * sq * D;
  const T* kp = k + static_cast<int64_t>(kvh) * skv * D;
  const T* vp = v + static_cast<int64_t>(kvh) * skv * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kBQ * D; i += kFlashThreads) {
    const int r = i / D;
    qs[i] = q0 + r < sq ? rt::to_f32(qp[static_cast<int64_t>(q0) * D + i])
                        : 0.0f;
  }

  float acc[kRows][NI], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NI; ++c) acc[r][c] = 0.0f;
  }

  // the visible key tiles [t_begin, t_end)
  const int row_lo = q_offset + q0, row_hi = q_offset + q0 + kBQ - 1;
  const int nk = (skv + kBK - 1) / kBK;
  int t_end = nk, t_begin = 0;
  if (causal) t_end = min(nk, row_hi / kBK + 1);
  if (window > 0 && row_lo - window + 1 > 0)
    t_begin = (row_lo - window + 1) / kBK;

  for (int kt = t_begin; kt < t_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = threadIdx.x; i < kBK * D; i += kFlashThreads) {
      const int j = i / D, d = i % D;
      const bool in = k0 + j < skv;
      const int64_t g = static_cast<int64_t>(k0) * D + i;
      ks[j * KS + d] = in ? rt::to_f32(kp[g]) : 0.0f;
      vs[i] = in ? rt::to_f32(vp[g]) : 0.0f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * KS;
    const float* qrow = qs + warp * kRows * D;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * D + d);
        s[r] = fmaf(qv.x, kv4.x, s[r]);
        s[r] = fmaf(qv.y, kv4.y, s[r]);
        s[r] = fmaf(qv.z, kv4.z, s[r]);
        s[r] = fmaf(qv.w, kv4.w, s[r]);
      }
    }

    const int kpos = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_offset + q0 + warp * kRows + r;
      bool valid = kpos < skv;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      const float sv = valid ? s[r] * scale : kNeg;
      const float m_new = fmaxf(m[r], warp_max(sv));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.0f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NI; ++c) acc[r][c] *= alpha;
      s[r] = p;
    }

    // acc += P V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[NI];
#pragma unroll
      for (int c = 0; c < NI; ++c) {
        const int d = lane + 32 * c;
        vv[c] = d < D ? vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, s[r], j);
#pragma unroll
        for (int c = 0; c < NI; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= sq) continue;
    const float ll = fmaxf(l[r], 1e-30f);
    T* orow = o + (static_cast<int64_t>(bh) * sq + row) * D;
#pragma unroll
    for (int c = 0; c < NI; ++c) {
      const int d = lane + 32 * c;
      if (d < D) orow[d] = rt::from_f32<T>(acc[r][c] / ll);
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * sq + row] = m[r] + logf(ll);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int b, int hq, int hkv, int sq, int skv, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool opted_in = false;  // per instantiation, once per process
  if (bytes > 48 * 1024 && !opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = true;
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd_kernel<T, D><<<grid, kFlashThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      hq, hkv, sq, skv, scale, causal, window, q_offset);
  return 0;
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             void* lse, int b, int hq, int hkv, int sq, int skv, float scale,
             int causal, int window, int q_offset, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                           causal, window, q_offset, s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                           causal, window, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                           causal, window, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                            causal, window, q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                            causal, window, q_offset, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// bf16: 1 when q, k, v and o are bfloat16, 0 when float32; lse is float32.
// d in {16, 32, 64, 128, 256}; window <= 0 means no window.
RT_EXPORT int rt_flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int bf16, int b, int hq, int hkv, int sq,
                                     int skv, int d, float scale, int causal,
                                     int window, int q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b * hq > 0 && sq > 0) {
    const int rc =
        bf16 ? launch_d<__nv_bfloat16>(d, q, k, v, o, lse, b, hq, hkv, sq, skv,
                                       scale, causal, window, q_offset, s)
             : launch_d<float>(d, q, k, v, o, lse, b, hq, hkv, sq, skv, scale,
                               causal, window, q_offset, s);
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
