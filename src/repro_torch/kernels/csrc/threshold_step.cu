// threshold_step: the fused Alg. 3 test/Send step, one kernel per problem.
//
// Replaces the Pallas kernel threshold_step_kernel
// (src/repro/kernels/wheel/threshold_step.py:35), which traces any
// problem's test inside its body; here each problem the port ships has its
// own kernel. Semantics: the plain version protocol.threshold_rules with
// the problem's test (repro_torch/engine/problems.py).
//
// Per peer: knowledge K = sum_v X_in[v] + [x, 1]; agreement A = X_in + X_out;
// violation on direction v when the problem's margins of A and K - A
// disagree in sign; output margin(K) >= 0; Send payload K - X_in. Payload
// arithmetic wraps as the reference's int32 does (computed in uint32,
// compared signed).
//
//   * majority (P = 2): margin = 2 ones - total;
//   * mean (P = 2):     margin = sum q - T count (T passed in);
//   * L2 (P = D + 1):   f_m(p) = <p[:D], u_m> - Tf p[D] over the M cover
//     directions u_m (an (M, D) float32 input); margin = max_m f_m. K
//     outside (margin(K) >= 0): the violation of the argmax half-space
//     (first maximum, strict >, as numpy/torch argmax); K inside: the OR
//     over all M. f_m keeps the reference's unrolled float32 order p0 u0,
//     + pj uj, - Tf c with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc
//     cannot contract it into FMAs, and int32 -> float32 rounds to
//     nearest (__int2float_rn), as numpy and XLA do. Two kernels:
//       - D <= 8 with the cover in the 48 KB of static shared memory
//         (M D <= 12,288 floats): one instantiation per D, the row's 7
//         projected vectors in registers;
//       - any other (D, M): the general kernel. A thread walks the cover
//         in tiles of kTileM directions; per tile it runs j = 0..D-1 once,
//         re-reading the row's column j (L1-resident after the first tile)
//         and folding it into 7 kTileM accumulators, with the cover read
//         through the read-only cache (every lane of a warp reads the same
//         word). Across tiles it keeps the running max of f_m(K) with its
//         first argmax, the violation at that argmax and the OR of all,
//         which is the same decision as the two-pass form.
//
// Bound on the H100: bytes for all three (majority/mean: 52 bytes in and
// 31 out per peer for ~30 integer operations; L2 at D = 2, M = 16: 80 bytes
// in, 43 out, ~600 float operations). Design: one thread per peer,
// elementwise; each thread reads its in/out rows (contiguous) once.
#include "common.cuh"

namespace {

// Linear problems with P = 2: margin(q, c) = a q - b c (majority: a = 2,
// b = 1; mean: a = 1, b = T), all in uint32.
__global__ void linear_threshold_kernel(const int32_t* __restrict__ in_pay,
                                        const int32_t* __restrict__ out_pay,
                                        const int32_t* __restrict__ x,
                                        uint32_t a, uint32_t b, int64_t n,
                                        bool* __restrict__ viol,
                                        int32_t* __restrict__ out,
                                        int32_t* __restrict__ pay) {
  const int64_t i = rt::global_index();
  if (i >= n) return;
  auto margin = [a, b](uint32_t q, uint32_t c) {
    return static_cast<int32_t>(a * q - b * c);
  };
  uint32_t ip[6], op[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    ip[j] = static_cast<uint32_t>(in_pay[6 * i + j]);
    op[j] = static_cast<uint32_t>(out_pay[6 * i + j]);
  }
  const uint32_t k1 = ip[0] + ip[2] + ip[4] + static_cast<uint32_t>(x[i]);
  const uint32_t k2 = ip[1] + ip[3] + ip[5] + 1u;
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    const uint32_t a1 = ip[2 * v] + op[2 * v];
    const uint32_t a2 = ip[2 * v + 1] + op[2 * v + 1];
    const int32_t ta = margin(a1, a2);
    const int32_t tka = margin(k1 - a1, k2 - a2);
    viol[3 * i + v] = (ta >= 0 && tka < 0) || (ta < 0 && tka > 0);
    pay[6 * i + 2 * v] = static_cast<int32_t>(k1 - ip[2 * v]);
    pay[6 * i + 2 * v + 1] = static_cast<int32_t>(k2 - ip[2 * v + 1]);
  }
  out[i] = margin(k1, k2) >= 0 ? 1 : 0;
}

__device__ __forceinline__ float to_f32(uint32_t v) {
  return __int2float_rn(static_cast<int>(v));
}

// f_m(p) for one direction u (D floats) in the reference's op order.
template <int D>
__device__ __forceinline__ float project(const float (&p)[D + 1],
                                         const float* u, float tf) {
  float acc = __fmul_rn(p[0], u[0]);
#pragma unroll
  for (int j = 1; j < D; ++j) acc = __fadd_rn(acc, __fmul_rn(p[j], u[j]));
  return __fsub_rn(acc, __fmul_rn(tf, p[D]));
}

template <int D>
__global__ void l2_threshold_kernel(const int32_t* __restrict__ in_pay,
                                    const int32_t* __restrict__ out_pay,
                                    const int32_t* __restrict__ x,
                                    const float* __restrict__ cover, int m_dirs,
                                    float tf, int64_t n,
                                    bool* __restrict__ viol,
                                    int32_t* __restrict__ out,
                                    int32_t* __restrict__ pay) {
  constexpr int P = D + 1;
  extern __shared__ float su[];  // (M, D) cover
  for (int j = threadIdx.x; j < m_dirs * D; j += blockDim.x) su[j] = cover[j];
  __syncthreads();
  const int64_t i = rt::global_index();
  if (i >= n) return;

  uint32_t ip[3][P], k[P];
  float fk[P], fa[3][P], fka[3][P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    k[j] = j < D ? static_cast<uint32_t>(x[D * i + j]) : 1u;
  }
#pragma unroll
  for (int v = 0; v < 3; ++v) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      ip[v][j] = static_cast<uint32_t>(in_pay[(3 * i + v) * P + j]);
      k[j] += ip[v][j];
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) fk[j] = to_f32(k[j]);
#pragma unroll
  for (int v = 0; v < 3; ++v) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const uint32_t ag =
          ip[v][j] + static_cast<uint32_t>(out_pay[(3 * i + v) * P + j]);
      fa[v][j] = to_f32(ag);
      fka[v][j] = to_f32(k[j] - ag);
    }
  }
  // the argmax half-space of K (first maximum wins)
  float best = project<D>(fk, su, tf);
  int m_star = 0;
  for (int m = 1; m < m_dirs; ++m) {
    const float pk = project<D>(fk, su + m * D, tf);
    if (pk > best) {
      best = pk;
      m_star = m;
    }
  }
  const bool outside = best >= 0.f;
  bool any[3] = {false, false, false}, sel[3] = {false, false, false};
  for (int m = 0; m < m_dirs; ++m) {
    const float* u = su + m * D;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float pa = project<D>(fa[v], u, tf);
      const float pka = project<D>(fka[v], u, tf);
      const bool vm = (pa >= 0.f && pka < 0.f) || (pa < 0.f && pka > 0.f);
      any[v] = any[v] || vm;
      if (m == m_star) sel[v] = vm;
    }
  }
#pragma unroll
  for (int v = 0; v < 3; ++v) {
    viol[3 * i + v] = outside ? sel[v] : any[v];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pay[(3 * i + v) * P + j] = static_cast<int32_t>(k[j] - ip[v][j]);
    }
  }
  out[i] = outside ? 1 : 0;
}

// The general L2 form: any D, any M, the cover in global memory.
constexpr int kTileM = 8;

__global__ void l2_threshold_general_kernel(
    const int32_t* __restrict__ in_pay, const int32_t* __restrict__ out_pay,
    const int32_t* __restrict__ x, const float* __restrict__ cover,
    int m_dirs, int dim, float tf, int64_t n, bool* __restrict__ viol,
    int32_t* __restrict__ out, int32_t* __restrict__ pay) {
  const int64_t i = rt::global_index();
  if (i >= n) return;
  const int p = dim + 1;
  const int32_t* ip = in_pay + 3 * i * p;
  const int32_t* op = out_pay + 3 * i * p;
  // column j of the row: K, A per direction, K - A per direction
  auto column = [&](int j, float (&c)[7]) {
    uint32_t in[3], k = j < dim ? static_cast<uint32_t>(x[i * dim + j]) : 1u;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      in[v] = static_cast<uint32_t>(ip[v * p + j]);
      k += in[v];
    }
    c[0] = to_f32(k);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const uint32_t ag = in[v] + static_cast<uint32_t>(op[v * p + j]);
      c[1 + v] = to_f32(ag);
      c[4 + v] = to_f32(k - ag);
    }
  };
  float cnt[7];
  column(dim, cnt);
  float best = 0.f;
  bool any[3] = {false, false, false}, sel[3] = {false, false, false};
  for (int m0 = 0; m0 < m_dirs; m0 += kTileM) {
    const int tm = min(kTileM, m_dirs - m0);
    float acc[kTileM][7];
    for (int j = 0; j < dim; ++j) {
      float c[7];
      column(j, c);
#pragma unroll
      for (int t = 0; t < kTileM; ++t) {
        if (t < tm) {
          const float u = __ldg(cover + (m0 + t) * dim + j);
#pragma unroll
          for (int q = 0; q < 7; ++q) {
            const float pu = __fmul_rn(c[q], u);
            acc[t][q] = j == 0 ? pu : __fadd_rn(acc[t][q], pu);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTileM; ++t) {
      if (t < tm) {
        float f[7];
#pragma unroll
        for (int q = 0; q < 7; ++q) f[q] = __fsub_rn(acc[t][q], __fmul_rn(tf, cnt[q]));
        bool vm[3];
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float pa = f[1 + v], pka = f[4 + v];
          vm[v] = (pa >= 0.f && pka < 0.f) || (pa < 0.f && pka > 0.f);
          any[v] = any[v] || vm[v];
        }
        if (m0 + t == 0 || f[0] > best) {  // the first maximum
          best = f[0];
#pragma unroll
          for (int v = 0; v < 3; ++v) sel[v] = vm[v];
        }
      }
    }
  }
  const bool outside = best >= 0.f;
#pragma unroll
  for (int v = 0; v < 3; ++v) viol[3 * i + v] = outside ? sel[v] : any[v];
  for (int j = 0; j < p; ++j) {
    uint32_t k = j < dim ? static_cast<uint32_t>(x[i * dim + j]) : 1u;
#pragma unroll
    for (int v = 0; v < 3; ++v) k += static_cast<uint32_t>(ip[v * p + j]);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      pay[(3 * i + v) * p + j] =
          static_cast<int32_t>(k - static_cast<uint32_t>(ip[v * p + j]));
    }
  }
  out[i] = outside ? 1 : 0;
}

constexpr int kL2MaxDim = 8;                    // instantiated D = 1..8
constexpr int kSmemFloats = 48 * 1024 / 4;      // static shared budget

template <int D>
cudaError_t launch_l2(const void* in_pay, const void* out_pay, const void* x,
                      const void* cover, int m_dirs, float tf, int64_t n,
                      void* viol, void* out, void* pay, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(m_dirs) * D;
  l2_threshold_kernel<D><<<rt::blocks_for(n), rt::kThreads, smem, stream>>>(
      static_cast<const int32_t*>(in_pay), static_cast<const int32_t*>(out_pay),
      static_cast<const int32_t*>(x), static_cast<const float*>(cover), m_dirs,
      tf, n, static_cast<bool*>(viol), static_cast<int32_t*>(out),
      static_cast<int32_t*>(pay));
  return cudaGetLastError();
}

int launch_linear(const void* in_pay, const void* out_pay, const void* x,
                  uint32_t a, uint32_t b, int64_t n, void* viol, void* out,
                  void* pay, void* stream) {
  if (n > 0) {
    linear_threshold_kernel<<<rt::blocks_for(n), rt::kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(in_pay),
        static_cast<const int32_t*>(out_pay), static_cast<const int32_t*>(x),
        a, b, n, static_cast<bool*>(viol), static_cast<int32_t*>(out),
        static_cast<int32_t*>(pay));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The linear problems: margin = a q - b c (majority: a = 2, b = 1; mean:
// a = 1, b = T, its fixed-point threshold). a and b multiply modulo 2^32,
// as the reference's int32 products wrap.
RT_EXPORT int rt_threshold_step_linear(const void* in_pay, const void* out_pay,
                                       const void* x, int32_t a, int32_t b,
                                       int64_t n, void* viol, void* out,
                                       void* pay, void* stream) {
  return launch_linear(in_pay, out_pay, x, static_cast<uint32_t>(a),
                       static_cast<uint32_t>(b), n, viol, out, pay, stream);
}

// The L2 form with the cover in shared memory: 1 <= dim <= 8 and
// M D <= 12,288 floats (the wrapper picks this entry only there).
RT_EXPORT int rt_threshold_step_l2(const void* in_pay, const void* out_pay,
                                   const void* x, const void* cover,
                                   int32_t m_dirs, int32_t dim, float tf,
                                   int64_t n, void* viol, void* out, void* pay,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dim < 1 || m_dirs < 1 || dim > kL2MaxDim ||
      static_cast<int64_t>(m_dirs) * dim > kSmemFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (dim) {
#define RT_L2_CASE(DD)                                                     \
  case DD:                                                                 \
    rc = launch_l2<DD>(in_pay, out_pay, x, cover, m_dirs, tf, n, viol, out, \
                       pay, s);                                            \
    break;
    RT_L2_CASE(1)
    RT_L2_CASE(2)
    RT_L2_CASE(3)
    RT_L2_CASE(4)
    RT_L2_CASE(5)
    RT_L2_CASE(6)
    RT_L2_CASE(7)
    RT_L2_CASE(8)
#undef RT_L2_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(rc);
}

// The general L2 form: any dim >= 1 and m_dirs >= 1, the cover in global
// memory (the wrapper picks it where the shared-memory form does not fit).
RT_EXPORT int rt_threshold_step_l2_general(
    const void* in_pay, const void* out_pay, const void* x, const void* cover,
    int32_t m_dirs, int32_t dim, float tf, int64_t n, void* viol, void* out,
    void* pay, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dim < 1 || m_dirs < 1) return static_cast<int>(cudaErrorInvalidValue);
  l2_threshold_general_kernel<<<rt::blocks_for(n), rt::kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(in_pay), static_cast<const int32_t*>(out_pay),
      static_cast<const int32_t*>(x), static_cast<const float*>(cover), m_dirs,
      dim, tf, n, static_cast<bool*>(viol), static_cast<int32_t*>(out),
      static_cast<int32_t*>(pay));
  return static_cast<int>(cudaGetLastError());
}
