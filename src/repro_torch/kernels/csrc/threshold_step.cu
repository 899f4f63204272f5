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
//       - any other (D, M): the general kernel (below): a block's rows
//         staged coalesced into shared memory as float columns, once,
//         and the cover streamed through shared memory in chunks; a
//         thread folds 8 directions at a time, keeping the running max of
//         f_m(K) with its first argmax, the violation at that argmax and
//         the OR of all, which is the same decision as the two-pass form.
//
// Bound on the H100: bytes for majority, mean and the D <= 8 L2 form
// (majority/mean: 52 bytes in and 31 out per peer for ~30 integer
// operations; L2 at D = 2, M = 16: 80 bytes in, 43 out, ~600 float
// operations). Design: one thread per peer, elementwise; each thread reads
// its in/out rows (contiguous) once. The general L2 form is bound by bytes
// at D = 9, M = 18 (403 bytes and ~2,500 float operations a peer) and by
// the FP32 issue rate for large covers (D = 16, M = 1,024: ~237,000
// operations a peer, each rounded on its own, so no FFMA halves them).
#include <mutex>

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

// ---- The general L2 form: any D >= 1, any M >= 1 --------------------------
//
// A block owns R consecutive peers, one thread each (R = blockDim.x):
//   1. Rows. The block's in_pay, out_pay and x rows are three contiguous
//      ranges; they are staged into shared memory G rows at a time by
//      16-byte cp.async copies (each sector read once). From there each
//      (row, column) cell forms K and A_v once and writes the 7 float32
//      columns (K, A_v, K - A_v) as cols[q][r][j], rows an odd number of
//      floats apart, so neither these writes nor the per-row reads below
//      meet bank conflicts; it overwrites its X_in words with
//      pay = K - X_in, and the staged range goes back out to `pay` in
//      16-byte stores. G = R where the block still fits three to an SM
//      (a wide row, D = 16, stages in groups). Blocks are persistent: with
//      G = R the next tile's rows are copied in while this one computes.
//   2. Cover. The directions stream through shared memory in chunks of CM,
//      transposed (u[j][m]) and double-buffered by 4-byte cp.async while
//      the previous chunk is computed; every thread reads the same words,
//      so each read is a broadcast.
//   3. Tiles. A thread runs kTileM = 8 directions at a time (then 4, 2, 1
//      for a chunk's tail): per column j, 7 shared loads of its row and a
//      16-byte load per 4 directions feed 56 independent
//      __fmul_rn / __fadd_rn chains. Tf * c is rounded once per row. Across
//      tiles the thread keeps the running max of f_m(K) with its first
//      argmax, the violation at that argmax and the OR of all.
// Where a block's columns do not fit in 227 KB even at R = 32 (D of about
// 190 and more), the kernel stages JC columns at a time instead (4-byte
// copies), for each tile of directions in turn: the rows are read once per
// tile and pay is written on the first.
constexpr int kTileM = 8;               // directions per register tile
constexpr int kGenRows = 128;           // rows per block, halved to fit ...
constexpr int kGenMinRows = 32;         // ... down to one warp
constexpr int kGenGroupStep = 8;        // rows staged at a time: 8 k, <= R
constexpr int kGenSmemMax = 232448;     // 227 KB of dynamic shared memory
constexpr int kGenSmemPerSM = 233472;   // 228 KB an SM, 1 KB of it
constexpr int kGenSmemReserved = 1024;  // reserved for each block
constexpr int kGenMinBlocks = 3;        // __launch_bounds__: <= 170 regs
constexpr int kGenCoverBytes = 4096;    // two cover chunks, at most

struct L2Geometry {
  int rows;      // R, rows (threads) per block
  int group;     // G, rows staged at a time
  int jc;        // columns staged at a time (D + 1 when resident)
  int cm;        // directions per cover chunk
  int resident;  // 1: columns staged once, the cover double-buffered
  size_t smem;   // dynamic shared memory, bytes
};

__host__ __device__ constexpr int64_t round_up(int64_t a, int64_t b) {
  return (a + b - 1) / b * b;
}

// floats of the staged columns: 7 planes of rows of jc | 1 (an odd row
// stride keeps both the cell writes and the per-row reads conflict-free)
__host__ __device__ constexpr int64_t cols_floats(int64_t rows, int64_t jc) {
  return round_up(7 * rows * (jc | 1), 4);
}

// words of a staged group: in and out (3 w a row), x (xs a row)
__host__ __device__ constexpr int64_t stage_words(int64_t group, int64_t w,
                                                  int64_t xs) {
  return 2 * round_up(group * 3 * w, 4) + round_up(group * xs, 4);
}

size_t gen_smem(int rows, int group, int64_t jc, int64_t xs,
                int64_t cover_floats) {
  return static_cast<size_t>(
      4 * (cols_floats(rows, jc) + stage_words(group, jc, xs) +
           cover_floats));
}

L2Geometry l2_geometry(int dim, int m_dirs) {
  const int p = dim + 1;
  const int64_t m8 = round_up(m_dirs, kTileM);
  int cm = kGenCoverBytes / (2 * 4 * dim) / kTileM * kTileM;
  cm = cm < kTileM ? kTileM : cm;
  int bufs = 2;
  if (cm >= m8) {
    cm = static_cast<int>(m8);
    bufs = 1;
  }
  // the most threads an SM (at most kGenMinBlocks blocks of kGenRows, by
  // registers), then the most rows staged at a time, then the most rows
  L2Geometry best{0, 0, p, cm, 1, 0};
  int best_threads = 0;
  for (int rows = kGenRows; rows >= kGenMinRows; rows /= 2)
    for (int g = rows; g >= kGenGroupStep; g -= kGenGroupStep) {
      const size_t smem =
          gen_smem(rows, g, p, dim, static_cast<int64_t>(bufs) * cm * dim);
      if (smem > kGenSmemMax) continue;
      const int blocks = static_cast<int>(
          kGenSmemPerSM / (smem + kGenSmemReserved));
      int threads = rows * blocks;
      threads = threads < kGenMinBlocks * kGenRows ? threads
                                                   : kGenMinBlocks * kGenRows;
      if (threads > best_threads ||
          (threads == best_threads && g > best.group)) {
        best = {rows, g, p, cm, 1, smem};
        best_threads = threads;
      }
    }
  if (best_threads > 0) return best;
  // column chunks: the widest that fit (about 1,200 bytes a column)
  const int rows = kGenMinRows, g = kGenGroupStep;
  int jc = kGenSmemMax / 1100;
  jc = jc < p ? jc : p;
  while (jc > 1 && gen_smem(rows, g, jc, jc, kTileM * jc) > kGenSmemMax)
    --jc;
  return {rows, g, jc, kTileM, 0, gen_smem(rows, g, jc, jc, kTileM * jc)};
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Directions [m0, m0 + mc) of the (M, dim) cover into u[j * cm + m].
__device__ __forceinline__ void fetch_cover(const float* __restrict__ cover,
                                            int dim, int m0, int mc,
                                            float* u, int cm) {
  for (int i = threadIdx.x; i < mc * dim; i += blockDim.x) {
    const int j = i / mc, m = i - j * mc;
    cp_async4(u + j * cm + m, cover + static_cast<int64_t>(m0 + m) * dim + j);
  }
}

// `words` contiguous int32 from global to shared memory: 16-byte copies
// when both ends are 16-byte aligned (`vec`), then the odd words.
__device__ __forceinline__ void fetch_range(int32_t* dst, const int32_t* src,
                                            int words, bool vec) {
  int done = 0;
  if (vec) {
    const int n16 = words / 4;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      cp_async16(dst + 4 * i, src + 4 * i);
    done = 4 * n16;
  }
  for (int i = done + threadIdx.x; i < words; i += blockDim.x)
    cp_async4(dst + i, src + i);
}

// Rows g .. g + gr - 1, columns [j0, j0 + w), into the stage: st_in and
// st_out [r][v][jj] (3 w a row), st_x [r][jj] (xs a row). Whole rows
// (w = D + 1) are three contiguous ranges, with xs = D.
__device__ __forceinline__ void fetch_rows(
    const int32_t* __restrict__ in_pay, const int32_t* __restrict__ out_pay,
    const int32_t* __restrict__ x, int64_t g, int gr, int dim, int j0, int w,
    int32_t* st_in, int32_t* st_out, int32_t* st_x, bool vec) {
  const int p = dim + 1;
  if (w == p) {
    fetch_range(st_in, in_pay + g * 3 * p, gr * 3 * p, vec);
    fetch_range(st_out, out_pay + g * 3 * p, gr * 3 * p, vec);
    fetch_range(st_x, x + g * dim, gr * dim, vec);
    return;
  }
  for (int i = threadIdx.x; i < gr * 3 * w; i += blockDim.x) {
    const int r = i / (3 * w), vj = i - r * 3 * w, v = vj / w;
    const int64_t src = (g + r) * 3 * p + v * p + j0 + (vj - v * w);
    cp_async4(st_in + i, in_pay + src);
    cp_async4(st_out + i, out_pay + src);
  }
  for (int i = threadIdx.x; i < gr * w; i += blockDim.x) {
    const int r = i / w, j = j0 + i - r * w;
    if (j < dim) cp_async4(st_x + i, x + (g + r) * dim + j);
  }
}

// The staged cells (r, jj), r < gr: cols[q][r][jj] (planes qs apart,
// rows rw apart, from `cols` at the group's first row), and
// pay = K - X_in over the staged X_in. Thread i takes the cells
// i, i + R, ... of the row-major order.
__device__ __forceinline__ void convert_rows(int32_t* st_in,
                                             const int32_t* st_out,
                                             const int32_t* st_x, int xs,
                                             int gr, int dim, int j0, int w,
                                             float* cols, int rw, int qs) {
  const int R = blockDim.x, dr = R / w, dj = R - dr * w;
  int r = threadIdx.x / w, jj = threadIdx.x - r * w;
  for (int e = threadIdx.x; e < gr * w; e += R) {
    int32_t* ip = st_in + r * 3 * w + jj;
    const int32_t* op = st_out + r * 3 * w + jj;
    uint32_t in[3], k = j0 + jj < dim
                            ? static_cast<uint32_t>(st_x[r * xs + jj])
                            : 1u;
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      in[v] = static_cast<uint32_t>(ip[v * w]);
      k += in[v];
    }
    float* c = cols + r * rw + jj;
    c[0] = to_f32(k);
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const uint32_t ag = in[v] + static_cast<uint32_t>(op[v * w]);
      c[(1 + v) * qs] = to_f32(ag);
      c[(4 + v) * qs] = to_f32(k - ag);
      ip[v * w] = static_cast<int32_t>(k - in[v]);
    }
    jj += dj;
    r += dr;
    if (jj >= w) {
      jj -= w;
      ++r;
    }
  }
}

// The staged pay of rows g .. g + gr - 1, columns [j0, j0 + w), back out:
// whole rows as one contiguous range (16-byte stores when `vec`).
__device__ __forceinline__ void store_pay(const int32_t* st_in,
                                          int32_t* __restrict__ pay,
                                          int64_t g, int gr, int dim, int j0,
                                          int w, bool vec) {
  const int p = dim + 1;
  if (w == p) {
    int32_t* dst = pay + g * 3 * p;
    const int words = gr * 3 * p;
    int done = 0;
    if (vec) {
      const int n16 = words / 4;
      for (int i = threadIdx.x; i < n16; i += blockDim.x)
        reinterpret_cast<int4*>(dst)[i] =
            reinterpret_cast<const int4*>(st_in)[i];
      done = 4 * n16;
    }
    for (int i = done + threadIdx.x; i < words; i += blockDim.x)
      dst[i] = st_in[i];
    return;
  }
  for (int i = threadIdx.x; i < gr * 3 * w; i += blockDim.x) {
    const int r = i / (3 * w), vj = i - r * 3 * w, v = vj / w;
    pay[(g + r) * 3 * p + v * p + j0 + (vj - v * w)] = st_in[i];
  }
}

// The block's shared memory: the float columns, the row stage, the cover.
struct L2Smem {
  float* cols;
  int32_t *st_in, *st_out, *st_x;
  float* ut;
  int rw, qs;  // row and plane strides of cols
};

// Columns [j0, j0 + w) of the block's rows into the float columns, G rows
// at a time, and their pay out when `write_pay`; rows past `rows` read as
// zeros. `fetched`: the first group's copies are already in flight. Leaves
// every thread past a barrier with the columns in place.
__device__ __forceinline__ void stage_block(
    const int32_t* __restrict__ in_pay, const int32_t* __restrict__ out_pay,
    const int32_t* __restrict__ x, int32_t* __restrict__ pay, int dim,
    int64_t r0, int rows, int group, int j0, int w, bool write_pay, bool vec,
    bool fetched, const L2Smem& s) {
  const int xs = w == dim + 1 ? dim : w;
  for (int g0 = 0; g0 < rows; g0 += group) {
    const int gr = min(group, rows - g0);
    if (g0 > 0 || !fetched) {
      fetch_rows(in_pay, out_pay, x, r0 + g0, gr, dim, j0, w, s.st_in,
                 s.st_out, s.st_x, vec);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    convert_rows(s.st_in, s.st_out, s.st_x, xs, gr, dim, j0, w,
                 s.cols + g0 * s.rw, s.rw, s.qs);
    __syncthreads();
    if (write_pay) store_pay(s.st_in, pay, r0 + g0, gr, dim, j0, w, vec);
    __syncthreads();  // the stage is refilled next
  }
  const int idle = static_cast<int>(blockDim.x) - rows;
  for (int i = threadIdx.x; i < idle * w; i += blockDim.x) {
    float* c = s.cols + (rows + i / w) * s.rw + i % w;
#pragma unroll
    for (int q = 0; q < 7; ++q) c[q * s.qs] = 0.f;
  }
  __syncthreads();
}

// TM consecutive directions of one cover column (16-, 8- or 4-byte
// aligned by the tile's offset).
template <int TM>
__device__ __forceinline__ void load_dirs(const float* u, float (&w)[TM]) {
  if constexpr (TM % 4 == 0) {
#pragma unroll
    for (int t = 0; t < TM; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(u + t);
      w[t] = v.x;
      w[t + 1] = v.y;
      w[t + 2] = v.z;
      w[t + 3] = v.w;
    }
  } else if constexpr (TM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(u);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = u[0];
  }
}

// acc[t][q] over `count` staged columns: c is the thread's row (planes qs
// apart), u the tile's first direction in the first staged cover column
// (columns us apart). `init`: the first staged column is column 0, where
// the sums start.
template <int TM>
__device__ __forceinline__ void accumulate(float (&acc)[TM][7], const float* c,
                                           int qs, const float* u, int us,
                                           int count, bool init) {
  int j = 0;
  if (init) {
    float cv[7], w[TM];
#pragma unroll
    for (int q = 0; q < 7; ++q) cv[q] = c[q * qs];
    load_dirs<TM>(u, w);
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int q = 0; q < 7; ++q) acc[t][q] = __fmul_rn(cv[q], w[t]);
    j = 1;
  }
#pragma unroll 1
  for (; j < count; ++j) {
    float cv[7], w[TM];
#pragma unroll
    for (int q = 0; q < 7; ++q) cv[q] = c[q * qs + j];
    load_dirs<TM>(u + j * us, w);
#pragma unroll
    for (int t = 0; t < TM; ++t)
#pragma unroll
      for (int q = 0; q < 7; ++q)
        acc[t][q] = __fadd_rn(acc[t][q], __fmul_rn(cv[q], w[t]));
  }
}

struct L2Decision {
  float best = 0.f;  // f_m(K) at the first argmax so far
  bool any[3] = {false, false, false}, sel[3] = {false, false, false};
};

// Fold directions m0 .. m0 + TM - 1 into the decision; tc = Tf * column D.
template <int TM>
__device__ __forceinline__ void decide(const float (&acc)[TM][7],
                                       const float (&tc)[7], int m0,
                                       L2Decision& d) {
#pragma unroll
  for (int t = 0; t < TM; ++t) {
    bool vm[3];
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      const float pa = __fsub_rn(acc[t][1 + v], tc[1 + v]);
      const float pka = __fsub_rn(acc[t][4 + v], tc[4 + v]);
      vm[v] = (pa >= 0.f && pka < 0.f) || (pa < 0.f && pka > 0.f);
      d.any[v] = d.any[v] || vm[v];
    }
    const float f0 = __fsub_rn(acc[t][0], tc[0]);
    if (m0 + t == 0 || f0 > d.best) {  // the first maximum
      d.best = f0;
#pragma unroll
      for (int v = 0; v < 3; ++v) d.sel[v] = vm[v];
    }
  }
}

// Resident: the row's D columns are staged; u is the tile in its chunk.
template <int TM>
__device__ __forceinline__ void resident_tile(const float* c, int qs,
                                              const float* u, int cm, int dim,
                                              const float (&tc)[7], int m0,
                                              L2Decision& d) {
  float acc[TM][7];
  accumulate<TM>(acc, c, qs, u, cm, dim, true);
  decide<TM>(acc, tc, m0, d);
}

// Column chunks: stage jc columns of the rows and of directions
// m0 .. m0 + TM - 1 at a time (u[j * kTileM + t]), for this tile alone.
template <int TM>
__device__ void chunked_tile(const int32_t* __restrict__ in_pay,
                             const int32_t* __restrict__ out_pay,
                             const int32_t* __restrict__ x,
                             const float* __restrict__ cover,
                             int32_t* __restrict__ pay, int dim, float tf,
                             int64_t r0, int rows, int group, int jc,
                             bool vec, const L2Smem& s, int m0,
                             float (&tc)[7], L2Decision& d) {
  const int p = dim + 1;
  const float* c = s.cols + threadIdx.x * s.rw;
  float acc[TM][7];
  for (int j0 = 0; j0 < p; j0 += jc) {
    const int w = min(jc, p - j0), wu = min(w, dim - j0);
    __syncthreads();  // every thread is done with the previous columns
    for (int i = threadIdx.x; i < TM * wu; i += blockDim.x) {
      const int jj = i / TM, t = i - jj * TM;
      s.ut[jj * kTileM + t] =
          __ldg(cover + static_cast<int64_t>(m0 + t) * dim + j0 + jj);
    }
    stage_block(in_pay, out_pay, x, pay, dim, r0, rows, group, j0, w,
                m0 == 0, vec, false, s);
    if (wu > 0) accumulate<TM>(acc, c, s.qs, s.ut, kTileM, wu, j0 == 0);
    if (j0 + w == p) {
#pragma unroll
      for (int q = 0; q < 7; ++q)
        tc[q] = __fmul_rn(tf, c[q * s.qs + dim - j0]);
    }
  }
  decide<TM>(acc, tc, m0, d);
}

// The directions [m0, m0 + mc) of one staged cover chunk u, for every
// row of the block: tiles of 8, then 4, 2 and 1.
__device__ __forceinline__ void run_chunk(const float* c, int qs,
                                          const float* u, int cm, int dim,
                                          const float (&tc)[7], int m0,
                                          int mc, L2Decision& d) {
  int t = 0;
  for (; t + 8 <= mc; t += 8)
    resident_tile<8>(c, qs, u + t, cm, dim, tc, m0 + t, d);
  if (mc - t >= 4) {
    resident_tile<4>(c, qs, u + t, cm, dim, tc, m0 + t, d);
    t += 4;
  }
  if (mc - t >= 2) {
    resident_tile<2>(c, qs, u + t, cm, dim, tc, m0 + t, d);
    t += 2;
  }
  if (mc - t >= 1) resident_tile<1>(c, qs, u + t, cm, dim, tc, m0 + t, d);
}

// Persistent: block b takes the row tiles b, b + grid, ... of R rows. When
// a tile's rows are staged in one group, the next tile's rows are copied
// in while this one computes; a one-chunk cover stays staged throughout.
__global__ void __launch_bounds__(kGenRows, kGenMinBlocks)
    l2_threshold_general_kernel(const int32_t* __restrict__ in_pay,
                                const int32_t* __restrict__ out_pay,
                                const int32_t* __restrict__ x,
                                const float* __restrict__ cover, int m_dirs,
                                int dim, float tf, int64_t n, int group,
                                int jc, int cm, int resident, int vec,
                                bool* __restrict__ viol,
                                int32_t* __restrict__ out,
                                int32_t* __restrict__ pay) {
  extern __shared__ __align__(16) float smem[];
  const int R = blockDim.x, p = dim + 1;
  const int xs = resident ? dim : jc;
  L2Smem s;
  s.rw = jc | 1;
  s.qs = R * s.rw;
  s.cols = smem;
  s.st_in = reinterpret_cast<int32_t*>(smem + cols_floats(R, jc));
  s.st_out = s.st_in + round_up(group * 3 * jc, 4);
  s.st_x = s.st_out + round_up(group * 3 * jc, 4);
  s.ut = reinterpret_cast<float*>(s.st_x + round_up(group * xs, 4));
  const float* c = s.cols + threadIdx.x * s.rw;
  const int64_t tiles = (n + R - 1) / R;
  const int chunks = (m_dirs + cm - 1) / cm;
  const bool prefetch = resident && group >= R;
  auto tile_rows = [&](int64_t tile) {
    const int64_t left = n - tile * R;
    return left < R ? static_cast<int>(left) : R;
  };
  if (resident && chunks == 1) {
    fetch_cover(cover, dim, 0, m_dirs, s.ut, cm);
    cp_async_commit();
  }
  if (prefetch && blockIdx.x < tiles) {
    fetch_rows(in_pay, out_pay, x, blockIdx.x * static_cast<int64_t>(R),
               tile_rows(blockIdx.x), dim, 0, p, s.st_in, s.st_out, s.st_x,
               vec);
    cp_async_commit();
  }
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t r0 = tile * R;
    const int rows = tile_rows(tile);
    float tc[7];
    L2Decision d;
    if (resident) {
      if (chunks > 1) {  // lands while the rows are staged
        fetch_cover(cover, dim, 0, cm, s.ut, cm);
        cp_async_commit();
      }
      stage_block(in_pay, out_pay, x, pay, dim, r0, rows, group, 0, p, true,
                  vec, prefetch, s);
      const int64_t next = tile + gridDim.x;
      if (prefetch && next < tiles) {  // lands while this tile computes
        fetch_rows(in_pay, out_pay, x, next * R, tile_rows(next), dim, 0, p,
                   s.st_in, s.st_out, s.st_x, vec);
        cp_async_commit();
      }
#pragma unroll
      for (int q = 0; q < 7; ++q)
        tc[q] = __fmul_rn(tf, c[q * s.qs + dim]);
      if (chunks == 1) {
        run_chunk(c, s.qs, s.ut, cm, dim, tc, 0, m_dirs, d);
      } else {
        for (int ch = 0; ch < chunks; ++ch) {
          if (ch + 1 < chunks) {  // the next chunk flies while this one runs
            const int m1 = (ch + 1) * cm;
            fetch_cover(cover, dim, m1, min(cm, m_dirs - m1),
                        s.ut + ((ch + 1) & 1) * cm * dim, cm);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          __syncthreads();
          const int m0 = ch * cm;
          run_chunk(c, s.qs, s.ut + (ch & 1) * cm * dim, cm, dim, tc, m0,
                    min(cm, m_dirs - m0), d);
          __syncthreads();  // this buffer is refilled next
        }
      }
    } else {
      for (int m0 = 0; m0 < m_dirs;) {
        const int left_m = m_dirs - m0;
        if (left_m >= 8) {
          chunked_tile<8>(in_pay, out_pay, x, cover, pay, dim, tf, r0, rows,
                          group, jc, vec, s, m0, tc, d);
          m0 += 8;
        } else if (left_m >= 4) {
          chunked_tile<4>(in_pay, out_pay, x, cover, pay, dim, tf, r0, rows,
                          group, jc, vec, s, m0, tc, d);
          m0 += 4;
        } else if (left_m >= 2) {
          chunked_tile<2>(in_pay, out_pay, x, cover, pay, dim, tf, r0, rows,
                          group, jc, vec, s, m0, tc, d);
          m0 += 2;
        } else {
          chunked_tile<1>(in_pay, out_pay, x, cover, pay, dim, tf, r0, rows,
                          group, jc, vec, s, m0, tc, d);
          m0 += 1;
        }
      }
    }
    if (static_cast<int>(threadIdx.x) < rows) {
      const int64_t g = r0 + threadIdx.x;
      const bool outside = d.best >= 0.f;
#pragma unroll
      for (int v = 0; v < 3; ++v)
        viol[3 * g + v] = outside ? d.sel[v] : d.any[v];
      out[g] = outside ? 1 : 0;
    }
  }
}

// The launch shape of (device, dim, m_dirs) and the blocks resident on
// the card at once, found on the first launch and kept (at most
// kL2Shapes, the oldest replaced): otherwise every call would repeat the
// geometry search, the opt-in to more than 48 KB and the occupancy query.
struct L2Launch {
  int dev, dim, m_dirs;
  L2Geometry g;
  int64_t fill;
};
constexpr int kL2Shapes = 32;

cudaError_t l2_launch_shape(int dim, int m_dirs, L2Launch& out) {
  static std::mutex mu;
  static L2Launch kept[kL2Shapes];
  static int used = 0, next = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    if (kept[i].dev == dev && kept[i].dim == dim &&
        kept[i].m_dirs == m_dirs) {
      out = kept[i];
      return cudaSuccess;
    }
  }
  L2Launch l{dev, dim, m_dirs, l2_geometry(dim, m_dirs), 0};
  if (l.g.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(l2_threshold_general_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kGenSmemMax);
    if (e != cudaSuccess) return e;
  }
  // persistent: as many blocks as fit on the card at once
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, l2_threshold_general_kernel, l.g.rows, l.g.smem);
  if (e != cudaSuccess) return e;
  l.fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  kept[next] = l;
  next = (next + 1) % kL2Shapes;
  if (used < kL2Shapes) ++used;
  out = l;
  return cudaSuccess;
}

cudaError_t launch_l2_general(const void* in_pay, const void* out_pay,
                              const void* x, const void* cover, int m_dirs,
                              int dim, float tf, int64_t n, void* viol,
                              void* out, void* pay, cudaStream_t stream) {
  L2Launch l;
  const cudaError_t e = l2_launch_shape(dim, m_dirs, l);
  if (e != cudaSuccess) return e;
  const L2Geometry& g = l.g;
  // 16-byte row copies need every row range 16-byte aligned: the bases
  // (row offsets are multiples of 8 rows, 96 (D + 1) and 32 D bytes)
  const bool vec = ((reinterpret_cast<uintptr_t>(in_pay) |
                     reinterpret_cast<uintptr_t>(out_pay) |
                     reinterpret_cast<uintptr_t>(x) |
                     reinterpret_cast<uintptr_t>(pay)) & 15) == 0;
  // at most one block a tile
  const int64_t tiles = (n + g.rows - 1) / g.rows;
  l2_threshold_general_kernel<<<static_cast<unsigned>(
                                    tiles < l.fill ? tiles : l.fill),
                                g.rows, g.smem, stream>>>(
      static_cast<const int32_t*>(in_pay), static_cast<const int32_t*>(out_pay),
      static_cast<const int32_t*>(x), static_cast<const float*>(cover), m_dirs,
      dim, tf, n, g.group, g.jc, g.cm, g.resident, vec,
      static_cast<bool*>(viol), static_cast<int32_t*>(out),
      static_cast<int32_t*>(pay));
  return cudaGetLastError();
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


// The general L2 form: any dim >= 1 and m_dirs >= 1 (the wrapper picks it
// where the shared-memory form does not fit).
RT_EXPORT int rt_threshold_step_l2_general(
    const void* in_pay, const void* out_pay, const void* x, const void* cover,
    int32_t m_dirs, int32_t dim, float tf, int64_t n, void* viol, void* out,
    void* pay, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dim < 1 || m_dirs < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_l2_general(
      in_pay, out_pay, x, cover, m_dirs, dim, tf, n, viol, out, pay,
      static_cast<cudaStream_t>(stream)));
}

// The general form's launch shape for (dim, m_dirs): rows per block, rows
// staged at a time, columns staged at a time, directions per cover chunk,
// resident (1) or column chunks (0), dynamic shared bytes.
RT_EXPORT int rt_threshold_step_l2_general_geometry(int32_t dim,
                                                    int32_t m_dirs,
                                                    int64_t* out6) {
  if (dim < 1 || m_dirs < 1) return static_cast<int>(cudaErrorInvalidValue);
  const L2Geometry g = l2_geometry(dim, m_dirs);
  out6[0] = g.rows;
  out6[1] = g.group;
  out6[2] = g.jc;
  out6[3] = g.cm;
  out6[4] = g.resident;
  out6[5] = static_cast<int64_t>(g.smem);
  return 0;
}
