// flash_attention_fwd: causal / sliding-window GQA attention forward with
// an online softmax, writing the output and the per-row log-sum-exp.
//
// Replaces the Pallas kernel flash_attention_fwd
// (src/repro/kernels/flash_attention/flash_attention.py:101, body
// _flash_kernel :40). Semantics: the plain version pair_fwd
// (repro_torch/kernels/flash_attention/xla_ref.py), itself the reference's
// _pair_fwd: q (B, Hq, Sq, DK), k (B, Hkv, Skv, DK), v (B, Hkv, Skv, DV),
// o (B, Hq, Sq, DV); q head h reads kv head h / (Hq / Hkv). The value
// width DV may differ from the key width DK (the Pallas kernel's dhv,
// :116; MLA attends with DK = 192, DV = 128). Query row i sits at position
// q_offset + i and sees key j iff (not causal or j <= pos) and (no window
// or j > pos - window).
// Running (m, l, acc) in float32, masked scores at -1e30, l clamped at
// 1e-30, o cast to q's type, lse = m + log(l) in float32. Both kernels
// visit only the visible key tiles (the Pallas skip rule, :55-59): causal
// skips tiles that start after the tile's last row, a window skips tiles
// that end at or before its first row's window.
//
// Two routes, by dtype:
//
// bfloat16: the tensor cores (flash_fwd_bf16_kernel). Bound on the H100 by
// operations, 2 (DK + DV) flops per visible (q, k) pair at the 989 TFLOP/s
// dense bf16 rate; below it the per-score softmax work (one exp each on the
// 16-per-clock special-function unit) is the second limit at small D.
// Design: a CTA of kWG = 2 warpgroups owns 128 q rows of one (b, q head),
// 64 rows per warpgroup; they share a two-stage ring of 64-key K and V
// tiles in shared memory. Every tile (Q, K, V) is stored in the 128-byte
// swizzled layout the wgmma descriptors name: a row (DK wide for Q and K,
// DV for V) is cut into 64-column (128-byte) blocks, each block is rows x
// 128 bytes, and the 16-byte chunk c of row r sits at chunk c ^ (r % 8) of
// its row, on 1024-byte-aligned bases. All 256 threads fill the ring with
// cp.async (zero-filling rows past Sq / Skv and the columns past a width
// that is not a multiple of 64, which runs padded to the next one), one
// tile ahead of the compute, so loading the next tile overlaps both
// warpgroups' work on this one. K and V keep widths of their own: at (DK,
// DV) = (192, 128) Q takes 48 KB and a stage of K and V 24 + 16 KB, 129
// KB in all with the alignment slack; one width for all three would pad V
// to 192 (half again the P V work) or everything to 256 (1.6x the work).
// Per tile and warpgroup: S = Q K^T by wgmma m64n64k16 over ceil(DK / 16)
// k-steps (Q and K K-major from shared memory, f32 accumulators in
// registers); the online softmax in registers, each row's max reduced
// over the quad of threads that hold it (two shuffles), the row sums kept
// per thread until the end; masks only on tiles that cut
// the diagonal, the window edge or the ragged edge; P rounded to bf16 in
// place, the f32 accumulator fragment being the A-operand register
// fragment as it stands; O += P V by wgmma with P from registers and V
// from shared memory as an MN-major B operand (the instruction's
// transpose bit: V stays (keys, DV) row-major). O lives in registers, 64 x
// DV per warpgroup: DV / 2 floats a thread (128 at DV = 256). Rounding P to
// bf16 before P V is the one rounding the float32 route does not make;
// l sums the unrounded P. The heaviest q tiles (last under causal) are
// launched first.
//
// float32: the CUDA cores (flash_fwd_f32_kernel; the tensor cores would
// only give TF32). One CTA of 4 warps per (b * Hq + h, 32-row q tile);
// each warp owns 8 rows. Q, K (DK wide) and V (DV wide) tiles are staged
// in shared memory as float32 (K rows padded by 4 floats so each lane's
// float4 reads of its own key row hit distinct banks). Scores: lane j
// computes the dot products of key j with the warp's 8 rows; the row max
// and sum are warp shuffles; P.V: each lane accumulates DV/32 output
// columns of the 8 rows, taking p_j by shuffle. Bound by operations at the
// 67 TFLOP/s float32 rate; D = 256 needs 97 KB of shared memory
// (dynamic, opted in).
//
// Both: edges of Sq and Skv are guarded (rows not stored, keys masked and
// zero-filled); the (DK, DV) pairs built are (D, D) for D in 16, 32, 64,
// 128 and 256, MLA's (192, 128) and its smoke config's (24, 16) (widths
// below 64 pad inside the kernel, as above; DK and DV multiples of 8).
#include <cmath>

#include "common.cuh"
#include "dtype.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- float32: the CUDA-core kernel -----------------------------------------

constexpr int kBQ = 32, kBK = 32, kWarps = 4, kRows = kBQ / kWarps;
constexpr int kFlashThreads = kWarps * 32;

// K rows are padded by 4 floats (see above)
template <int DK, int DV>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (kBQ * DK + kBK * (DK + 4) + kBK * DV);
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

template <int DK, int DV>
__global__ void __launch_bounds__(kFlashThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int hq, int hkv, int sq, int skv,
                     float scale, int causal, int window, int q_offset) {
  static_assert(DK % 4 == 0, "float4 reads of q and k rows");
  constexpr int KS = DK + 4;
  constexpr int NI = (DV + 31) / 32;  // output columns per lane
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // kBQ x DK
  float* ks = qs + kBQ * DK;    // kBK x KS
  float* vs = ks + kBK * KS;    // kBK x DV

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = bh / hq * hkv + (bh % hq) / (hq / hkv);
  const float* qp = q + static_cast<int64_t>(bh) * sq * DK;
  const float* kp = k + static_cast<int64_t>(kvh) * skv * DK;
  const float* vp = v + static_cast<int64_t>(kvh) * skv * DV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kBQ * DK; i += kFlashThreads) {
    const int r = i / DK;
    qs[i] = q0 + r < sq ? qp[static_cast<int64_t>(q0) * DK + i] : 0.0f;
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
    for (int i = threadIdx.x; i < kBK * DK; i += kFlashThreads) {
      const int j = i / DK, d = i % DK;
      ks[j * KS + d] =
          k0 + j < skv ? kp[static_cast<int64_t>(k0) * DK + i] : 0.0f;
    }
    for (int i = threadIdx.x; i < kBK * DV; i += kFlashThreads)
      vs[i] = k0 + i / DV < skv ? vp[static_cast<int64_t>(k0) * DV + i]
                                : 0.0f;
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    const float* krow = ks + lane * KS;
    const float* qrow = qs + warp * kRows * DK;
#pragma unroll 4
    for (int d = 0; d < DK; d += 4) {
      const float4 kv4 = *reinterpret_cast<const float4*>(krow + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qrow + r * DK + d);
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
        vv[c] = d < DV ? vs[j * DV + d] : 0.0f;
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
    float* orow = o + (static_cast<int64_t>(bh) * sq + row) * DV;
#pragma unroll
    for (int c = 0; c < NI; ++c) {
      const int d = lane + 32 * c;
      if (d < DV) orow[d] = acc[r][c] / ll;
    }
    if (lane == 0) lse[static_cast<int64_t>(bh) * sq + row] = m[r] + logf(ll);
  }
}

// ---- bfloat16: the tensor-core kernel --------------------------------------

constexpr int kWG = 2;                 // consumer warpgroups per CTA
constexpr int kTQ = 64 * kWG;          // q rows per CTA
constexpr int kTK = 64;                // keys per tile
constexpr int kTC_threads = 128 * kWG;

// one operand width D in the swizzled layout
template <int D>
struct Cols {
  static_assert(D % 8 == 0, "rows of 16-byte chunks");
  static constexpr int DP = (D + 63) / 64 * 64;  // padded to 64-col blocks
  static constexpr int NB = DP / 64;             // 64-column (128-byte) blocks
  static constexpr int KSTEPS = (D + 15) / 16;   // wgmma k-steps over D
};

template <int DK, int DV>
struct TcShape {
  using K = Cols<DK>;
  using V = Cols<DV>;
  static constexpr uint32_t Q_BYTES = kTQ * K::DP * 2;
  static constexpr uint32_t K_BYTES = kTK * K::DP * 2;  // one K tile
  static constexpr uint32_t V_BYTES = kTK * V::DP * 2;  // one V tile
  static constexpr uint32_t STAGE = K_BYTES + V_BYTES;
  // Q, two stages of (K, V), and slack to align the base to 1024 bytes
  static constexpr size_t SMEM = Q_BYTES + 2 * STAGE + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
         | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
         | (1ull << 62);
}

// rows [row0, row0 + R) of a contiguous (rows, D) bf16 matrix into the
// swizzled layout at `dst`: rows at or past `nrows` and the padding columns
// past D are zero-filled (cp.async with a source size of 0)
template <int D, int R>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* g, int row0,
                                          int nrows, int tid) {
  constexpr int CPR = Cols<D>::DP / 8;  // 16-byte chunks per row
  constexpr int N = R * CPR;
  static_assert(N % kTC_threads == 0, "tile chunks split evenly");
#pragma unroll
  for (int it = 0; it < N / kTC_threads; ++it) {
    const int idx = tid + it * kTC_threads;
    const int r = idx / CPR, c = idx % CPR;
    const bool in = row0 + r < nrows && c * 8 < D;
    const __nv_bfloat16* src =
        in ? g + (static_cast<int64_t>(row0) + r) * D + c * 8 : g;
    const uint32_t a = dst + (c >> 3) * (R * 128) + r * 128
                       + (((c & 7) ^ (r & 7)) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(a), "l"(src), "r"(in ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// this thread's shared-memory writes become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep reads of the accumulators after the wait that completes them
__device__ __forceinline__ void reg_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (+)= A B, m64n64k16, A and B K-major from shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A (4 registers of bf16 pairs) from registers, B
// MN-major from shared memory (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The m64nN f32 accumulator layout: in warpgroup thread t (warp w = t / 32,
// lane l), register i holds row 16 w + l / 4 + 8 ((i >> 1) & 1) and column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). Rows r0 = 16 w + l / 4 and r0 + 8 are
// the thread's two rows (h = 0, 1 below).
template <int DK, int DV>
__global__ void __launch_bounds__(kTC_threads, 1)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int hq, int hkv, int sq, int skv, float scale,
                      int causal, int window, int q_offset) {
  using S = TcShape<DK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + S::Q_BYTES;  // stage st: K at
  // kv_s + st STAGE, V right after it

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTQ;  // heaviest tiles first
  const int bh = blockIdx.y;
  const int kvh = bh / hq * hkv + (bh % hq) / (hq / hkv);
  const __nv_bfloat16* qp = q + static_cast<int64_t>(bh) * sq * DK;
  const __nv_bfloat16* kp = k + static_cast<int64_t>(kvh) * skv * DK;
  const __nv_bfloat16* vp = v + static_cast<int64_t>(kvh) * skv * DV;

  // visible key tiles: [t_begin, t_end) for the CTA's rows, [w_begin,
  // w_end) for this warpgroup's rows (positions w_lo..w_hi)
  const int nk = (skv + kTK - 1) / kTK;
  auto tiles = [&](int lo, int hi, int& b, int& e) {
    b = 0;
    e = nk;
    if (causal) e = min(nk, hi / kTK + 1);
    if (window > 0 && lo - window + 1 > 0) b = min(nk, (lo - window + 1) / kTK);
  };
  const int rows = min(kTQ, sq - q0);
  int t_begin, t_end;
  tiles(q_offset + q0, q_offset + q0 + rows - 1, t_begin, t_end);
  const int w_lo = q_offset + q0 + 64 * wg;
  const int w_hi = q_offset + q0 + min(64 * (wg + 1), rows) - 1;
  int w_begin, w_end;
  tiles(w_lo, w_hi, w_begin, w_end);
  if (w_hi < w_lo) w_end = w_begin;  // no rows of this warpgroup left

  float acc[S::V::NB][32], m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int b = 0; b < S::V::NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[b][i] = 0.0f;
  const float sl2 = scale * kLog2e;

  if (t_begin < t_end) {
    load_tile<DK, kTQ>(q_s, qp, q0, sq, tid);
    load_tile<DK, kTK>(kv_s, kp, t_begin * kTK, skv, tid);
    load_tile<DV, kTK>(kv_s + S::K_BYTES, vp, t_begin * kTK, skv, tid);
    cp_async_commit();
  }
  for (int kt = t_begin; kt < t_end; ++kt) {
    const uint32_t ks = kv_s + ((kt - t_begin) & 1) * S::STAGE;
    if (kt + 1 < t_end) {  // the next tile into the other stage
      const uint32_t nx = kv_s + ((kt + 1 - t_begin) & 1) * S::STAGE;
      load_tile<DK, kTK>(nx, kp, (kt + 1) * kTK, skv, tid);
      load_tile<DV, kTK>(nx + S::K_BYTES, vp, (kt + 1) * kTK, skv, tid);
    }
    cp_async_commit();
    cp_async_wait_prev();  // this tile (and Q) has landed
    fence_async_smem();
    __syncthreads();

    if (kt >= w_begin && kt < w_end) {
      const int k0 = kt * kTK;
      // S = Q K^T over ceil(DK / 16) steps of 16 columns (a padded
      // step's columns are zero in Q and K)
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < S::K::KSTEPS; ++kk) {
        const uint32_t blk = kk >> 2;  // 64-column block, 16-column step
        const uint64_t da = sw128_desc(
            q_s + blk * (kTQ * 128) + wg * (64 * 128) + (kk & 3) * 32, 16,
            1024);
        const uint64_t db =
            sw128_desc(ks + blk * (kTK * 128) + (kk & 3) * 32, 16, 1024);
        wgmma_ss(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      // mask only where the tile cuts the diagonal, window or ragged edge
      const bool full = k0 + kTK <= skv && (!causal || k0 + kTK - 1 <= w_lo)
                        && (window <= 0 || k0 > w_hi - window);
      if (!full) {
        const int r0 = w_lo + warp * 16 + (lane >> 2);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r0 + 8 * ((i >> 1) & 1);
          const int col = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool ok = col < skv;
          if (causal) ok = ok && col <= row;
          if (window > 0) ok = ok && col > row - window;
          if (!ok) s[i] = -INFINITY;
        }
      }

      // online softmax: the two rows' maxima over the quad holding them
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float mb[2], alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale);
        alpha[h] = exp2f((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        mb[h] = m_new * kLog2e;
        l[h] *= alpha[h];
      }
      uint32_t pa[4][4];  // P in bf16, as the A fragments of 4 key steps
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int h = (i >> 1) & 1;
        const float p0 = exp2f(fmaf(s[i], sl2, -mb[h]));
        const float p1 = exp2f(fmaf(s[i + 1], sl2, -mb[h]));
        l[h] += p0 + p1;
        pa[i >> 3][(i >> 1) & 3] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int b = 0; b < S::V::NB; ++b)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[b][i] *= alpha[(i >> 1) & 1];

      // O += P V: 4 key steps x the V tile's column blocks
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kTK / 16; ++kk)
#pragma unroll
        for (int b = 0; b < S::V::NB; ++b)
          wgmma_rs(acc[b], pa[kk],
                   sw128_desc(ks + S::K_BYTES + b * (kTK * 128)
                                  + kk * (16 * 128),
                              kTK * 128, 1024));
      wg_commit();
      wg_wait_all();
#pragma unroll
      for (int b = 0; b < S::V::NB; ++b) reg_fence(acc[b]);
    }
    __syncthreads();  // the stage is consumed: the next load may refill it
  }

  // epilogue: the quad's partial row sums, then o = acc / l and lse
  const int r0 = q0 + 64 * wg + warp * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = r0 + 8 * h;
    if (row >= sq) continue;
    const float ll = fmaxf(l[h], 1e-30f);
    __nv_bfloat16* orow = o + (static_cast<int64_t>(bh) * sq + row) * DV;
#pragma unroll
    for (int b = 0; b < S::V::NB; ++b)
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // 8-column groups of the block
        const int col = b * 64 + 8 * j + 2 * (lane & 3);
        if (col < DV) {
          const int i = 4 * j + 2 * h;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[b][i] / ll, acc[b][i + 1] / ll);
        }
      }
    if ((lane & 3) == 0)
      lse[static_cast<int64_t>(bh) * sq + row] = m[h] + logf(ll);
  }
}

template <typename K>
int opt_in_smem(K kernel, size_t bytes, bool& done) {
  if (bytes > 48 * 1024 && !done) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  return 0;
}

template <int DK, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int b, int hq, int hkv, int sq, int skv,
               float scale, int causal, int window, int q_offset,
               cudaStream_t stream) {
  constexpr size_t bytes = f32_smem_bytes<DK, DV>();
  static bool opted_in = false;  // per instantiation, once per process
  if (const int rc =
          opt_in_smem(flash_fwd_f32_kernel<DK, DV>, bytes, opted_in))
    return rc;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * hq);
  flash_fwd_f32_kernel<DK, DV><<<grid, kFlashThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), hq, hkv, sq, skv, scale, causal, window,
      q_offset);
  return 0;
}

template <int DK, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int b, int hq, int hkv, int sq, int skv,
                float scale, int causal, int window, int q_offset,
                cudaStream_t stream) {
  constexpr size_t bytes = TcShape<DK, DV>::SMEM;
  static_assert(bytes <= 232448, "over the 227 KB a block may use");
  static bool opted_in = false;
  if (const int rc =
          opt_in_smem(flash_fwd_bf16_kernel<DK, DV>, bytes, opted_in))
    return rc;
  const dim3 grid((sq + kTQ - 1) / kTQ, b * hq);
  flash_fwd_bf16_kernel<DK, DV><<<grid, kTC_threads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), hq, hkv, sq, skv, scale, causal, window,
      q_offset);
  return 0;
}

template <int DK, int DV>
int launch(int bf16, const void* q, const void* k, const void* v, void* o,
           void* lse, int b, int hq, int hkv, int sq, int skv, float scale,
           int causal, int window, int q_offset, cudaStream_t s) {
  return bf16 ? launch_bf16<DK, DV>(q, k, v, o, lse, b, hq, hkv, sq, skv,
                                    scale, causal, window, q_offset, s)
              : launch_f32<DK, DV>(q, k, v, o, lse, b, hq, hkv, sq, skv,
                                   scale, causal, window, q_offset, s);
}

}  // namespace

// bf16: 1 when q, k, v and o are bfloat16 (tensor cores; 16-byte aligned
// rows), 0 when float32 (CUDA cores); lse is float32.
// (d, dv), the widths of q and k and of v and o: (D, D) for D in {16, 32,
// 64, 128, 256}, (192, 128) or (24, 16); window <= 0 means no window.
RT_EXPORT int rt_flash_attention_fwd(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int bf16, int b, int hq, int hkv, int sq,
                                     int skv, int d, int dv, float scale,
                                     int causal, int window, int q_offset,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b * hq > 0 && sq > 0) {
    int rc = static_cast<int>(cudaErrorInvalidValue);
#define RT_FLASH_PAIR(DK, DV)                                               \
    if (d == DK && dv == DV)                                                \
      rc = launch<DK, DV>(bf16, q, k, v, o, lse, b, hq, hkv, sq, skv, scale, \
                          causal, window, q_offset, s);
    RT_FLASH_PAIR(16, 16)
    RT_FLASH_PAIR(32, 32)
    RT_FLASH_PAIR(64, 64)
    RT_FLASH_PAIR(128, 128)
    RT_FLASH_PAIR(256, 256)
    RT_FLASH_PAIR(192, 128)
    RT_FLASH_PAIR(24, 16)
#undef RT_FLASH_PAIR
    if (rc != 0) return rc;
  }
  return static_cast<int>(cudaGetLastError());
}
