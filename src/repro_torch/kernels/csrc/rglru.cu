// rglru_scan: the RG-LRU diagonal linear recurrence h_t = a_t h_{t-1} + u_t,
// or, reversed, h_t = a_t h_{t+1} + u_t from t = T - 1 down to 0.
//
// Replaces the Pallas kernel rglru_scan (src/repro/kernels/rglru/rglru.py:56,
// body _rglru_kernel :32). Semantics: the plain version
// linear_scan_reference (repro_torch/kernels/rglru/ref.py): (B, T, W)
// inputs a and u, optional h0 (B, W); returns h (B, T, W) and h_T (B, W)
// in the inputs' type (float32 or bfloat16), with the state in float32.
// The backward of the scan (repro_torch/kernels/rglru/ops.py) runs this
// kernel in reverse mode.
//
// Bound on the H100: bytes (2 reads and 1 write of the input type per
// element, 2 flops). The Pallas kernel walks T in order per channel tile
// with the state in VMEM. A thread per (b, w) channel walking T, the
// direct translation, holds only B * W threads: at B = 1, W = 4096 that
// is ~131 KB of loads in flight chip-wide, against the ~3 MB that
// 3.35 TB/s needs at ~1 us of loaded latency. So this kernel is parallel
// in time as well:
//
//  * A CTA owns a slab of C channels of one batch row and walks all of T
//    in tiles of TT steps. The tiles stream through a kStages-deep ring in
//    shared memory filled by 16-byte cp.async copies (16 KB a stage at
//    C = 32, so ~48 KB of loads in flight per CTA).
//  * Inside a tile each channel is scanned by NL = 256 / C time lanes,
//    S = TT / NL steps each. Pass 1 scans each lane's sub-chunk from a
//    zero state into the pair (prod a, local h). Each lane then folds
//    the pairs of the lanes before it onto the tile's incoming carry
//    through shared memory, under (a1, u1) . (a2, u2) = (a1 a2, u1 a2 + u2).
//    Pass 2 rescans the sub-chunk from that carry-in and writes h over u
//    in the stage, which then goes out in 16-byte stores. The last
//    lane's final state is the next tile's carry and, after the last
//    tile, h_T. The state and every carry stay float32: nothing is
//    reseeded from the rounded h.
//  * Each thread's copies are the same (array, row, chunk) in every tile,
//    so their offsets are computed once; the per-element work is loads
//    and FMAs from shared memory.
//  * Steps past T and channels past W read as the identity (a = 1, u = 0)
//    and are not stored.
//  * Reverse mode maps the scan's step s to the row t = T - 1 - s where it
//    loads and stores, so the backward needs no flipped copies.
//  * Rows that are not 16-byte aligned (W * sizeof(T) % 16 != 0, or a base
//    pointer off 16 bytes) fill the ring with scalar loads and store h
//    directly: the same kernel and launch, without the asynchronous ring.
//
// HBM traffic stays one read of a and u and one write of h.
#include "common.cuh"
#include "dtype.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;
// channels per CTA: 64-byte bfloat16 and 128-byte float32 tile rows, 128
// CTAs at B = 1, W = 4096. It beat 16 channels (256 CTAs) at that shape in
// both dtypes on the H100 (PERF.md, section 6)
constexpr int C = 32;

// time steps per tile: 16 KB of (a, u) a stage at C = 32 in either type
template <typename T>
__host__ __device__ constexpr int tile_steps() {
  return sizeof(T) == 2 ? 128 : 64;
}

template <typename T>
constexpr size_t smem_bytes() {
  return kStages * 2 * tile_steps<T>() * C * sizeof(T) +
         (2 * kThreads + 2 * C) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ u,
                  const T* __restrict__ h0, int64_t steps, int64_t width,
                  bool reverse, bool vec, T* __restrict__ h,
                  T* __restrict__ h_last) {
  constexpr int NL = kThreads / C;        // time lanes per channel
  constexpr int TT = tile_steps<T>();     // steps per tile
  constexpr int S = TT / NL;              // steps per lane
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int CPR = C / kChunk;         // copies per tile row
  constexpr int kCopies = 2 * TT * CPR / kThreads;  // per thread a stage
  constexpr int kScalars = 2 * TT * C / kThreads;
  static_assert(S >= 1 && TT % NL == 0 && C % kChunk == 0 &&
                    kCopies * kThreads == 2 * TT * CPR &&
                    (TT * CPR) % kThreads == 0,
                "tile shape");
  // the identity's bits, two bfloat16 or one float32 per word
  constexpr unsigned kOne = sizeof(T) == 2 ? 0x3F803F80u : 0x3F800000u;

  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [kStages][a, u][TT][C]
  float* pair_a = reinterpret_cast<float*>(tiles + kStages * 2 * TT * C);
  float* pair_h = pair_a + NL * C;        // [NL][C] each
  float* carry = pair_h + NL * C;         // [2][C], by tile parity

  const int tid = threadIdx.x, c = tid % C, lane = tid / C;
  const int64_t nslab = (width + C - 1) / C;
  const int64_t b = blockIdx.x / nslab;
  const int64_t c0 = (blockIdx.x % nslab) * C;
  const bool valid = c0 + c < width;
  const int64_t ntiles = (steps + TT - 1) / TT;
  // step s of channel c0 + j sits at element base + s * dir + j
  const int64_t dir = reverse ? -width : width;
  const int64_t base = (b * steps + (reverse ? steps - 1 : 0)) * width + c0;

  // this thread's 16-byte copies of a stage, the same (array, row, chunk)
  // in every tile: arrays a (copies before kCopies / 2) then u
  int64_t src[kCopies];
  int dst[kCopies], row[kCopies];
  bool chan_ok[kCopies];
#pragma unroll
  for (int it = 0; it < kCopies; ++it) {
    const int q = tid + it * kThreads - (it * kThreads / (TT * CPR)) * TT * CPR;
    row[it] = q / CPR;
    dst[it] = (it * kThreads / (TT * CPR)) * TT * C + q * kChunk;
    src[it] = base + row[it] * dir + (q % CPR) * kChunk;
    chan_ok[it] = c0 + (q % CPR) * kChunk < width;
  }

  // fill the ring stage of tile k (identity past T and W)
  auto fill = [&](int64_t k) {
    T* stage = tiles + (k % kStages) * 2 * TT * C;
    const int64_t left = steps - k * TT, koff = k * TT * dir;
    if (vec) {
#pragma unroll
      for (int it = 0; it < kCopies; ++it) {
        const bool is_u = it * kThreads >= TT * CPR;
        if (row[it] < left && chan_ok[it]) {
          cp_async16(stage + dst[it], (is_u ? u : a) + src[it] + koff);
        } else {
          const unsigned v = is_u ? 0u : kOne;
          *reinterpret_cast<uint4*>(stage + dst[it]) = make_uint4(v, v, v, v);
        }
      }
    } else {
#pragma unroll 8
      for (int it = 0; it < kScalars; ++it) {
        const int e = tid + it * kThreads;
        const int arr = e / (TT * C), r = (e / C) % TT, cc = e % C;
        T v = rt::from_f32<T>(arr ? 0.0f : 1.0f);
        if (r < left && c0 + cc < width)
          v = (arr ? u : a)[base + r * dir + koff + cc];
        stage[(arr * TT + r) * C + cc] = v;
      }
    }
  };

  const float init =
      h0 != nullptr && valid ? rt::to_f32(h0[b * width + c0 + c]) : 0.0f;
  if (lane == 0) carry[c] = init;
  float state = init;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < ntiles) fill(k);
    cp_async_commit();
  }
  for (int64_t k = 0; k < ntiles; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of tile k landed
    __syncthreads();  // everyone's landed; tile k - 1's stage is free
    if (k + kStages - 1 < ntiles) fill(k + kStages - 1);
    cp_async_commit();

    T* stage = tiles + (k % kStages) * 2 * TT * C;
    const T* ta = stage + lane * S * C + c;
    T* tu = stage + TT * C + lane * S * C + c;
    // pass 1: this lane's sub-chunk from a zero state
    float pa = 1.0f, ph = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float av = rt::to_f32(ta[i * C]);
      ph = av * ph + rt::to_f32(tu[i * C]);
      pa *= av;
    }
    pair_a[lane * C + c] = pa;
    pair_h[lane * C + c] = ph;
    __syncthreads();
    // carry-in: the tile's carry with the earlier lanes' pairs folded on
    // (unrolled, so every pair load issues before the chain of FMAs)
    float x = carry[(k & 1) * C + c];
#pragma unroll
    for (int j = 0; j < NL - 1; ++j) {
      const float pj = pair_a[j * C + c], hj = pair_h[j * C + c];
      x = j < lane ? pj * x + hj : x;
    }
    // pass 2: rescan from the carry-in. h goes over u in the stage (each
    // element is read and written by its own thread only), then out in
    // 16-byte stores; on the scalar path straight to h
    const int64_t s0 = k * TT + lane * S, left = steps - s0;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      x = rt::to_f32(ta[i * C]) * x + rt::to_f32(tu[i * C]);
      if (vec)
        tu[i * C] = rt::from_f32<T>(x);
      else if (valid && i < left)
        h[base + (s0 + i) * dir + c] = rt::from_f32<T>(x);
    }
    if (lane == NL - 1) {
      carry[((k + 1) & 1) * C + c] = x;
      state = x;
    }
    if (vec) {
      __syncthreads();
      const int64_t rows_left = steps - k * TT, koff = k * TT * dir;
#pragma unroll
      for (int it = kCopies / 2; it < kCopies; ++it)
        if (row[it] < rows_left && chan_ok[it])
          *reinterpret_cast<uint4*>(h + src[it] + koff) =
              *reinterpret_cast<const uint4*>(stage + dst[it]);
    }
  }
  if (lane == NL - 1 && valid)
    h_last[b * width + c0 + c] = rt::from_f32<T>(state);
}

template <typename T>
int launch(const void* a, const void* u, const void* h0, int64_t batch,
           int64_t steps, int64_t width, bool reverse, void* h, void* h_last,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T>();
  const cudaError_t e = cudaFuncSetAttribute(
      rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = (width * sizeof(T)) % 16 == 0 && aligned(a) &&
                   aligned(u) && aligned(h);
  const int64_t blocks = batch * ((width + C - 1) / C);
  rglru_scan_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                         stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(u),
      static_cast<const T*>(h0), steps, width, reverse, vec,
      static_cast<T*>(h), static_cast<T*>(h_last));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16: 1 when a, u, h0, h and h_last are bfloat16, 0 when float32.
// h0 may be null (a zero initial state). reverse: 1 scans from T - 1 down
// to 0. Requires batch * width > 0.
RT_EXPORT int rt_rglru_scan(const void* a, const void* u, const void* h0,
                            int bf16, int reverse, int64_t batch,
                            int64_t steps, int64_t width, void* h,
                            void* h_last, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(a, u, h0, batch, steps, width,
                                 reverse != 0, h, h_last, s);
  return launch<float>(a, u, h0, batch, steps, width, reverse != 0, h,
                       h_last, s);
}
