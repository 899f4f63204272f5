// The d-bit address algebra of the binary routing tree (paper §2) as
// __device__ functions on 32-bit unsigned addresses, d <= 32. A port of
// repro_torch/core/addressing.py (itself the counterpart of
// repro/core/addressing.py): uint32 arithmetic wraps exactly as the
// reference's wrapping uint32 does, and every result that can wrap is
// masked to 2^d - 1. The mask is built in 64 bits: with d = 32,
// `1u << 32` would be undefined.
#pragma once
#include <cstdint>

namespace rt {

__device__ __forceinline__ uint32_t dmask(int d) {
  return static_cast<uint32_t>((1ull << d) - 1ull);
}

__device__ __forceinline__ uint32_t lowbit(uint32_t a) { return a & (~a + 1u); }

__device__ __forceinline__ bool is_leaf(uint32_t p) { return (p & 1u) != 0u; }

// Parent position; UP(root) = root.
__device__ __forceinline__ uint32_t up(uint32_t pos, int d) {
  const uint32_t m = lowbit(pos);
  const uint32_t m2 = (m << 1) & dmask(d);  // bit above the lowbit
  const uint32_t out = (pos & m2) ? (pos ^ m) : (((pos ^ m) | m2) & dmask(d));
  return pos == 0u ? pos : out;
}

// Clockwise descendant; CW(root) = 1 0^(d-1).
__device__ __forceinline__ uint32_t cw(uint32_t pos, int d) {
  const uint32_t child = pos | (lowbit(pos) >> 1);
  return pos == 0u ? static_cast<uint32_t>(1ull << (d - 1)) : child;
}

// Counterclockwise descendant; 0 for the root.
__device__ __forceinline__ uint32_t ccw(uint32_t pos, int d) {
  const uint32_t m = lowbit(pos);
  return pos == 0u ? pos : ((pos ^ m) | (m >> 1));
}

// Is address y in the subtree rooted at position x (inclusive)?
__device__ __forceinline__ bool in_subtree(uint32_t x, uint32_t y, int d) {
  const uint32_t s = lowbit(x);
  const uint32_t size = ((s << 1) - 1u) & dmask(d);
  const uint32_t rel = (y - (x - s) - 1u) & dmask(d);
  return x == 0u ? true : rel < size;
}

__device__ __forceinline__ bool is_foreparent(uint32_t x, uint32_t y, int d) {
  return in_subtree(x, y, d) && x != y;
}

// Is y in the clockwise subtree of x, range (x, x + s - 1]?
__device__ __forceinline__ bool in_cw_subtree(uint32_t x, uint32_t y, int d) {
  const uint32_t s = lowbit(x);
  const uint32_t rel = (y - x - 1u) & dmask(d);
  return x == 0u ? (y != 0u) : rel < (s - 1u);
}

// Does addr fall in the ring segment (a_prev, a_self]? The wrapped
// (root) segment has a_prev >= a_self.
__device__ __forceinline__ bool in_segment(uint32_t addr, uint32_t a_prev,
                                           uint32_t a_self) {
  if (a_prev >= a_self) return addr > a_prev || addr <= a_self;
  return addr > a_prev && addr <= a_self;
}

}  // namespace rt
