// CPU emulation (see cuda_runtime.h) of the bf16 type and the
// conversions the kernels use: bf16 -> float exactly, float -> bf16
// rounded to nearest even (NaN kept quiet), as the CUDA intrinsics do, and
// the raw 16 bits of a bf16.
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  std::uint16_t x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const std::uint32_t u = static_cast<std::uint32_t>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  std::uint32_t u;
  std::memcpy(&u, &f, 4);
  __nv_bfloat16 h;
  if ((u & 0x7F800000u) == 0x7F800000u && (u & 0x007FFFFFu)) {
    h.x = static_cast<std::uint16_t>((u >> 16) | 0x0040u);
    return h;
  }
  u += 0x7FFFu + ((u >> 16) & 1u);
  h.x = static_cast<std::uint16_t>(u >> 16);
  return h;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 h) { return h.x; }
