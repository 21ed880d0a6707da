// Precision-view rounding of one bf16 bit pattern, shared by the unpack,
// KV-inverse and elastic-matmul kernels.
//
// The tail of the TPU kernel src/repro/kernels/bitplane.py::_unpack_kernel
// and of core/precision.py::reconstruct_u16: with `do_round`, the bits
// below the mantissa cut (the guard planes) round the kept mantissa to
// nearest, ties to even; the carry may move into the exponent and the
// magnitude saturates at the Inf pattern 0x7F80.  Inf and NaN keep their
// kept bits, and a NaN whose mantissa would vanish gets 0x40 so it stays
// NaN.  Then only the kept planes (`keep`) survive.  `keep`, `cut` and
// `do_round` come from the view (kernels/bitplane.py::round_params):
// `cut` = 7 - r_m >= 1 whenever `do_round` is set.
#pragma once
#include <stdint.h>

__device__ __forceinline__ uint32_t view_round(uint32_t u, uint32_t keep,
                                               int cut, bool do_round) {
  if (do_round) {
    if ((u & 0x7F80u) == 0x7F80u) {            // Inf / NaN
      uint32_t s = u & keep;
      if ((u & 0x7Fu) != 0u && (s & 0x7Fu) == 0u) s |= 0x40u;
      u = s;
    } else {
      const uint32_t mag = u & 0x7FFFu;
      const uint32_t gmask = (1u << cut) - 1u;
      const uint32_t half = 1u << (cut - 1);
      const uint32_t guard = mag & gmask;
      const uint32_t lsb = (mag >> cut) & 1u;
      const bool up = guard > half || (guard == half && lsb != 0u);
      const uint32_t m = (mag & ~gmask) + (up ? (1u << cut) : 0u);
      u = (u & 0x8000u) | (m < 0x7F80u ? m : 0x7F80u);
    }
  }
  return u & keep;
}
