// Elementwise conversion to a halo wire dtype, shared by the converting
// forms of halo_pack.cu (pack) and halo_signal.cu (put_signal).
//
// Each cast rounds as XLA's convert does, which is what the reference's
// `rows.astype(out_dtype)` computes: one rounding to nearest even, except
// double -> bfloat16, which XLA rounds through float (the single-rounding
// __double2bfloat16 would differ from it at near-ties).  core/wire.py's
// wire_cast is the same rule for the plain forms.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename S, typename D>
struct WireConv;
template <>
struct WireConv<double, float> {
  __device__ static float apply(double x) { return __double2float_rn(x); }
};
template <>
struct WireConv<double, __half> {
  __device__ static __half apply(double x) { return __double2half(x); }
};
template <>
struct WireConv<double, __nv_bfloat16> {
  __device__ static __nv_bfloat16 apply(double x) {
    return __float2bfloat16_rn(__double2float_rn(x));
  }
};
template <>
struct WireConv<float, __half> {
  __device__ static __half apply(float x) { return __float2half_rn(x); }
};
template <>
struct WireConv<float, __nv_bfloat16> {
  __device__ static __nv_bfloat16 apply(float x) {
    return __float2bfloat16_rn(x);
  }
};
