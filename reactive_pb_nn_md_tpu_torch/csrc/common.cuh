// Shared helpers for the port's hand-written Hopper kernels.
//
// Every entry point is extern "C", launches on the stream it is given,
// allocates nothing, does not synchronize, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define KERNELS_API extern "C" __attribute__((visibility("default")))

// precision-generic math: float -> the f-suffixed intrinsics
__device__ __forceinline__ float t_exp(float x) { return expf(x); }
__device__ __forceinline__ double t_exp(double x) { return exp(x); }
__device__ __forceinline__ float t_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double t_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float t_erfc(float x) { return erfcf(x); }
__device__ __forceinline__ double t_erfc(double x) { return erfc(x); }
__device__ __forceinline__ float t_fma(float a, float b, float c) {
    return fmaf(a, b, c);
}
__device__ __forceinline__ double t_fma(double a, double b, double c) {
    return fma(a, b, c);
}
// a product that is never fused into a multiply-add
__device__ __forceinline__ float t_mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double t_mul(double a, double b) {
    return __dmul_rn(a, b);
}
// round half to even, like torch.round
__device__ __forceinline__ float t_rint(float x) { return rintf(x); }
__device__ __forceinline__ double t_rint(double x) { return rint(x); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    return v;
}

// the warp's sum in every lane; the xor butterfly adds the same two
// values in every pair of lanes, so all lanes get the same bits
template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Dynamic shared memory above 48 KB must be allowed per kernel first.
static inline int allow_smem(const void* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
