// Kernel B: PME charge spreading (B1) and its backward gather (B2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:_spread_kernel
// (forward) and _gather_kernel + _charge_grid_bwd (backward).  The spline
// weights w and derivatives dw (N, 3, order) and the base grid points
// nearpt (N, 3) are computed in torch (ops/bspline.py); grid point of
// slot k along an axis is (nearpt - k) mod K.
//
// B1: one thread per (atom, brick element) adds q * w0 * w1 * w2 straight
// into the K^3 grid with atomicAdd under modular wrap -- the TPU's
// halo-padded grid and halo fold are not needed.  Bound: order^3 = 216
// scattered atomics per atom (140k at the flagship box, fp64 atomics are
// native on sm_90); the 32^3 grid (256 KB in fp64) stays in L2.
// B2: one warp per atom gathers the 216 cotangent values, contracts them
// with the spline values and derivatives, and writes dE/dq and
// dE/dx = K * (dE/du) @ recip directly.  The box gets no cotangent.
#include "common.cuh"

template <typename T>
__global__ void spread_kernel(const T* __restrict__ w,
                              const long long* __restrict__ nearpt,
                              const T* __restrict__ q, T* __restrict__ grid,
                              int n, int K, int order) {
    const int o3 = order * order * order;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n * o3) return;
    const int a = (int)(t / o3);
    const int e = (int)(t % o3);
    const int i = e / (order * order), j = (e / order) % order,
              k = e % order;
    const T* wa = w + (size_t)a * 3 * order;
    const long long* np = nearpt + (size_t)a * 3;
    const int g0 = (int)((np[0] - i + K) % K);
    const int g1 = (int)((np[1] - j + K) % K);
    const int g2 = (int)((np[2] - k + K) % K);
    const T v = q[a] * wa[i] * wa[order + j] * wa[2 * order + k];
    atomicAdd(grid + ((size_t)g0 * K + g1) * K + g2, v);
}

template <typename T>
__global__ void gather_kernel(const T* __restrict__ gq_grid,
                              const T* __restrict__ w,
                              const T* __restrict__ dw,
                              const long long* __restrict__ nearpt,
                              const T* __restrict__ q,
                              const T* __restrict__ recip,
                              T* __restrict__ gq, T* __restrict__ gx,
                              int n, int K, int order) {
    const int lane = threadIdx.x & 31;
    const int a = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (a >= n) return;
    const int o3 = order * order * order;
    const T* wa = w + (size_t)a * 3 * order;
    const T* da = dw + (size_t)a * 3 * order;
    const long long* np = nearpt + (size_t)a * 3;
    T s_q = 0, s0 = 0, s1 = 0, s2 = 0;
    for (int e = lane; e < o3; e += 32) {
        const int i = e / (order * order), j = (e / order) % order,
                  k = e % order;
        const int g0 = (int)((np[0] - i + K) % K);
        const int g1 = (int)((np[1] - j + K) % K);
        const int g2 = (int)((np[2] - k + K) % K);
        const T c = gq_grid[((size_t)g0 * K + g1) * K + g2];
        const T w0 = wa[i], w1 = wa[order + j], w2 = wa[2 * order + k];
        s_q += c * w0 * w1 * w2;
        s0 += c * da[i] * w1 * w2;
        s1 += c * w0 * da[order + j] * w2;
        s2 += c * w0 * w1 * da[2 * order + k];
    }
    s_q = warp_sum(s_q);
    s0 = warp_sum(s0);
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
        const T qa = q[a];
        gq[a] = s_q;
        for (int c = 0; c < 3; ++c)
            gx[(size_t)a * 3 + c] = (T)K * qa
                * (s0 * recip[c] + s1 * recip[3 + c] + s2 * recip[6 + c]);
    }
}

template <typename T>
static int spread_launch(const void* w, const void* nearpt, const void* q,
                         void* grid, void* stream, int n, int K, int order) {
    const long long total = (long long)n * order * order * order;
    const int threads = 256;
    const int blocks = (int)((total + threads - 1) / threads);
    if (blocks > 0)
        spread_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const T*)w, (const long long*)nearpt, (const T*)q, (T*)grid, n,
            K, order);
    return (int)cudaGetLastError();
}

template <typename T>
static int gather_launch(const void* gq_grid, const void* w, const void* dw,
                         const void* nearpt, const void* q,
                         const void* recip, void* gq, void* gx, void* stream,
                         int n, int K, int order) {
    const int threads = 256;                    // 8 atoms per block
    const int blocks = (n * 32 + threads - 1) / threads;
    if (blocks > 0)
        gather_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
            (const T*)gq_grid, (const T*)w, (const T*)dw,
            (const long long*)nearpt, (const T*)q, (const T*)recip, (T*)gq,
            (T*)gx, n, K, order);
    return (int)cudaGetLastError();
}

KERNELS_API int pme_spread_f32(const void* w, const void* nearpt,
                               const void* q, void* grid, void* stream,
                               int n, int K, int order) {
    return spread_launch<float>(w, nearpt, q, grid, stream, n, K, order);
}

KERNELS_API int pme_spread_f64(const void* w, const void* nearpt,
                               const void* q, void* grid, void* stream,
                               int n, int K, int order) {
    return spread_launch<double>(w, nearpt, q, grid, stream, n, K, order);
}

KERNELS_API int pme_gather_f32(const void* gq_grid, const void* w,
                               const void* dw, const void* nearpt,
                               const void* q, const void* recip, void* gq,
                               void* gx, void* stream, int n, int K,
                               int order) {
    return gather_launch<float>(gq_grid, w, dw, nearpt, q, recip, gq, gx,
                                stream, n, K, order);
}

KERNELS_API int pme_gather_f64(const void* gq_grid, const void* w,
                               const void* dw, const void* nearpt,
                               const void* q, const void* recip, void* gq,
                               void* gx, void* stream, int n, int K,
                               int order) {
    return gather_launch<double>(gq_grid, w, dw, nearpt, q, recip, gq, gx,
                                 stream, n, K, order);
}
