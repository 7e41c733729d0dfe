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
// B2 (gather_kernel): one warp per atom, four atoms a block (163 blocks
// at the flagship's 649 atoms, so every SM has work).  The 32^3 fp64
// cotangent (256 KB) sits in L2, so B2 is bound by latency and by the
// L1/L2 requests of its gathers, not by bytes: the design takes the index
// arithmetic out of the element loop, contracts separably and makes the
// gathers coalesce.  Each lane wraps the atom's grid indices once, in
// int32 (no 64-bit modulo and no division by the order per element);
// lanes take (j, k) pairs (36 at order 6), k fastest, so the lanes of a
// load read runs of the contiguous z row (wrapped at most once), and
// each walks i: a = sum_i c w0[i], b = sum_i c d0[i], then 4 FMAs add
// w1 w2 a, w1 w2 b, d1 w2 a and w1 d2 a.  (Lanes over (i, j) walking z,
// one row a lane, took 1.3-1.7x the device time: tools/time_spread.py.)
// The order is a template parameter for 4 and 6 (the tests' and the
// decks'); any other order takes the generic path, whose per-atom tables
// sit in shared memory.  The warp's sums (butterfly) run in a fixed
// order: two calls give the same bits.  It writes dE/dq and dE/dx =
// K q (dE/du) @ recip directly; the box gets no cotangent.
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

#define GATHER_WARPS 4              // atoms a block of B2

// v mod K in [0, K): the 64-bit modulo only off the usual range
__device__ __forceinline__ int wrap_index(long long v, int K) {
    if (v >= 0 && v < K) return (int)v;
    const long long r = v % K;
    return (int)(r < 0 ? r + K : r);
}

// Shared memory of the generic gather (O = 0) in bytes: per warp the
// atom's weights and derivatives (3 order each) and wrapped indices (3
// order); the wrapper's gather_smem mirrors it
template <typename T>
static size_t gather_smem_t(int order) {
    return (size_t)GATHER_WARPS * 3 * order * (2 * sizeof(T) + sizeof(int));
}

// Kernel B2: warp `warp` of block b takes atom b GATHER_WARPS + warp;
// lane p takes the (j, k) pairs p, p + 32, ... and walks i.  O > 0: the
// order, known at compile time (O <= K); O = 0: any order, the atom's
// tables in shared memory.
template <typename T, int O>
__global__ void __launch_bounds__(GATHER_WARPS * 32)
gather_kernel(const T* __restrict__ gq_grid, const T* __restrict__ w,
              const T* __restrict__ dw, const long long* __restrict__ nearpt,
              const T* __restrict__ q, const T* __restrict__ recip,
              T* __restrict__ gq, T* __restrict__ gx, int n, int K,
              int order) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int a = blockIdx.x * GATHER_WARPS + warp;
    if (a >= n) return;
    const int o = O > 0 ? O : order;
    const T* wa = w + (size_t)a * 3 * o;
    const T* da = dw + (size_t)a * 3 * o;
    const long long* np = nearpt + (size_t)a * 3;
    T s_q = 0, s0 = 0, s1 = 0, s2 = 0;
    if constexpr (O > 0) {
        // every weight this lane needs, loaded before the base points are
        // wrapped (a warp issues in order: the wrap waits for its load)
        constexpr int NR = (O * O + 31) / 32;
        T w0[O], d0[O], w1[NR], d1[NR], w2[NR], d2[NR];
        int jr[NR], kr[NR];
#pragma unroll
        for (int i = 0; i < O; ++i) {
            w0[i] = wa[i];
            d0[i] = da[i];
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            const int p = lane + 32 * r < O * O ? lane + 32 * r : 0;
            jr[r] = p / O;                              // O: a constant
            kr[r] = p - jr[r] * O;
            w1[r] = wa[O + jr[r]];
            d1[r] = da[O + jr[r]];
            w2[r] = wa[2 * O + kr[r]];
            d2[r] = da[2 * O + kr[r]];
        }
        const int b0 = wrap_index(np[0], K), b1 = wrap_index(np[1], K),
                  b2 = wrap_index(np[2], K);
        size_t g0[O];
        const size_t KK = (size_t)K * K;
#pragma unroll
        for (int i = 0; i < O; ++i) {
            const int g = b0 - i;
            g0[i] = (g < 0 ? g + K : g) * KK;
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
            if (lane + 32 * r < O * O) {
                int gj = b1 - jr[r], gk = b2 - kr[r];
                gj += gj < 0 ? K : 0;
                gk += gk < 0 ? K : 0;
                const T* col = gq_grid + (size_t)gj * K + gk;
                T ca = 0, cb = 0;
#pragma unroll
                for (int i = 0; i < O; ++i) {
                    const T c = __ldg(col + g0[i]);
                    ca = t_fma(c, w0[i], ca);
                    cb = t_fma(c, d0[i], cb);
                }
                const T ww = w1[r] * w2[r];
                s_q = t_fma(ww, ca, s_q);
                s0 = t_fma(ww, cb, s0);
                s1 = t_fma(d1[r] * w2[r], ca, s1);
                s2 = t_fma(w1[r] * d2[r], ca, s2);
            }
        }
    } else {
        // this warp's tables: weights, derivatives, wrapped indices
        const int b0 = wrap_index(np[0], K), b1 = wrap_index(np[1], K),
                  b2 = wrap_index(np[2], K);
        extern __shared__ unsigned char smem_raw[];
        T* tw = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 6 * o;
        T* td = tw + 3 * o;
        int* tg = reinterpret_cast<int*>(reinterpret_cast<T*>(smem_raw)
                                         + (size_t)GATHER_WARPS * 6 * o)
                  + warp * 3 * o;
        for (int ax = 0; ax < 3; ++ax) {
            const int b = ax == 0 ? b0 : ax == 1 ? b1 : b2;
            for (int k = lane; k < o; k += 32) {
                int g = (b - k) % K;
                tg[ax * o + k] = g < 0 ? g + K : g;
                tw[ax * o + k] = wa[ax * o + k];
                td[ax * o + k] = da[ax * o + k];
            }
        }
        __syncwarp();
        const size_t KK = (size_t)K * K;
        for (int p = lane; p < o * o; p += 32) {
            const int j = p / o, k = p - j * o;     // once a pair
            const T* col = gq_grid + (size_t)tg[o + j] * K + tg[2 * o + k];
            T ca = 0, cb = 0;
            for (int i = 0; i < o; ++i) {
                const T c = __ldg(col + tg[i] * KK);
                ca = t_fma(c, tw[i], ca);
                cb = t_fma(c, td[i], cb);
            }
            const T w1 = tw[o + j], d1 = td[o + j], w2 = tw[2 * o + k],
                    d2 = td[2 * o + k];
            const T ww = w1 * w2;
            s_q = t_fma(ww, ca, s_q);
            s0 = t_fma(ww, cb, s0);
            s1 = t_fma(d1 * w2, ca, s1);
            s2 = t_fma(w1 * d2, ca, s2);
        }
    }
    s_q = warp_allsum(s_q);
    s0 = warp_allsum(s0);
    s1 = warp_allsum(s1);
    s2 = warp_allsum(s2);
    if (lane == 0) {
        gq[a] = s_q;
    } else if (lane < 4) {
        const int c = lane - 1;
        gx[(size_t)a * 3 + c] = (T)K * q[a]
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
    const int blocks = (n + GATHER_WARPS - 1) / GATHER_WARPS;
    if (blocks == 0) return (int)cudaGetLastError();
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 th(GATHER_WARPS * 32);
#define GATHER_ARGS (const T*)gq_grid, (const T*)w, (const T*)dw,         \
        (const long long*)nearpt, (const T*)q, (const T*)recip, (T*)gq,    \
        (T*)gx, n, K, order
    if (order == 6 && order <= K) {
        gather_kernel<T, 6><<<blocks, th, 0, s>>>(GATHER_ARGS);
    } else if (order == 4 && order <= K) {
        gather_kernel<T, 4><<<blocks, th, 0, s>>>(GATHER_ARGS);
    } else {
        const size_t shm = gather_smem_t<T>(order);
        const int err = allow_smem((const void*)gather_kernel<T, 0>, shm);
        if (err) return err;
        gather_kernel<T, 0><<<blocks, th, shm, s>>>(GATHER_ARGS);
    }
#undef GATHER_ARGS
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
