// Kernel D: slab-binned PME charge spread (D1) and its interpolation (D2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:_fwd ->
// _spread_slab_kernel (D1) and _bwd -> _interp_slab_kernel (D2).  Atoms
// are binned in torch by their x-corner c1 = (nearpt_x - (order-1)) mod K
// into K slabs of scap rows (rows[b*scap + r] = atom or -1; atoms past a
// slab's capacity are flagged, never spread silently).  The spline
// weights w, derivatives dw (N, 3, order) and nearpt (N, 3) come from
// ops/bspline.py; grid point of slot k along an axis is (nearpt - k) mod K.
//
// On the TPU the slab form turns a serial per-atom read-modify-write
// chain into matrix-unit contractions.  On Hopper kernel B1's atomics
// already avoid that chain; D1 buys determinism instead:
//
// D1: one block per (slab b, x-offset o) accumulates the K x K plane
// that slab b adds to grid row (b + o) mod K, in shared memory (32 KB at
// K = 64 in fp64), after staging the slab's atoms there (q wx wy and wz
// rows and the y/z corners: 27 KB at scap 280 in fp64).  Warp w owns the
// plane rows y with y % n_warps == w and walks the slab's atoms in row
// order, each lane adding distinct (y, z) brick elements, so every plane
// element is summed in one fixed order with no atomics.  Each plane is written once to a
// (K, order, K, K) scratch (12.6 MB at K = 64 in fp64) and a second pass
// folds the order planes of each grid row: a deterministic grid.
// Bound: bytes -- each atom's 36 (y, z) products per plane are a few
// flops; the scratch write + read (25 MB at K = 64, fp64) is most of the
// traffic, above the 2 MB grid itself.
//
// D2: one block per (slab b, x-offset o) stages the one cotangent plane
// (b + o) mod K that slab b reads for that offset in shared memory (all
// order planes of a slab at once would be 196 KB in fp64), and one
// thread per slab row contracts its atom's spline rows and derivative
// rows against it, in the working precision with FMAs (the derivative
// rows sum to zero, so the contraction cancels heavily: no
// reduced-precision shortcut).  The order partials of a row are summed
// in o order by a second pass: [dE/dq, dE/du1..3], deterministic.  The q
// and box factors and the row gather back to atoms are the wrapper's.
// Bound: bytes -- each block reads one K^2 plane from L2.
#include "common.cuh"

#define SLAB_WARPS 8                    // warps of a D1 block (power of 2)

template <typename T>
__global__ void __launch_bounds__(SLAB_WARPS * 32)
slab_plane_kernel(const T* __restrict__ w,
                  const long long* __restrict__ nearpt,
                  const T* __restrict__ q, const long long* __restrict__ rows,
                  T* __restrict__ planes, int K, int order, int scap) {
    extern __shared__ unsigned char smem_raw[];
    T* plane = reinterpret_cast<T*>(smem_raw);          // (K, K)
    T* wyz = plane + K * K;             // (scap, 2 order): q wx wy | wz
    int* nyz = reinterpret_cast<int*>(wyz + (size_t)scap * 2 * order);
    const int b = blockIdx.x / order, o = blockIdx.x % order;
    const int i = order - 1 - o;            // x slot landing on row b + o
    const int KK = K * K;
    for (int e = threadIdx.x; e < KK; e += blockDim.x) plane[e] = (T)0;
    // stage the slab's atoms: rows are filled from 0, -1 after the last
    for (int r = threadIdx.x; r < scap; r += blockDim.x) {
        const long long a = rows[(size_t)b * scap + r];
        nyz[2 * r] = -1;
        if (a < 0) continue;
        const T* wa = w + (size_t)a * 3 * order;
        const T qx = q[a] * wa[i];
        for (int j = 0; j < order; ++j) {
            wyz[(size_t)r * 2 * order + j] = qx * wa[order + j];
            wyz[(size_t)r * 2 * order + order + j] = wa[2 * order + j];
        }
        nyz[2 * r] = (int)nearpt[(size_t)a * 3 + 1];
        nyz[2 * r + 1] = (int)nearpt[(size_t)a * 3 + 2];
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int oo = order * order;
    for (int r = 0; r < scap; ++r) {
        const int ny = nyz[2 * r];
        if (ny < 0) break;                  // uniform across the block
        const int nz = nyz[2 * r + 1];
        const T* wr = wyz + (size_t)r * 2 * order;
        for (int e = lane; e < oo; e += 32) {
            const int j = e / order, k = e - j * order;
            int y = ny - j;
            if (y < 0) y += K;
            if ((y & (SLAB_WARPS - 1)) != warp) continue;
            int z = nz - k;
            if (z < 0) z += K;
            plane[y * K + z] += wr[j] * wr[order + k];
        }
        __syncwarp();
    }
    __syncthreads();
    T* out = planes + ((size_t)b * order + o) * KK;
    for (int e = threadIdx.x; e < KK; e += blockDim.x) out[e] = plane[e];
}

template <typename T>
__global__ void slab_fold_kernel(const T* __restrict__ planes,
                                 T* __restrict__ grid, int K, int order) {
    const long long KK = (long long)K * K;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= K * KK) return;
    const int X = (int)(t / KK);
    const long long e = t % KK;
    T s = 0;
    for (int o = 0; o < order; ++o) {
        const int b = (X - o + K) % K;
        s += planes[((size_t)b * order + o) * KK + e];
    }
    grid[t] = s;
}

template <typename T>
__global__ void slab_interp_kernel(const T* __restrict__ gQ,
                                   const T* __restrict__ w,
                                   const T* __restrict__ dw,
                                   const long long* __restrict__ nearpt,
                                   const long long* __restrict__ rows,
                                   T* __restrict__ part,
                                   int K, int order, int scap) {
    extern __shared__ unsigned char smem_raw[];
    T* plane = reinterpret_cast<T*>(smem_raw);
    const int b = blockIdx.x / order, o = blockIdx.x % order;
    const int X = (b + o) % K;
    const int KK = K * K;
    for (int e = threadIdx.x; e < KK; e += blockDim.x)
        plane[e] = gQ[(size_t)X * KK + e];
    __syncthreads();
    const int i = order - 1 - o;
    for (int r = threadIdx.x; r < scap; r += blockDim.x) {
        const long long a = rows[(size_t)b * scap + r];
        T* acc = part + (((size_t)b * scap + r) * order + o) * 4;
        if (a < 0) {
            for (int c = 0; c < 4; ++c) acc[c] = 0;
            continue;
        }
        const T* wa = w + (size_t)a * 3 * order;
        const T* da = dw + (size_t)a * 3 * order;
        const int ny = (int)nearpt[(size_t)a * 3 + 1];
        const int nz = (int)nearpt[(size_t)a * 3 + 2];
        T t = 0, t_dy = 0, t_dz = 0;
        for (int j = 0; j < order; ++j) {
            int y = ny - j;
            if (y < 0) y += K;
            const T* row = plane + y * K;
            T cz = 0, cdz = 0;
            for (int k = 0; k < order; ++k) {
                int z = nz - k;
                if (z < 0) z += K;
                const T c = row[z];
                cz = t_fma(c, wa[2 * order + k], cz);
                cdz = t_fma(c, da[2 * order + k], cdz);
            }
            t = t_fma(wa[order + j], cz, t);
            t_dy = t_fma(da[order + j], cz, t_dy);
            t_dz = t_fma(wa[order + j], cdz, t_dz);
        }
        acc[0] = wa[i] * t;
        acc[1] = da[i] * t;
        acc[2] = wa[i] * t_dy;
        acc[3] = wa[i] * t_dz;
    }
}

// out[row][c] = sum over x-offsets o of part[row][o][c], o ascending
template <typename T>
__global__ void slab_interp_fold_kernel(const T* __restrict__ part,
                                        T* __restrict__ out, int n_rows,
                                        int order) {
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)n_rows * 4) return;
    const long long r = t / 4;
    const int c = (int)(t % 4);
    T s = 0;
    for (int o = 0; o < order; ++o) s += part[(r * order + o) * 4 + c];
    out[t] = s;
}

template <typename T>
static int slab_spread_launch(const void* w, const void* nearpt,
                              const void* q, const void* rows, void* planes,
                              void* grid, void* stream, int K, int order,
                              int scap) {
    const size_t shm = (size_t)K * K * sizeof(T)
                       + (size_t)scap * (2 * order * sizeof(T) + 2 * sizeof(int));
    int err = allow_smem((const void*)slab_plane_kernel<T>, shm);
    if (err) return err;
    cudaStream_t s = (cudaStream_t)stream;
    slab_plane_kernel<T><<<K * order, SLAB_WARPS * 32, shm, s>>>(
        (const T*)w, (const long long*)nearpt, (const T*)q,
        (const long long*)rows, (T*)planes, K, order, scap);
    err = (int)cudaGetLastError();
    if (err) return err;
    const long long n = (long long)K * K * K;
    slab_fold_kernel<T><<<(int)((n + 255) / 256), 256, 0, s>>>(
        (const T*)planes, (T*)grid, K, order);
    return (int)cudaGetLastError();
}

template <typename T>
static int slab_interp_launch(const void* gQ, const void* w, const void* dw,
                              const void* nearpt, const void* rows,
                              void* part, void* out, void* stream, int K,
                              int order, int scap) {
    const size_t shm = (size_t)K * K * sizeof(T);
    int err = allow_smem((const void*)slab_interp_kernel<T>, shm);
    if (err) return err;
    int threads = ((scap + 31) / 32) * 32;
    if (threads > 512) threads = 512;
    if (threads < 64) threads = 64;
    cudaStream_t s = (cudaStream_t)stream;
    slab_interp_kernel<T><<<K * order, threads, shm, s>>>(
        (const T*)gQ, (const T*)w, (const T*)dw, (const long long*)nearpt,
        (const long long*)rows, (T*)part, K, order, scap);
    err = (int)cudaGetLastError();
    if (err) return err;
    const long long n = (long long)K * scap * 4;
    slab_interp_fold_kernel<T><<<(int)((n + 255) / 256), 256, 0, s>>>(
        (const T*)part, (T*)out, K * scap, order);
    return (int)cudaGetLastError();
}

KERNELS_API int pme_slab_spread_f32(const void* w, const void* nearpt,
                                    const void* q, const void* rows,
                                    void* planes, void* grid, void* stream,
                                    int K, int order, int scap) {
    return slab_spread_launch<float>(w, nearpt, q, rows, planes, grid,
                                     stream, K, order, scap);
}

KERNELS_API int pme_slab_spread_f64(const void* w, const void* nearpt,
                                    const void* q, const void* rows,
                                    void* planes, void* grid, void* stream,
                                    int K, int order, int scap) {
    return slab_spread_launch<double>(w, nearpt, q, rows, planes, grid,
                                      stream, K, order, scap);
}

KERNELS_API int pme_slab_interp_f32(const void* gQ, const void* w,
                                    const void* dw, const void* nearpt,
                                    const void* rows, void* part, void* out,
                                    void* stream, int K, int order,
                                    int scap) {
    return slab_interp_launch<float>(gQ, w, dw, nearpt, rows, part, out,
                                     stream, K, order, scap);
}

KERNELS_API int pme_slab_interp_f64(const void* gQ, const void* w,
                                    const void* dw, const void* nearpt,
                                    const void* rows, void* part, void* out,
                                    void* stream, int K, int order,
                                    int scap) {
    return slab_interp_launch<double>(gQ, w, dw, nearpt, rows, part, out,
                                      stream, K, order, scap);
}
