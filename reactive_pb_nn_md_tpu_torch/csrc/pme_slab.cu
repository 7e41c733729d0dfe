// Kernel D: slab-binned PME charge spread (D1) and its interpolation (D2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_slab.py:_fwd ->
// _spread_slab_kernel (D1) and _bwd -> _interp_slab_kernel (D2).  Atoms
// are binned in torch by their x corner c1 = (nearpt_x - (order-1)) mod K
// into K slabs of scap rows, and within a slab by their y corner c2 =
// (nearpt_y - (order-1)) mod K, ascending (ops/kernels/pme_slab.py
// slab_bins: rows[b*scap + r] = atom, -1 past the slab's last atom).  The
// spline weights w, derivatives dw (N, 3, order) and nearpt (N, 3) come
// from ops/bspline.py; the grid point of slot k along an axis is
// (nearpt - k) mod K, so an atom of slab b reaches grid rows b .. b +
// order - 1 in x, with x slot order - 1 - o on row b + o.
//
// On the TPU the slab form turns a serial per-atom read-modify-write chain
// into matrix-unit contractions.  On Hopper it buys a reproducible grid
// (kernel B1 uses atomics).  The work is a few flops per byte of a 2 MB
// grid, spread over ~10^4 short, data-dependent atom lists, so both
// kernels are bounded by latency.  Each is one launch with no scratch
// array and no atomics.
//
// D1 (output-stationary): one block per (grid row X, band of SLAB_BAND y
// rows).  The atoms that reach the tile are those of the `order` slabs b
// = X - o whose y corner lies in the band's cyclic window [y0 - order + 1,
// y0 + band): since a slab's rows are in y-corner order, that is one or
// two contiguous row ranges of each slab, found by a warp-wide
// lower-bound search (2 rounds of dependent loads at scap <= 544).  The
// block stages those atoms in chunks of SLAB_STAGE -- each atom's weight
// q wx wy on every band row, its z spline row and z point -- and each
// warp adds every 8th staged atom to a tile of its own in shared memory,
// one lane a (band row, z slot) product, so no two lanes of an
// instruction meet and a warp's atoms come in order.  The 8 tiles are
// folded in warp order and each grid element written once: every element
// is summed in one fixed order, and two calls agree bit for bit.  Shared
// memory: 8 tiles of SLAB_BAND x (K + TILE_PAD) and the staging buffer
// (50.7 KB in fp64 at K = 64, four blocks an SM), whatever scap.
// Bound: bytes (w, nearpt, q, rows read once, the K^3 grid written once,
// ~1 us); the kernel is latency-bound -- staging and adds take ~40% of a
// block's cycles each, the search ~16% (tools/slab_phases.py), and each
// atom is staged by ~10 blocks (six x rows, 1.6 bands).
//
// D2: one block per (slab b, band of INTERP_BAND y corners) stages the
// cotangent window its rows read -- order x-planes b .. b + order - 1 by
// band + order - 1 y rows by K z (40 KB in fp64 at K = 64), rows padded
// to K + 1 against bank conflicts -- and takes the slab rows whose y
// corner lies in the band (one contiguous range, found as in D1).  It
// stages those rows in chunks of INTERP_STAGE (spline and derivative
// rows, z point, window row) and a warp per row contracts its order^3
// terms: lane p < order^2 (and p + 32) takes the (x slot, y slot) pair
// (p / order, p % order) and runs the z slots from shared memory with
// FMAs in the working precision (the derivative rows sum to zero, so the
// contraction cancels heavily: no reduced-precision shortcut); a fixed
// shuffle tree sums the lanes' [dE/dq, dE/du1..3] and lane 0 writes them.
// The block of the last band also zeroes the slab's empty rows.  Shared
// memory: the window and the staged rows (50.3 KB in fp64 at K = 64),
// whatever scap.  The q and box factors and the row gather back to atoms
// are the wrapper's.
// Bound: bytes (the 2 MB cotangent grid and the per-atom inputs read once,
// ~2 us); the window, read once per slab block, is 6 x 13/8 of the grid
// from L2, and its loads are batched four rows a warp.
#include "common.cuh"

#define SLAB_BAND 8        // y rows of a D1 tile
#define SLAB_WARPS 8       // warps of a D1 block
#define SLAB_STAGE 128     // atoms a D1 block stages at a time
#define TILE_PAD 6         // a D1 tile row is K + TILE_PAD long (banks)
#define INTERP_BAND 8      // y corners of a D2 block
#define INTERP_WARPS 8     // warps of a D2 block
#define INTERP_STAGE 32    // slab rows a D2 block stages at a time

__device__ __forceinline__ int mod_k(long long v, int K) {
    int r = (int)(v % K);
    return r < 0 ? r + K : r;
}

// y corner of row r of a slab (rows_b = the slab's first row), K for an
// empty row: the keys of a slab's rows ascend.
__device__ __forceinline__ int row_key(const long long* __restrict__ rows_b,
                                       const long long* __restrict__ nearpt,
                                       int r, int K, int order) {
    const long long a = rows_b[r];
    return a < 0 ? K : mod_k(nearpt[a * 3 + 1] - (order - 1), K);
}

// Called by a whole warp: the first row r in [0, scap) of the slab whose
// key is >= v0 (then v1, v2), scap if none, for nv <= 3 values at once.
// A first round probes the slab at 32 even strides for every value; then
// the lanes split into nv groups of 32 / nv, and each round a group
// probes its value's interval at even strides and keeps the part that
// holds the bound (2 rounds in all for nv = 2 at scap <= 544).  Every
// lane returns every bound.
__device__ void lower_bounds(const long long* __restrict__ rows_b,
                             const long long* __restrict__ nearpt, int scap,
                             int K, int order, int nv, int v0, int v1, int v2,
                             int& lb0, int& lb1, int& lb2) {
    const int lane = threadIdx.x & 31;
    const int G = 32 / nv;
    const int g = lane / G, gl = lane - g * G;
    const bool active = g < nv;
    const int v = g == 0 ? v0 : (g == 1 ? v1 : v2);
    const unsigned gmask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                           << (active ? g * G : 0);
    // round 1, shared: probes 0, s1, 2 s1, ... below scap
    const int s1 = (scap + 31) / 32;
    const bool probe1 = lane * s1 < scap;
    const int key1 = probe1 ? row_key(rows_b, nearpt, lane * s1, K, order)
                            : K;
    const unsigned b0 = __ballot_sync(0xffffffffu, probe1 && key1 < v0);
    const unsigned b1 = __ballot_sync(0xffffffffu, probe1 && key1 < v1);
    const unsigned b2 = __ballot_sync(0xffffffffu, probe1 && key1 < v2);
    const int c1 = __popc(g == 0 ? b0 : (g == 1 ? b1 : b2));
    int lo = 0, hi = 0;                     // the bound lies in [lo, hi]
    if (c1 > 0) {
        lo = (c1 - 1) * s1 + 1;
        hi = min(c1 * s1, scap);
    }
    while (__any_sync(0xffffffffu, active && lo < hi)) {
        const int len = hi - lo;
        const int stride = (len + G - 1) / G;
        const bool probe = active && lo < hi && gl * stride < len;
        const bool below = probe && row_key(rows_b, nearpt, lo + gl * stride,
                                            K, order) < v;
        const unsigned bal = __ballot_sync(0xffffffffu, below);
        if (active && lo < hi) {
            const int cg = __popc(bal & gmask);
            if (cg == 0) {
                hi = lo;
            } else {
                const int nlo = lo + (cg - 1) * stride + 1;
                hi = min(lo + cg * stride, hi);
                lo = nlo;
            }
        }
    }
    lb0 = __shfl_sync(0xffffffffu, lo, 0);
    lb1 = __shfl_sync(0xffffffffu, lo, min(G, 31));
    lb2 = __shfl_sync(0xffffffffu, lo, min(2 * G, 31));
}

// D1's shared memory: each warp's own (SLAB_BAND, K + TILE_PAD) tile, then
// the staged atoms (spread_smem).
template <typename T, int ORDER>
struct SpreadStage {
    T a[SLAB_STAGE][SLAB_BAND];     // q wx wy: the atom's weight on each band row
    T wz[SLAB_STAGE][ORDER];
    int nz[SLAB_STAGE];             // nearpt z, mod K
};

template <typename T, int ORDER>
static size_t spread_smem(int K) {
    return (size_t)SLAB_WARPS * SLAB_BAND * (K + TILE_PAD) * sizeof(T)
           + sizeof(SpreadStage<T, ORDER>);
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(SLAB_WARPS * 32)
slab_spread_kernel(const T* __restrict__ w, const long long* __restrict__ nearpt,
                   const T* __restrict__ q, const long long* __restrict__ rows,
                   T* __restrict__ grid, int K, int scap, int w_bs, int np_bs,
                   int q_bs, int rows_bs) {
    const size_t rep = blockIdx.z;
    w += rep * w_bs;
    nearpt += rep * np_bs;
    q += rep * q_bs;
    rows += rep * rows_bs;
    grid += rep * K * K * K;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int RS = K + TILE_PAD;
    T* tile = reinterpret_cast<T*>(smem_raw);   // (SLAB_WARPS, SLAB_BAND, RS)
    auto& st = *reinterpret_cast<SpreadStage<T, ORDER>*>(
        tile + SLAB_WARPS * SLAB_BAND * RS);
    __shared__ int rng[ORDER][2][2];            // per slab offset: 2 ranges
    const int X = blockIdx.y;
    const int y0 = blockIdx.x * SLAB_BAND;
    const int yb = min(SLAB_BAND, K - y0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int e = threadIdx.x; e < SLAB_WARPS * SLAB_BAND * RS;
         e += SLAB_WARPS * 32)
        tile[e] = (T)0;

    // the row ranges of slab X - o whose y corner is in the band's window
    for (int o = warp; o < ORDER; o += SLAB_WARPS) {
        int b = X - o;
        if (b < 0) b += K;
        const long long* rows_b = rows + (size_t)b * scap;
        const int lo_v = y0 - (ORDER - 1), hi_v = y0 + yb;
        int lb0, lb1, lb2, r0, r1, r2 = 0, r3 = 0;
        if (yb + ORDER - 1 >= K) {                  // the window is all of y
            lower_bounds(rows_b, nearpt, scap, K, ORDER, 1, K, 0, 0, lb0, lb1,
                         lb2);
            r0 = 0; r1 = lb0;
        } else if (lo_v >= 0) {
            lower_bounds(rows_b, nearpt, scap, K, ORDER, 2, lo_v, hi_v, 0, lb0,
                         lb1, lb2);
            r0 = lb0; r1 = lb1;
        } else {                                    // it wraps below y = 0
            lower_bounds(rows_b, nearpt, scap, K, ORDER, 3, hi_v, lo_v + K, K,
                         lb0, lb1, lb2);
            r0 = 0; r1 = lb0; r2 = lb1; r3 = lb2;
        }
        if (lane == 0) {
            rng[o][0][0] = r0; rng[o][0][1] = r1;
            rng[o][1][0] = r2; rng[o][1][1] = r3;
        }
    }
    __syncthreads();
    int total = 0;
    for (int o = 0; o < ORDER; ++o)
        total += (rng[o][0][1] - rng[o][0][0]) + (rng[o][1][1] - rng[o][1][0]);

    T* my = tile + warp * SLAB_BAND * RS;
    for (int base = 0; base < total; base += SLAB_STAGE) {
        const int n = min(SLAB_STAGE, total - base);
        // stage atoms base .. base + n - 1 of the (slab, range, row) order
        if (threadIdx.x < n) {
            int t = base + threadIdx.x, o = 0, k = 0;
            for (;;) {
                const int len = rng[o][k][1] - rng[o][k][0];
                if (t < len) break;
                t -= len;
                if (++k == 2) { k = 0; ++o; }
            }
            int b = X - o;
            if (b < 0) b += K;
            const long long a = rows[(size_t)b * scap + rng[o][k][0] + t];
            const T* wa = w + a * 3 * ORDER;
            const int s = threadIdx.x;
            const T qwx = q[a] * wa[ORDER - 1 - o];
            const int ny = mod_k(nearpt[a * 3 + 1], K);
            T wy[ORDER];
#pragma unroll
            for (int j = 0; j < ORDER; ++j) {
                wy[j] = wa[ORDER + j];
                st.wz[s][j] = wa[2 * ORDER + j];
            }
            st.nz[s] = mod_k(nearpt[a * 3 + 2], K);
#pragma unroll
            for (int r = 0; r < SLAB_BAND; ++r) {
                int j = ny - (y0 + r);              // y slot of band row r
                if (j < 0) j += K;
                T wj = (T)0;
#pragma unroll
                for (int jj = 0; jj < ORDER; ++jj)
                    if (jj == j) wj = wy[jj];
                st.a[s][r] = r < yb ? qwx * wj : (T)0;
            }
        }
        __syncthreads();
        // each warp adds every SLAB_WARPS-th staged atom to its own tile,
        // one lane a (band row, z slot) product: no two lanes of a pass
        // meet, and the warp's atoms come in order
        for (int s = warp; s < n; s += SLAB_WARPS) {
            const int nz = st.nz[s];
#pragma unroll
            for (int h = 0; h < (SLAB_BAND * ORDER + 31) / 32; ++h) {
                const int p = lane + 32 * h;
                if (p < SLAB_BAND * ORDER) {
                    const int r = p / ORDER, k = p - r * ORDER;
                    const T av = st.a[s][r];
                    if (av != (T)0) {
                        int z = nz - k;
                        if (z < 0) z += K;
                        T* e = my + r * RS + z;
                        *e = t_fma(av, st.wz[s][k], *e);
                    }
                }
            }
            __syncwarp();
        }
        __syncthreads();
    }
    // fold the warps' tiles in warp order; write each element once
    for (int e = threadIdx.x; e < yb * K; e += SLAB_WARPS * 32) {
        const int r = e / K, z = e - r * K;
        T sum = tile[r * RS + z];
        for (int v = 1; v < SLAB_WARPS; ++v)
            sum += tile[(v * SLAB_BAND + r) * RS + z];
        grid[((size_t)X * K + y0 + r) * K + z] = sum;
    }
}

// D2's staged rows: spline rows and derivative rows (x, y, z), z point
// and window row of the y corner
template <typename T, int ORDER>
struct InterpStage {
    T wd[INTERP_STAGE][6 * ORDER];  // w (3 ORDER), then dw (3 ORDER)
    long long a[INTERP_STAGE];
    int nz[INTERP_STAGE];
    int jj[INTERP_STAGE];
};

template <typename T, int ORDER>
static size_t interp_smem(int K) {
    return (size_t)ORDER * (INTERP_BAND + ORDER - 1) * (K + 1) * sizeof(T)
           + sizeof(InterpStage<T, ORDER>);
}

template <typename T, int ORDER>
__global__ void __launch_bounds__(INTERP_WARPS * 32, 4)
slab_interp_kernel(const T* __restrict__ gQ, const T* __restrict__ w,
                   const T* __restrict__ dw,
                   const long long* __restrict__ nearpt,
                   const long long* __restrict__ rows, T* __restrict__ out,
                   int K, int scap, int gq_bs, int w_bs, int np_bs,
                   int rows_bs) {
    const size_t rep = blockIdx.z;
    gQ += rep * gq_bs;
    w += rep * w_bs;
    dw += rep * w_bs;
    nearpt += rep * np_bs;
    rows += rep * rows_bs;
    out += rep * K * scap * 4;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    auto& st = *reinterpret_cast<InterpStage<T, ORDER>*>(smem_raw);
    T* win = reinterpret_cast<T*>(smem_raw + sizeof(InterpStage<T, ORDER>));
    __shared__ int range[2];                   // win: (ORDER, WY, K + 1)
    const int b = blockIdx.y;
    const int y0 = blockIdx.x * INTERP_BAND;
    const int yb = min(INTERP_BAND, K - y0);
    const bool last = blockIdx.x == gridDim.x - 1;
    const int WY = yb + ORDER - 1, RS = K + 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long* rows_b = rows + (size_t)b * scap;

    if (warp == 0) {                      // rows with y corner in the band
        int lb0, lb1, lb2;
        lower_bounds(rows_b, nearpt, scap, K, ORDER, 2, y0, y0 + yb, 0, lb0,
                     lb1, lb2);
        if (lane == 0) { range[0] = lb0; range[1] = lb1; }
    }
    // the cotangent window: x rows b + o, y rows y0 + jj, all z; a warp
    // loads WIN_ROWS rows before it stores them
    constexpr int WIN_ROWS = 4, ZMAX = 4;
    for (int oj0 = warp * WIN_ROWS; oj0 < ORDER * WY;
         oj0 += INTERP_WARPS * WIN_ROWS) {
        T buf[WIN_ROWS][ZMAX];
#pragma unroll
        for (int u = 0; u < WIN_ROWS; ++u) {
            const int oj = oj0 + u;
            if (oj >= ORDER * WY) break;
            const int o = oj / WY, jj = oj - o * WY;
            int X = b + o, Y = y0 + jj;
            if (X >= K) X -= K;
            if (Y >= K) Y -= K;
            const T* src = gQ + ((size_t)X * K + Y) * K;
#pragma unroll
            for (int m = 0; m < ZMAX; ++m)
                if (lane + 32 * m < K) buf[u][m] = src[lane + 32 * m];
        }
#pragma unroll
        for (int u = 0; u < WIN_ROWS; ++u) {
            const int oj = oj0 + u;
            if (oj >= ORDER * WY) break;
#pragma unroll
            for (int m = 0; m < ZMAX; ++m)
                if (lane + 32 * m < K) win[oj * RS + lane + 32 * m] = buf[u][m];
        }
    }
    __syncthreads();
    const int lo = range[0], hi = range[1];
    for (int base = lo; base < hi; base += INTERP_STAGE) {
        const int n = min(INTERP_STAGE, hi - base);
        if (threadIdx.x < n) {
            const long long a = rows_b[base + threadIdx.x];
            const int c2 = mod_k(nearpt[a * 3 + 1] - (ORDER - 1), K);
            st.a[threadIdx.x] = a;
            st.nz[threadIdx.x] = mod_k(nearpt[a * 3 + 2], K);
            st.jj[threadIdx.x] = c2 - y0;
        }
        __syncthreads();
        for (int e = threadIdx.x; e < n * 6 * ORDER; e += INTERP_WARPS * 32) {
            const int t = e / (6 * ORDER), c = e - t * (6 * ORDER);
            const long long a = st.a[t];
            st.wd[t][c] = c < 3 * ORDER ? w[a * 3 * ORDER + c]
                                        : dw[a * 3 * ORDER + c - 3 * ORDER];
        }
        __syncthreads();
        for (int t = warp; t < n; t += INTERP_WARPS) {
            const T* wa = st.wd[t];
            const T* da = wa + 3 * ORDER;
            const int nz = st.nz[t], jj0 = st.jj[t];
            T s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
            for (int h = 0; h < (ORDER * ORDER + 31) / 32; ++h) {
                const int p = lane + 32 * h;
                if (p < ORDER * ORDER) {
                    const int o = p / ORDER, j = p - o * ORDER;
                    const int i = ORDER - 1 - o;
                    const T* row = win + (o * WY + jj0 + (ORDER - 1 - j)) * RS;
                    T cz = 0, cdz = 0;
#pragma unroll
                    for (int k = 0; k < ORDER; ++k) {
                        int z = nz - k;
                        if (z < 0) z += K;
                        const T g = row[z];
                        cz = t_fma(wa[2 * ORDER + k], g, cz);
                        cdz = t_fma(da[2 * ORDER + k], g, cdz);
                    }
                    const T wx = wa[i], dx = da[i];
                    const T wy = wa[ORDER + j], dy = da[ORDER + j];
                    const T wxy = wx * wy;
                    s0 = t_fma(wxy, cz, s0);
                    s1 = t_fma(dx * wy, cz, s1);
                    s2 = t_fma(wx * dy, cz, s2);
                    s3 = t_fma(wxy, cdz, s3);
                }
            }
            s0 = warp_sum(s0);
            s1 = warp_sum(s1);
            s2 = warp_sum(s2);
            s3 = warp_sum(s3);
            if (lane == 0) {
                T* dst = out + ((size_t)b * scap + base + t) * 4;
                dst[0] = s0; dst[1] = s1; dst[2] = s2; dst[3] = s3;
            }
        }
        __syncthreads();
    }
    if (last)                                 // the slab's empty rows
        for (int e = hi * 4 + threadIdx.x; e < scap * 4; e += blockDim.x)
            out[(size_t)b * scap * 4 + e] = (T)0;
}

template <typename T, int ORDER>
static int spread_launch(const void* w, const void* nearpt, const void* q,
                         const void* rows, void* grid, cudaStream_t s, int K,
                         int scap, const int* bs) {
    const size_t shm = spread_smem<T, ORDER>(K);
    int err = allow_smem((const void*)slab_spread_kernel<T, ORDER>, shm);
    if (err) return err;
    const dim3 blocks((K + SLAB_BAND - 1) / SLAB_BAND, K, bs[0]);
    slab_spread_kernel<T, ORDER><<<blocks, SLAB_WARPS * 32, shm, s>>>(
        (const T*)w, (const long long*)nearpt, (const T*)q,
        (const long long*)rows, (T*)grid, K, scap, bs[1], bs[2], bs[3],
        bs[4]);
    return (int)cudaGetLastError();
}

template <typename T>
static int slab_spread_launch(const void* w, const void* nearpt,
                              const void* q, const void* rows, void* grid,
                              void* stream, int K, int order, int scap,
                              const int* bs) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bs[0] < 1 || bs[0] > 65535) return (int)cudaErrorInvalidValue;
    if (order == 4)
        return spread_launch<T, 4>(w, nearpt, q, rows, grid, s, K, scap, bs);
    if (order == 6)
        return spread_launch<T, 6>(w, nearpt, q, rows, grid, s, K, scap, bs);
    return (int)cudaErrorInvalidValue;
}

template <typename T, int ORDER>
static int interp_launch(const void* gQ, const void* w, const void* dw,
                         const void* nearpt, const void* rows, void* out,
                         cudaStream_t s, int K, int scap, const int* bs) {
    const size_t shm = interp_smem<T, ORDER>(K);
    int err = allow_smem((const void*)slab_interp_kernel<T, ORDER>, shm);
    if (err) return err;
    const dim3 blocks((K + INTERP_BAND - 1) / INTERP_BAND, K, bs[0]);
    slab_interp_kernel<T, ORDER><<<blocks, INTERP_WARPS * 32, shm, s>>>(
        (const T*)gQ, (const T*)w, (const T*)dw, (const long long*)nearpt,
        (const long long*)rows, (T*)out, K, scap, bs[1], bs[2], bs[3],
        bs[4]);
    return (int)cudaGetLastError();
}

template <typename T>
static int slab_interp_launch(const void* gQ, const void* w, const void* dw,
                              const void* nearpt, const void* rows, void* out,
                              void* stream, int K, int order, int scap,
                              const int* bs) {
    cudaStream_t s = (cudaStream_t)stream;
    if (bs[0] < 1 || bs[0] > 65535) return (int)cudaErrorInvalidValue;
    if (order == 4)
        return interp_launch<T, 4>(gQ, w, dw, nearpt, rows, out, s, K, scap,
                                   bs);
    if (order == 6)
        return interp_launch<T, 6>(gQ, w, dw, nearpt, rows, out, s, K, scap,
                                   bs);
    return (int)cudaErrorInvalidValue;
}

// A batched launch (a replica batch of the vmapped step) runs replica
// blockIdx.z on its own inputs and output, each input `*_bs` elements past
// the previous replica's (0: one array shared by the batch), the grid K^3
// and the rows K scap 4 apart: the same arithmetic in the same order as
// its own launch.
#define SLAB_SPREAD_ENTRY(NAME, T)                                           \
    KERNELS_API int NAME(const void* w, const void* nearpt, const void* q,   \
                         const void* rows, void* grid, void* stream, int K,  \
                         int order, int scap, int nb, int w_bs, int np_bs,   \
                         int q_bs, int rows_bs) {                            \
        const int bs[5] = {nb, w_bs, np_bs, q_bs, rows_bs};                  \
        return slab_spread_launch<T>(w, nearpt, q, rows, grid, stream, K,    \
                                     order, scap, bs);                       \
    }
SLAB_SPREAD_ENTRY(pme_slab_spread_f32, float)
SLAB_SPREAD_ENTRY(pme_slab_spread_f64, double)

#define SLAB_INTERP_ENTRY(NAME, T)                                           \
    KERNELS_API int NAME(const void* gQ, const void* w, const void* dw,      \
                         const void* nearpt, const void* rows, void* out,    \
                         void* stream, int K, int order, int scap, int nb,   \
                         int gq_bs, int w_bs, int np_bs, int rows_bs) {      \
        const int bs[5] = {nb, gq_bs, w_bs, np_bs, rows_bs};                 \
        return slab_interp_launch<T>(gQ, w, dw, nearpt, rows, out, stream,   \
                                     K, order, scap, bs);                    \
    }
SLAB_INTERP_ENTRY(pme_slab_interp_f32, float)
SLAB_INTERP_ENTRY(pme_slab_interp_f64, double)
