// Kernel B: PME charge spreading (B1) and its backward gather (B2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/pme_spread.py:_spread_kernel
// (forward) and _gather_kernel + _charge_grid_bwd (backward).  The spline
// weights w and derivatives dw (N, 3, order) and the base grid points
// nearpt (N, 3) are computed in torch (ops/bspline.py); grid point of
// slot k along an axis is (nearpt - k) mod K.
//
// B1 (spread_kernel, output-stationary): grid element (X, Y, Z) is the
// sum of q w0[i] w1[j] w2[k] over the atoms with i = (b0 - X) mod K, j =
// (b1 - Y) mod K and k = (b2 - Z) mod K all below the order (b: the base
// points, wrapped once, in int32).  A block of 16 warps owns a tile of P
// x planes by 8 y rows by BZ z values: P = 1, BZ = 32 for K <= 32 (128
// blocks at the flagship's K = 32); P = 4, BZ = 64 above (128 at K = 64).
//  1. Scan and stage: the block tests the atoms, R a thread a step (2 for
//     P = 1, 4 for P = 4; the next step's base points in flight), with
//     cyclic window tests ((b - start) mod K < width + order - 1).  A
//     thread whose atom reaches the tile loads the atom's row at once,
//     before the counts are known: for P = 1, t = q w0[i] for the plane
//     and the y and z spline rows; for P = 4, q and all three rows.
//     Ballots and a scan of the warps' counts rank those atoms in
//     ascending atom order, and each thread stores its rows at their
//     ranks: the rows' loads overlap the ranking, and no list is read
//     back.  The stage holds 256 (P = 1) or 128 (P = 4) atoms; when it
//     fills, and at the end, its atoms are added.
//  2. Add: a warp owns a column of 4 y rows by CZ z values (CZ = 4 for
//     P = 1, where lanes 16-31 take every other atom and hand their
//     product down by a shuffle; CZ = 8 for P = 4, a sum a plane a lane).
//     Lanes test 32 staged atoms a step against the column; the hits go
//     to the warp's list in order (for P = 4 with t = q w0[i] for each
//     plane); every lane then adds (t w1[j]) w2[k] for its element, eight
//     atoms at a time, with no branch: a slot past the order or a padded
//     hit adds a zero, which leaves the sum's bits as they are.
// So each element is summed by one lane over its atoms in ascending index
// and written once: one writer an element, no zero fill (n = 0 writes
// zeros), two calls give the same bits, and the products and sums round
// as the plain version's do on the CPU (q w0 w1 w2, no fused multiply-
// add).  Shared memory is fixed by the order, the type and the tile,
// whatever n.  Bound: bytes (w, nearpt, q read once, the grid written
// once: 0.1 us at the flagship).  The kernel is bound by latency and
// issue: a block waits on two dependent rounds of L2 loads (the base
// points, then the rows of the atoms that reach it) and issues the tests
// and adds of 16 warps; at 10^4 atoms every block also reads all the
// base points (128 blocks x 240 KB from L2).  tools/spread_phases.py
// measures the phases; PERF.md has the times.
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

// v mod K in [0, K): the 64-bit modulo only off the usual range
__device__ __forceinline__ int wrap_index(long long v, int K) {
    if (v >= 0 && v < K) return (int)v;
    const long long r = v % K;
    return (int)(r < 0 ? r + K : r);
}

// (b - base) mod K for b and base in [0, K): a cyclic window offset
__device__ __forceinline__ int cyc(int b, int base, int K) {
    const int d = b - base;
    return d < 0 ? d + K : d;
}

// v mod K for v in [-K, 2K): one add or subtract, no branch
__device__ __forceinline__ int wrap_near(long long v, int K) {
    int r = (int)v;
    r += r < 0 ? K : 0;
    return r >= K ? r - K : r;
}

// a value of global memory to shared memory, asynchronously (cp.async):
// the thread waits for its copies with copy_async_wait
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(d), "l"(src), "n"((int)sizeof(T)));
}

__device__ __forceinline__ void copy_async_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

#define SPREAD_COUNTS 64    // (scan slot, warp) counts of one scan step

// B1's tile: a block of 16 warps owns P x planes by 8 y rows by BZ z
// values; each warp owns a column of 4 y rows by CZ z values through the
// P planes, one sum a plane for each lane of it.  P = 1 for K <= 32
// (BZ = 32, CZ = 4: lane l < 16 owns y row l / 4 and z value l % 4, and
// lane l + 16 takes every other atom of the column for it); P = 4 above
// (z tiles of 64, CZ = 8: lane l owns y row l / 8 and z value l % 8).
// A scan step tests R atoms a thread (2 for P = 1, 4 above); the block
// stages up to ST atoms.
// A staged atom's row holds t = q w0[i] and its y and z spline rows for
// one plane (P = 1), else q and its three spline rows.
template <int P>
struct SpreadTile {
    static constexpr int WARPS = 16, R = P == 1 ? 2 : 4;
    static constexpr int BY = 8, BZ = P == 1 ? 32 : 64, CZ = P == 1 ? 4 : 8;
    static constexpr int ST = P == 1 ? 256 : 128;
    static_assert(WARPS == BY / 4 * (BZ / CZ), "B1 tile");
    static constexpr int width(int o) { return (P == 1 ? 2 : 3) * o + 1; }
};

// an atom that reaches a warp's column, as the warp's test leaves it for
// the adds: for P = 4, t[p] = q w0[i] for plane p (0 where i is not below
// the order); its staged index; its y and z window offsets from the
// column's corner
template <typename T, int P>
struct SpreadHit {
    T t[P == 1 ? 1 : P];
    int s;
    int dyz;                // dy | dz << 16
};

// B1's shared memory in bytes at spline order `order` for the tile of P
// planes: the staged atoms' rows and wrapped base points (y, z; x too for
// P = 4); one scan step's counts; 32 hits a warp.  The compiled orders
// hold it as static shared memory, the generic path (O = 0) as dynamic;
// the wrapper's spread_smem mirrors it.
template <typename T, int P>
__host__ __device__ constexpr size_t spread_smem_t(int order) {
    return (size_t)SpreadTile<P>::ST
               * (SpreadTile<P>::width(order) * sizeof(T) + 3 * sizeof(int))
           + (size_t)SPREAD_COUNTS * sizeof(int)
           + (size_t)SpreadTile<P>::WARPS * 32 * sizeof(SpreadHit<T, P>);
}

// Kernel B1: block (bx, by, bz) owns x planes bx P .., y rows by 8 .. and
// z values bz BZ .. of the grid.  O > 0: the order, known at compile time
// (O <= K); O = 0: any order.  A batched launch (a replica batch of the
// vmapped step) stacks the replicas on z: blockIdx.z = replica nbz + bz,
// replica r reading its w, nearpt and q `*_bs` elements past r - 1's (0:
// shared) and writing grid r; the same arithmetic as its own launch.
template <typename T, int O, int P>
__global__ void __launch_bounds__(SpreadTile<P>::WARPS * 32, 1)
spread_kernel(const T* __restrict__ w, const long long* __restrict__ nearpt,
              const T* __restrict__ q, T* __restrict__ grid, int n, int K,
              int order, int nbz, int w_bs, int np_bs, int q_bs) {
    using Tile = SpreadTile<P>;
    using Hit = SpreadHit<T, P>;
    constexpr int WARPS = Tile::WARPS, BY = Tile::BY, BZ = Tile::BZ,
                  CZ = Tile::CZ, R = Tile::R, ST = Tile::ST;
    constexpr int NT = WARPS * 32, CH = NT * R, NC = R * WARPS;
    // P = 1, compiled order: a row held in registers from the test to its
    // store; P = 4: rows copied to shared memory asynchronously
    constexpr bool REG = P == 1 && O > 0;
    constexpr int OW = REG ? Tile::width(O) : 1;
    constexpr bool PAIR = CZ == 4;          // two atoms a step, one a half
    constexpr unsigned FULL = 0xffffffffu;
    static_assert(NC <= SPREAD_COUNTS, "B1 tile constants");
    const int o = O > 0 ? O : order;
    const int SW = Tile::width(o);          // a staged row
    const int OY = SW - 2 * o, OZ = SW - o; // its y and z spline rows
    unsigned char* sm;
    if constexpr (O > 0) {
        static_assert(spread_smem_t<T, P>(O > 0 ? O : 1) <= 48 * 1024,
                      "static shared memory");
        __shared__ __align__(16)
            unsigned char sm_static[spread_smem_t<T, P>(O > 0 ? O : 1)];
        sm = sm_static;
    } else {
        extern __shared__ __align__(16) unsigned char spread_dyn[];
        sm = spread_dyn;
    }
    T* sw = reinterpret_cast<T*>(sm);       // [ST][SW] staged rows
    Hit* shit = reinterpret_cast<Hit*>(sw + ST * SW);           // [WARPS][32]
    int* sb0 = reinterpret_cast<int*>(shit + WARPS * 32);
    int* sb1 = sb0 + ST;
    int* sb2 = sb1 + ST;
    int* scnt = sb2 + ST;                   // [R][WARPS]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int rep = blockIdx.z / nbz;
    w += (size_t)rep * w_bs;
    nearpt += (size_t)rep * np_bs;
    q += (size_t)rep * q_bs;
    grid += (size_t)rep * K * K * K;
    const int X0 = blockIdx.x * P, y0 = blockIdx.y * BY,
              z0 = (blockIdx.z - rep * nbz) * BZ;
    const int xp = min(P, K - X0), yb = min(BY, K - y0), zt = min(BZ, K - z0);
    // an atom reaches a range of grid points along an axis when its window
    // (base point - slot, slot < o) meets it: (b - start) mod K < width +
    // o - 1, always true once that is K or more
    const int xw = xp + o - 1, yw = yb + o - 1, zw = zt + o - 1;
    const bool ztest = zw < K;

    // this warp's column: corner (Yp, Zp); this lane's element (yy, zz)
    const int yy = (lane % (4 * CZ)) / CZ, zz = lane % CZ;
    const int half = PAIR ? lane >> 4 : 0;
    const int Yp = y0 + 4 * (warp / (BZ / CZ)), Zp = z0 + CZ * (warp % (BZ / CZ));
    const bool cv = Yp - y0 < yb && Zp - z0 < zt;   // warp-uniform
    const int hy = 4 + o - 1, hz = CZ + o - 1;      // the column's windows
    T acc[P];
#pragma unroll
    for (int p = 0; p < P; ++p) acc[p] = (T)0;
    Hit* hl = shit + warp * 32;

    // 2. add the ns staged atoms, in order, to the column this warp owns
    auto add_staged = [&](int ns) {
        for (int c0 = 0; cv && c0 < ns; c0 += 32) {
            // lane l tests staged atom c0 + l against the column and, if
            // it reaches it, leaves it in the warp's list in order
            const int s = min(c0 + lane, ns - 1);
            const int dy = cyc(sb1[s], Yp, K), dz = cyc(sb2[s], Zp, K);
            const bool h = (c0 + lane < ns) & (dy < hy) & (dz < hz);
            Hit e;
            e.s = s;
            e.dyz = dy | dz << 16;
            if constexpr (P > 1) {
                const int dx = cyc(sb0[s], X0, K);
                const T qs = sw[s * SW];
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    int i = dx - p;
                    i += i < 0 ? K : 0;
                    const bool iv = i < o;
                    const T t = t_mul(qs, sw[s * SW + 1 + (iv ? i : 0)]);
                    e.t[p] = iv ? t : (T)0;
                }
            }
            const unsigned m = __ballot_sync(FULL, h);
            const int nh = __popc(m), nh8 = (nh + 7) & ~7;
            if (h) hl[__popc(m & below)] = e;
            if (lane >= nh && lane < nh8) {         // hits that add nothing
                e.dyz = 0x7fff | 0x7fff << 16;
                hl[lane] = e;
            }
            __syncwarp();
            // the column's atoms in order, eight at a time: for atom g lane
            // (yy, zz) takes slots j = dy - yy and k = dz - zz (mod K)
            // where both are below the order; t = 0 for a plane the atom
            // does not reach
            for (int u0 = 0; u0 < nh8; u0 += 8) {
#pragma unroll
                for (int u = 0; u < 8; u += PAIR ? 2 : 1) {
                    const Hit g = hl[u0 + u + half];
                    int j = (g.dyz & 0xffff) - yy, k = (g.dyz >> 16) - zz;
                    j += j < 0 ? K : 0;
                    k += k < 0 ? K : 0;
                    const bool ok = (j < o) & (k < o);
                    const T* row = sw + g.s * SW;
                    const T wy = row[OY + (ok ? j : 0)];
                    // w2[k], or 0 where a slot is past the order: a zero
                    // product leaves the sum's bits as they are (it never
                    // holds -0)
                    const T wz = ok ? row[OZ + k] : (T)0;
#pragma unroll
                    for (int p = 0; p < P; ++p) {
                        const T t = P == 1 ? row[0] : g.t[p];
                        const T prod = t_mul(t_mul(t, wy), wz);
                        acc[p] = acc[p] + prod;
                        if constexpr (PAIR)     // lane l + 16: the next atom
                            acc[p] = acc[p] + __shfl_down_sync(FULL, prod, 16);
                    }
                }
            }
            __syncwarp();
        }
    };

    // 1. scan the atoms R a thread a step (atoms base + r NT + tid, the
    // next step's base points in flight), test each against the tile, load
    // the row of each that reaches it, and stage those rows in ascending
    // atom order (slot r, then thread), adding the staged atoms whenever
    // the stage fills and at the end
    long long nx[R], ny[R], nz[R];
    auto fetch = [&](int base) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const size_t a = (size_t)min(base + r * NT + tid, n - 1);
            nx[r] = __ldg(nearpt + 3 * a);
            ny[r] = __ldg(nearpt + 3 * a + 1);
            nz[r] = __ldg(nearpt + 3 * a + 2);
        }
    };
    if (n > 0) fetch(0);
    int count = 0;                          // atoms staged, not yet added
    for (int base = 0; base < n; base += CH) {
        int cx[R], cy[R], cz[R];
        bool near = true;
#pragma unroll
        for (int r = 0; r < R; ++r)
            near &= nx[r] >= -K && nx[r] < 2 * (long long)K && ny[r] >= -K
                    && ny[r] < 2 * (long long)K && nz[r] >= -K
                    && nz[r] < 2 * (long long)K;
        if (__all_sync(FULL, near)) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                cx[r] = wrap_near(nx[r], K);
                cy[r] = wrap_near(ny[r], K);
                cz[r] = wrap_near(nz[r], K);
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                cx[r] = wrap_index(nx[r], K);
                cy[r] = wrap_index(ny[r], K);
                cz[r] = wrap_index(nz[r], K);
            }
        }
        if (base + CH < n) fetch(base + CH);
        unsigned hits[R];
        T row[R][OW];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const bool h = (base + r * NT + tid < n)
                           & (cyc(cx[r], X0, K) < xw)
                           & (cyc(cy[r], y0, K) < yw)
                           & (!ztest | (cyc(cz[r], z0, K) < zw));
            hits[r] = __ballot_sync(FULL, h);
            if (lane == 0) scnt[r * WARPS + warp] = __popc(hits[r]);
            if constexpr (REG) {
                if (h) {            // the row, before the counts are known
                    const size_t a = base + r * NT + tid;
                    const T* wa = w + a * 3 * O;
                    const int i = cyc(cx[r], X0, K);
                    const T wx = __ldg(wa + (i < O ? i : 0));
                    row[r][0] = i < O ? t_mul(__ldg(q + a), wx) : (T)0;
#pragma unroll
                    for (int f = 0; f < 2 * O; ++f)
                        row[r][1 + f] = __ldg(wa + O + f);
                }
            }
        }
        __syncthreads();
        // inclusive scan of the (slot, warp) counts, in every warp
        // (two a lane: counts lane and lane + 32)
        int i0 = lane < NC ? scnt[lane] : 0;
        int i1 = lane + 32 < NC ? scnt[lane + 32] : 0;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int u0 = __shfl_up_sync(FULL, i0, d);
            const int u1 = __shfl_up_sync(FULL, i1, d);
            if (lane >= d) {
                i0 += u0;
                i1 += u1;
            }
        }
        i1 += __shfl_sync(FULL, i0, 31);
        const int total = __shfl_sync(FULL, i1, 31);
        int g[R];                           // this step's rank of a hit
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int c = r * WARPS + warp;
            g[r] = __shfl_sync(FULL, c < 32 ? i0 : i1, c & 31)
                   - __popc(hits[r]) + __popc(hits[r] & below);
        }
        const bool last = base + CH >= n;
        bool flushed = false;
        for (int first = 0;;) {             // hits first .. of this step
            const int take = min(ST - count, total - first);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if ((hits[r] >> lane & 1u) && g[r] >= first
                    && g[r] < first + take) {
                    const int s = count + g[r] - first;
                    sb0[s] = cx[r];
                    sb1[s] = cy[r];
                    sb2[s] = cz[r];
                    T* dst = sw + s * SW;
                    const size_t a = base + r * NT + tid;
                    const T* wa = w + a * 3 * o;
                    if constexpr (REG) {
#pragma unroll
                        for (int f = 0; f < OW; ++f) dst[f] = row[r][f];
                    } else if constexpr (P > 1) {
                        // waited for before the atoms are added
                        copy_async(dst, q + a);
                        for (int f = 0; f < 3 * o; ++f)
                            copy_async(dst + 1 + f, wa + f);
                    } else {
                        const int i = cyc(cx[r], X0, K);
                        dst[0] = i < o ? t_mul(q[a], wa[i]) : (T)0;
                        for (int f = 0; f < 2 * o; ++f) dst[1 + f] = wa[o + f];
                    }
                }
            }
            count += take;
            first += take;
            if (count < ST && !(last && first >= total)) break;
            copy_async_wait();
            __syncthreads();
            add_staged(count);
            __syncthreads();
            count = 0;
            flushed = true;
            if (first >= total) break;
        }
        if (!flushed) __syncthreads();      // the counts are read
    }

    // 3. every element of the tile, written once
    if (cv && half == 0 && Yp + yy < y0 + yb && Zp + zz < z0 + zt) {
#pragma unroll
        for (int p = 0; p < P; ++p)
            if (p < xp)
                grid[((size_t)(X0 + p) * K + Yp + yy) * K + Zp + zz] = acc[p];
    }
}

#define GATHER_WARPS 4              // atoms a block of B2

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
// tables in shared memory.  A batched launch runs replica blockIdx.y on
// its own inputs, each `*_bs` elements past the previous replica's (0:
// shared), and writes its own gq (n) and gx (n, 3).
template <typename T, int O>
__global__ void __launch_bounds__(GATHER_WARPS * 32)
gather_kernel(const T* __restrict__ gq_grid, const T* __restrict__ w,
              const T* __restrict__ dw, const long long* __restrict__ nearpt,
              const T* __restrict__ q, const T* __restrict__ recip,
              T* __restrict__ gq, T* __restrict__ gx, int n, int K,
              int order, int g_bs, int w_bs, int np_bs, int q_bs,
              int r_bs) {
    const size_t rep = blockIdx.y;
    gq_grid += rep * g_bs;
    w += rep * w_bs;
    dw += rep * w_bs;
    nearpt += rep * np_bs;
    q += rep * q_bs;
    recip += rep * r_bs;
    gq += rep * n;
    gx += rep * 3 * n;
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

template <typename T, int P>
static int spread_go(const void* w, const void* nearpt, const void* q,
                     void* grid, cudaStream_t s, int n, int K, int order,
                     int nb, int w_bs, int np_bs, int q_bs) {
    using Tile = SpreadTile<P>;
    const int nbz = (K + Tile::BZ - 1) / Tile::BZ;
    if (nb < 1 || (long long)nb * nbz > 65535)
        return (int)cudaErrorInvalidValue;
    const dim3 blocks((K + P - 1) / P,
                      (K + Tile::BY - 1) / Tile::BY, nb * nbz);
    const dim3 th(Tile::WARPS * 32);
#define SPREAD_ARGS (const T*)w, (const long long*)nearpt, (const T*)q,    \
        (T*)grid, n, K, order, nbz, w_bs, np_bs, q_bs
    if (order == 6 && order <= K) {
        spread_kernel<T, 6, P><<<blocks, th, 0, s>>>(SPREAD_ARGS);
    } else if (order == 4 && order <= K) {
        spread_kernel<T, 4, P><<<blocks, th, 0, s>>>(SPREAD_ARGS);
    } else {
        const size_t shm = spread_smem_t<T, P>(order);
        const int err = allow_smem((const void*)spread_kernel<T, 0, P>,
                                   shm);
        if (err) return err;
        spread_kernel<T, 0, P><<<blocks, th, shm, s>>>(SPREAD_ARGS);
    }
#undef SPREAD_ARGS
    return (int)cudaGetLastError();
}

// B1 writes every grid element, so the grid needs no zero fill; it
// launches for n = 0 too (a grid of zeros)
template <typename T>
static int spread_launch(const void* w, const void* nearpt, const void* q,
                         void* grid, void* stream, int n, int K, int order,
                         int nb, int w_bs, int np_bs, int q_bs) {
    cudaStream_t s = (cudaStream_t)stream;
    if (K <= 32)
        return spread_go<T, 1>(w, nearpt, q, grid, s, n, K, order, nb, w_bs,
                               np_bs, q_bs);
    return spread_go<T, 4>(w, nearpt, q, grid, s, n, K, order, nb, w_bs,
                           np_bs, q_bs);
}

template <typename T>
static int gather_launch(const void* gq_grid, const void* w, const void* dw,
                         const void* nearpt, const void* q,
                         const void* recip, void* gq, void* gx, void* stream,
                         int n, int K, int order, int nb, int g_bs, int w_bs,
                         int np_bs, int q_bs, int r_bs) {
    const int blocks = (n + GATHER_WARPS - 1) / GATHER_WARPS;
    if (blocks == 0) return (int)cudaGetLastError();
    if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const dim3 th(GATHER_WARPS * 32);
    const dim3 grid(blocks, nb);
#define GATHER_ARGS (const T*)gq_grid, (const T*)w, (const T*)dw,         \
        (const long long*)nearpt, (const T*)q, (const T*)recip, (T*)gq,    \
        (T*)gx, n, K, order, g_bs, w_bs, np_bs, q_bs, r_bs
    if (order == 6 && order <= K) {
        gather_kernel<T, 6><<<grid, th, 0, s>>>(GATHER_ARGS);
    } else if (order == 4 && order <= K) {
        gather_kernel<T, 4><<<grid, th, 0, s>>>(GATHER_ARGS);
    } else {
        const size_t shm = gather_smem_t<T>(order);
        const int err = allow_smem((const void*)gather_kernel<T, 0>, shm);
        if (err) return err;
        gather_kernel<T, 0><<<grid, th, shm, s>>>(GATHER_ARGS);
    }
#undef GATHER_ARGS
    return (int)cudaGetLastError();
}

#define SPREAD_ENTRY(SUF, T)                                               \
    KERNELS_API int pme_spread_##SUF(const void* w, const void* nearpt,    \
                                     const void* q, void* grid,            \
                                     void* stream, int n, int K, int order,\
                                     int nb, int w_bs, int np_bs,          \
                                     int q_bs) {                           \
        return spread_launch<T>(w, nearpt, q, grid, stream, n, K, order,   \
                                nb, w_bs, np_bs, q_bs);                    \
    }                                                                      \
    KERNELS_API int pme_gather_##SUF(                                      \
        const void* gq_grid, const void* w, const void* dw,                \
        const void* nearpt, const void* q, const void* recip, void* gq,    \
        void* gx, void* stream, int n, int K, int order, int nb, int g_bs, \
        int w_bs, int np_bs, int q_bs, int r_bs) {                         \
        return gather_launch<T>(gq_grid, w, dw, nearpt, q, recip, gq, gx,  \
                                stream, n, K, order, nb, g_bs, w_bs,       \
                                np_bs, q_bs, r_bs);                        \
    }
SPREAD_ENTRY(f32, float)
SPREAD_ENTRY(f64, double)
