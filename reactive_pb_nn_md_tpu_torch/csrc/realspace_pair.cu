// Kernels A, A' and A'': inter-molecular real-space pair sweep over a
// static cell grid.
//
// Replace reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:_kernel /
// _pair_math: A its full 27-stencil path (_forward, :601), A' the same
// kernel with half=True (:601), A'' the column walk (_forward_column ->
// _kernel_column, :657).  Input: the cell-packed atom array cm
// (n_cells*ccap, 8) row-major [x y z q type mol 0 0]; empty slots hold a
// sentinel position and mol = -1 (the sentinel folds back into the box
// under the minimum image, so the mol >= 0 tests are load-bearing).
// Output: per slot [dE_el/dx (3), dE_vdw/dx (3), e_el, e_vdw] -- analytic
// gradients come out of the forward sweep, so the backward needs no
// kernel.  All three share pair_math (erfc-Ewald + LJ / SAPT
// Buckingham-Tang-Toennies), so they compute one function.
//
// A (rs_full_kernel): every ordered pair, so each i row has one writer
// and needs no j-side sum: no fold launch, no atomics, no scratch.  On
// the flagship box (cells (4, 4, 4, 24), 649 atoms) it is bound by
// latency, not bytes or operations: 58% of the slots are empty, a real
// atom has ~270 occupied stencil candidates of which ~38 lie inside the
// cutoff, and the pair math (erfc, exp, divides in fp64) is a long
// dependent chain.  So a block of 8 warps owns one cell, or one of
// `parts` interleaved slices of its atoms (2 at the flagship: 128
// blocks, one an SM, ran faster than 192 or 256); it stages the 27
// cells' slots in shared memory in one round of independent loads
// issued before anything waits on a load, and lists the occupied ones
// (ballots, a warp scan).  A warp takes one i atom, or one 32-aligned
// part of its candidate list when the block has fewer atoms than warps:
// it runs the cheap test (molecule ids, r2 < rcut2 under the minimum
// image, 1/L precomputed) on 4 x 32 candidates a step with no branch,
// ballots append the survivors to a per-warp ring in candidate order,
// and pair_math runs on 32 ring entries at a time, in full lanes.  No
// integer division or fp64 divide is left per candidate.  Sums run in an
// order fixed by the input (lane-strided, then a butterfly, then the
// parts in order): two calls give the same bits.  Shared memory grows
// with ccap alone (full_smem_t).  Empty rows are written as zeros by the
// cell's part 0.  tools/full_phases.py times its phases.
//
// A' and A'' evaluate each unordered pair once: the self cell's strict
// upper triangle plus the 13 lexicographically positive neighbor cells
// (distinct for >= 3 cells an axis); the whole pair energy goes to the i
// row.  On the TPU A'' walks one xy column of cells in z to reuse the
// loaded stencil columns; on the H100 both run one routine,
// rs_half_cell_kernel, with one block per cell (1000 blocks of 4 warps
// at the 10k box's (10, 10, 10) grid, several resident per SM: the
// column walk's reuse would serialise a block again, and the stencil
// cells come from L2).  The work is latency-bound (tools/pair_phases.py
// times its phases; PERF.md): ~58% of slots are empty and ~14% of the
// real candidates lie inside the cutoff, so the block compacts the
// occupied slots, runs the cheap test on every candidate and the pair
// math (erfc, exp, divides) on the survivors alone, in full warps.
// The j-side force partials need a reduction across i: ordered sums in
// shared memory, and per-offset arrays with one writer per slot, folded
// in order by a second launch.  Every sum has an order fixed by the
// input: deterministic, no atomics.  Shared memory grows with ccap and
// not with the grid (half_smem_t).
// Bound as A, on half the candidate pairs.
#include "common.cuh"

template <typename T>
struct PairConst {
    const T* stab;          // (n_tab, T, T) parameter tables, shared memory
    int T_, TT, has_sapt;
    T Lx, Ly, Lz, iLx, iLy, iLz, rcut2, alpha, conv, two_a_pi;
};

template <typename T>
__device__ __forceinline__ PairConst<T> pair_const(
        const T* stab, const T* box, int T_, int has_sapt, T rcut2, T alpha,
        T conv) {
    PairConst<T> P;
    P.stab = stab;
    P.T_ = T_;
    P.TT = T_ * T_;
    P.has_sapt = has_sapt;
    P.Lx = box[0];                     // orthorhombic box
    P.Ly = box[4];
    P.Lz = box[8];
    P.iLx = (T)1 / P.Lx;               // the minimum image's 1/L, once
    P.iLy = (T)1 / P.Ly;
    P.iLz = (T)1 / P.Lz;
    P.rcut2 = rcut2;
    P.alpha = alpha;
    P.conv = conv;
    P.two_a_pi = (T)2.0 * alpha / (T)1.7724538509055160273;
    return P;
}

// Minimum-image separation d = xi - xj (orthorhombic box) and |d|^2.
template <typename T>
__device__ __forceinline__ T pair_r2(T xi, T yi, T zi, T xj, T yj, T zj,
                                     const PairConst<T>& P, T& dx, T& dy,
                                     T& dz) {
    dx = xi - xj;
    dy = yi - yj;
    dz = zi - zj;
    dx -= P.Lx * t_rint(dx * P.iLx);
    dy -= P.Ly * t_rint(dy * P.iLy);
    dz -= P.Lz * t_rint(dz * P.iLz);
    return dx * dx + dy * dy + dz * dz;
}

// The pair physics, the one definition all three kernels share: for an
// inter-molecular pair at r2 < rcut2, the force factors (dE/dxi = -s d)
// and the pair energies.
template <typename T>
__device__ __forceinline__ void pair_math(T r2, T qi, T qj, int ti, int tj,
                                          const PairConst<T>& P, T& s_el,
                                          T& s_v, T& e_el, T& e_v) {
    const T inv_r2 = (T)1 / r2;
    const T r = t_sqrt(r2);
    const T inv_r = (T)1 / r;
    // erfc-Ewald (pairwise_real_space_ewald)
    const T qq = qi * qj * P.conv;
    const T ar = P.alpha * r;
    const T erfc_ar = t_erfc(ar);
    e_el = qq * erfc_ar * inv_r;
    s_el = qq * (erfc_ar * inv_r + P.two_a_pi * t_exp(-ar * ar)) * inv_r2;
    // vdW: LJ or SAPT Buckingham + Tang-Toennies
    const int p = ti * P.T_ + tj;
    const T* stab = P.stab;
    const int TT = P.TT;
    const T vt = stab[p];
    const T c12 = stab[TT + p], c6 = stab[2 * TT + p];
    e_v = 0;
    s_v = 0;
    if (vt == (T)0) {
        const T inv_r6 = inv_r2 * inv_r2 * inv_r2;
        const T inv_r12 = inv_r6 * inv_r6;
        e_v = c12 * inv_r12 - c6 * inv_r6;
        s_v = ((T)12 * c12 * inv_r12 - (T)6 * c6 * inv_r6) * inv_r2;
    } else if (P.has_sapt && vt == (T)1) {
        const T A = stab[3 * TT + p], B = stab[4 * TT + p];
        const T Cs[4] = {c6, stab[5 * TT + p], stab[6 * TT + p],
                         stab[7 * TT + p]};
        T x_tt = B * r;
        if (x_tt > (T)40) x_tt = (T)40;
        const T ex = t_exp(-x_tt);
        e_v = A * ex;
        s_v = A * B * ex * inv_r;
        T term = 1, ssum = 1, fact = 1;
        T inv_rn = inv_r2 * inv_r2 * inv_r2;
        for (int n = 1; n <= 12; ++n) {
            fact *= (T)n;
            term *= x_tt;
            ssum += term / fact;
            if (n >= 6 && (n & 1) == 0) {
                const T fn = (T)1 - ssum * ex;
                const T dfn = ex * term / fact;
                const T Cn = Cs[(n - 6) / 2];
                e_v -= fn * Cn * inv_rn;
                s_v += (B * dfn * Cn * inv_rn
                        - (T)n * fn * Cn * inv_rn * inv_r) * inv_r;
                inv_rn *= inv_r2;
            }
        }
    }
}

template <typename T>
__device__ __forceinline__ void load_tabs(const T* __restrict__ tabs, T* stab,
                                          int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) stab[k] = tabs[k];
}

// Offset k of the full stencil: self first (k = 0), then the other 26 in
// lexicographic order (_offsets(False) of the TPU kernel, self moved to
// the front so that a cell's own atoms open the candidate list);
// tests/test_torch_realspace_pair.py mirrors it.  Divisions by constants
// only.
__device__ __forceinline__ void full_off(int k, int& o1, int& o2, int& o3) {
    const int l = k == 0 ? 13 : k - 1 + (k >= 14);   // lexicographic index
    o1 = l / 9 - 1;
    o2 = (l / 3) % 3 - 1;
    o3 = l % 3 - 1;
}

#define FULL_WARPS 8                // warps a block of kernel A
#define FULL_THREADS (32 * FULL_WARPS)
#define FULL_ILP 4                  // groups of 32 candidates a filter step
#define FULL_RING 256               // a warp's survivor ring (> 31 + 32 ILP)
#define FULL_BATCH 4                // slots a thread stages in one round

// Shared memory of rs_full_kernel in bytes (the wrapper's check_full_smem
// mirrors it).  With N = 27 ccap staged slots, R = max(ccap, FULL_WARPS)
// partial rows and ceil(N / 32) occupancy words: T values [tables | x,
// y, z, q (N each) | partial rows (8 R)], then ints [type, mol, occupied
// list (N each) | occupancy words | rings (FULL_WARPS x FULL_RING)].
// Nothing in it depends on the grid's size.
template <typename T>
static size_t full_smem_t(int n_tabv, int ccap) {
    const size_t N = 27 * (size_t)ccap;
    const size_t R = ccap > FULL_WARPS ? ccap : FULL_WARPS;
    return ((size_t)n_tabv + 4 * N + 8 * R) * sizeof(T)
           + (3 * N + (N + 31) / 32 + FULL_WARPS * FULL_RING) * sizeof(int);
}

// one packed row's [x y z q type mol] (16-byte loads: the wrapper checks
// the alignment)
__device__ __forceinline__ void load_row(const double* r, double& x,
                                         double& y, double& z, double& q,
                                         double& t, double& m) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(r));
    const double2 b = __ldg(reinterpret_cast<const double2*>(r) + 1);
    const double2 c = __ldg(reinterpret_cast<const double2*>(r) + 2);
    x = a.x; y = a.y; z = b.x; q = b.y; t = c.x; m = c.y;
}
__device__ __forceinline__ void load_row(const float* r, float& x, float& y,
                                         float& z, float& q, float& t,
                                         float& m) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(r));
    const float2 b = __ldg(reinterpret_cast<const float2*>(r) + 2);
    x = a.x; y = a.y; z = a.z; q = a.w; t = b.x; m = b.y;
}

// (c + o) mod n for c in [0, n), o in {-1, 0, 1}
__device__ __forceinline__ int wrap1(int c, int o, int n) {
    const int a = c + o;
    return a < 0 ? a + n : a >= n ? a - n : a;
}

// Kernel A: block (c, part) over the full stencil of cell c, for the
// atoms i = part, part + parts, ... of the cell's occupied slots.
//  - stage: staged slot u = k ccap + s is slot s of stencil cell k (self
//    first); every thread walks its slots with no division by a run-time
//    value, finds the cell by full_off and a wrap, and loads the rows of
//    FULL_BATCH slots with 16-byte loads before storing any (one round
//    of independent loads at ccap <= 37); a ballot a warp keeps each 32
//    slots' occupancy;
//  - list: every warp scans the occupancy words' counts (shuffles), and
//    the occupied slots are listed in u order (one barrier in all);
//  - items: m atoms a block; an atom's candidate list is cut into P
//    32-aligned parts when m < FULL_WARPS (P = FULL_WARPS / m), so that
//    every warp has work; warp w takes items w, w + FULL_WARPS, ...;
//  - per item: filter FULL_ILP x 32 candidates a step (ballots -> ring),
//    pair_math on 32 ring entries whenever 32 wait, and on the rest at
//    the end; the warp's 8 sums by butterfly into the item's partial row;
//  - out: each atom's row = its P partial rows in order (energies
//    halved), to its slot; part 0 writes the empty slots' zeros.
// A range launch takes the home cells c0, c0 + 1, ..., c0 + gridDim.x - 1
// only (one replica's step shared over ranks: each rank its own cells);
// the rows of the other cells are not written.
// A batched launch (a replica batch of the vmapped step) runs replica
// blockIdx.z on its own cm, tables, box and rows, each `*_bs` elements
// past the previous replica's (0: one array shared by the batch): the
// same arithmetic in the same order as its own launch.
template <typename T>
__global__ void __launch_bounds__(FULL_THREADS)
rs_full_kernel(const T* __restrict__ cm, const T* __restrict__ tabs,
               const T* __restrict__ box, T* __restrict__ out, int nc1,
               int nc2, int nc3, int ccap, int c0, int T_, int n_tab,
               int has_sapt, int cm_bs, int tab_bs, int box_bs, T rcut2,
               T alpha, T conv) {
    const size_t rep = blockIdx.z;
    cm += rep * cm_bs;
    tabs += rep * tab_bs;
    box += rep * box_bs;
    out += rep * cm_bs;
    extern __shared__ unsigned char smem_raw[];
    const int n_tabv = n_tab * T_ * T_, N = 27 * ccap, NW = (N + 31) >> 5;
    const int R = ccap > FULL_WARPS ? ccap : FULL_WARPS;
    T* stab = reinterpret_cast<T*>(smem_raw);
    T* sx = stab + n_tabv;
    T* sy = sx + N;
    T* sz = sy + N;
    T* sq = sz + N;
    T* prow = sq + N;
    int* sty = reinterpret_cast<int*>(prow + 8 * R);
    int* smol = sty + N;
    int* lst = smol + N;
    unsigned* occw = reinterpret_cast<unsigned*>(lst + N);
    int* ring = reinterpret_cast<int*>(occw + NW);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int c = c0 + blockIdx.x, part = blockIdx.y, parts = gridDim.y;
    const int c1 = c / (nc2 * nc3), c2 = (c / nc3) % nc2, c3 = c % nc3;

    // stage: thread tid takes u = tid, tid + FULL_THREADS, ..., the rows
    // of FULL_BATCH of them loaded before any is stored, and before the
    // tables and the box (a warp issues in order: a store that waits for
    // its load would hold back the loads behind it)
    const int dk = FULL_THREADS / ccap, ds = FULL_THREADS - dk * ccap;
    int k = tid / ccap, s = tid - k * ccap;
    PairConst<T> P;
    for (int u0 = 0; u0 < N; u0 += FULL_BATCH * FULL_THREADS) {
        T v[FULL_BATCH][6];
#pragma unroll
        for (int r = 0; r < FULL_BATCH; ++r) {
            v[r][5] = (T)-1;
            if (u0 + r * FULL_THREADS + tid < N) {
                int o1, o2, o3;
                full_off(k, o1, o2, o3);
                const int nb = (wrap1(c1, o1, nc1) * nc2
                                + wrap1(c2, o2, nc2)) * nc3
                               + wrap1(c3, o3, nc3);
                load_row(cm + ((size_t)nb * ccap + s) * 8, v[r][0], v[r][1],
                         v[r][2], v[r][3], v[r][4], v[r][5]);
            }
            k += dk;
            s += ds;
            if (s >= ccap) {
                s -= ccap;
                ++k;
            }
        }
        if (u0 == 0) {
            load_tabs(tabs, stab, n_tabv);
            P = pair_const(stab, box, T_, has_sapt, rcut2, alpha, conv);
        }
#pragma unroll
        for (int r = 0; r < FULL_BATCH; ++r) {
            const int u = u0 + r * FULL_THREADS + tid;
            const bool occ = v[r][5] >= (T)0;
            if (u < N) {
                sx[u] = v[r][0];
                sy[u] = v[r][1];
                sz[u] = v[r][2];
                sq[u] = v[r][3];
                sty[u] = (int)t_rint(v[r][4]);
                smol[u] = occ ? (int)t_rint(v[r][5]) : -1;
            }
            const unsigned bal = __ballot_sync(0xffffffffu, occ);
            const int w = ((u0 + r * FULL_THREADS) >> 5) + warp;
            if (lane == 0 && w < NW) occw[w] = bal;
        }
    }
    __syncthreads();

    // list: the occupied u in order, each at the occupied count of the
    // words before its own (a warp scan of 32 words at a time, in every
    // warp) plus its rank in its word; n0 of them in the self cell (u <
    // ccap), Nj in all
    int Nj = 0, n0 = 0;
    for (int g = 0, u0 = 0; g < NW; g += 32) {
        const int w = g + lane, lo = w << 5;
        const unsigned b = w < NW ? occw[w] : 0u;
        const int cnt = __popc(b);
        int incl = cnt;
        for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += t;
        }
        n0 += warp_allsum(lo >= ccap ? 0
                          : __popc(ccap - lo >= 32
                                   ? b : b & ((1u << (ccap - lo)) - 1u)));
        // this thread's words in the group: (u0 >> 5) + warp
        for (; u0 < N && (u0 >> 5) + warp < g + 32; u0 += FULL_THREADS) {
            const int q = (u0 >> 5) + warp - g;
            const int start = Nj + __shfl_sync(0xffffffffu, incl - cnt, q);
            const unsigned bq = __shfl_sync(0xffffffffu, b, q);
            if (bq >> lane & 1u) lst[start + __popc(bq & lt)] = u0 + tid;
        }
        Nj += __shfl_sync(0xffffffffu, incl, 31);
    }
    __syncthreads();

    // items: this block's m atoms, each cut into np parts of the list
    const int m = part < n0 ? (n0 - part + parts - 1) / parts : 0;
    const int np = m > 0 && m < FULL_WARPS ? FULL_WARPS / m : 1;
    const int passes = (Nj + 31) >> 5;
    const int chunk = ((passes + np - 1) / np) << 5;
    int* rg = ring + warp * FULL_RING;
    for (int item = warp; item < m * np; item += FULL_WARPS) {
        const int a = item / np, pc = item - a * np;
        const int ui = lst[part + parts * a];   // self cell: ui = its slot
        const T xi = sx[ui], yi = sy[ui], zi = sz[ui], qi = sq[ui];
        const int ti = sty[ui], moli = smol[ui];
        const int lo = pc * chunk, hi = min(Nj, lo + chunk);
        T acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        int head = 0, nq = 0;
        auto add = [&](int u) {
            T dx, dy, dz, s_el, s_v, ee, ev;
            const T r2 = pair_r2(xi, yi, zi, sx[u], sy[u], sz[u], P, dx,
                                 dy, dz);
            pair_math(r2, qi, sq[u], ti, sty[u], P, s_el, s_v, ee, ev);
            acc[0] -= s_el * dx;
            acc[1] -= s_el * dy;
            acc[2] -= s_el * dz;
            acc[3] -= s_v * dx;
            acc[4] -= s_v * dy;
            acc[5] -= s_v * dz;
            acc[6] += ee;
            acc[7] += ev;
        };
        // FULL_ILP groups of 32 candidates a step, tested with no branch
        // (indices clamped, then masked) so that their chains overlap;
        // survivors appended in candidate order
        for (int b = lo; b < hi; b += 32 * FULL_ILP) {
            int uu[FULL_ILP];
            bool keep[FULL_ILP];
#pragma unroll
            for (int g = 0; g < FULL_ILP; ++g) {
                const int n = b + 32 * g + lane;
                uu[g] = lst[min(n, hi - 1)];
                T dx, dy, dz;
                const T r2 = pair_r2(xi, yi, zi, sx[uu[g]], sy[uu[g]],
                                     sz[uu[g]], P, dx, dy, dz);
                keep[g] = n < hi && smol[uu[g]] != moli && r2 < P.rcut2;
            }
#pragma unroll
            for (int g = 0; g < FULL_ILP; ++g) {
                const unsigned bal = __ballot_sync(0xffffffffu, keep[g]);
                if (keep[g])
                    rg[(head + nq + __popc(bal & lt)) & (FULL_RING - 1)] =
                        uu[g];
                nq += __popc(bal);
            }
            __syncwarp();
            while (nq >= 32) {                  // a full warp of pairs
                add(rg[(head + lane) & (FULL_RING - 1)]);
                head = (head + 32) & (FULL_RING - 1);
                nq -= 32;
                __syncwarp();
            }
        }
        if (lane < nq) add(rg[(head + lane) & (FULL_RING - 1)]);
        __syncwarp();
        T v = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            const T t = warp_allsum(acc[k]);
            v = lane == k ? t : v;
        }
        if (lane < 8) prow[item * 8 + lane] = v;
    }
    __syncthreads();

    // out: rows in order of their parts; part 0 zeros the empty slots
    T* orow = out + (size_t)c * ccap * 8;
    for (int e = tid; e < m * 8; e += FULL_THREADS) {
        const int a = e >> 3, k = e & 7;
        T v = 0;
        for (int pc = 0; pc < np; ++pc) v += prow[(a * np + pc) * 8 + k];
        orow[lst[part + parts * a] * 8 + k] = k < 6 ? v : (T)0.5 * v;
    }
    if (part == 0)
        for (int e = tid; e < ccap * 8; e += FULL_THREADS)
            if (smol[e >> 3] < 0) orow[e] = (T)0;
}

// the half stencil: self first, then the 13 lexicographically positive
// offsets (_offsets(True) of the TPU kernel)
__constant__ int HALF_OFF[14][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, -1}, {0, 1, 0}, {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1}, {1, 1, -1}, {1, 1, 0}, {1, 1, 1}};

#define HALF_THREADS 128            // 4 warps a block
#define HALF_WARPS (HALF_THREADS / 32)
#define PAIR_LIST 256               // pairs one flush evaluates
static_assert(PAIR_LIST >= HALF_THREADS, "a filter pass must fit");

// Shared memory of rs_half_cell_kernel in bytes (the wrapper's
// check_half_smem mirrors it).  With N = 14 ccap staged slots: T values
// [tables | x, y, z, q (N each) | j-side sums (6 N) | pair terms (8
// PAIR_LIST) | i-side sums (8 ccap)], then ints [mol, type, slot map (N
// each) | pair list (PAIR_LIST) | run starts (ccap + 1) | counts, starts,
// cell ids (3 x 16) | warp counts (2 HALF_WARPS)].  Nothing in it
// depends on the grid's size.
template <typename T>
static size_t half_smem_t(int n_tabv, int ccap) {
    const size_t N = 14 * (size_t)ccap;
    return ((size_t)n_tabv + 10 * N + 8 * PAIR_LIST + 8 * (size_t)ccap)
               * sizeof(T)
           + (3 * N + PAIR_LIST + ccap + 1 + 48 + 2 * HALF_WARPS)
               * sizeof(int);
}

__device__ __forceinline__ int half_nb(int c1, int c2, int c3, int k,
                                       int nc1, int nc2, int nc3) {
    return (((c1 + HALF_OFF[k][0] + nc1) % nc1) * nc2
            + (c2 + HALF_OFF[k][1] + nc2) % nc2) * nc3
           + (c3 + HALF_OFF[k][2] + nc3) % nc3;
}

template <typename T>
struct HalfSmem {
    T *sx, *sy, *sz, *sq, *jacc, *pv, *irow;
    int *smol, *sty, *nmap, *lst, *seg, *cnt, *nstart, *nbid, *wcnt;
};

// first e in [lo, hi) with lst[e] >= key
__device__ __forceinline__ int first_key_geq(const int* lst, int lo, int hi,
                                           int key) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (lst[mid] < key) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// Evaluate the L listed pairs (keys t = i Nj + n, ascending) and add
// them to the i-side rows and the j-side sums, both in list order:
//  1. one thread per pair: pair_math's terms into pv (8 arrays of
//     PAIR_LIST, so a warp reads consecutive words), and where each i's
//     run of keys starts (binary search);
//  2. warps 1..3, one per i: its run summed by lanes, then a shuffle
//     tree, into irow[i] (forces negated, energies whole);
//  3. warp 0 meanwhile: the runs in ascending i, each added to jacc by
//     its lanes (the n of one run are distinct: no two lanes collide).
// Every sum has an order fixed by the input alone: no atomics.
template <typename T>
__device__ void half_flush(const HalfSmem<T>& S, int L, int Nj,
                           const PairConst<T>& P) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int e = tid; e < L; e += HALF_THREADS) {
        const int t = S.lst[e], i = t / Nj, n = t - i * Nj;
        T dx, dy, dz, s_el, s_v, ee, ev;
        const T r2 = pair_r2(S.sx[i], S.sy[i], S.sz[i], S.sx[n], S.sy[n],
                             S.sz[n], P, dx, dy, dz);
        pair_math(r2, S.sq[i], S.sq[n], S.sty[i], S.sty[n], P, s_el, s_v,
                  ee, ev);
        T* g = S.pv + e;
        g[0] = s_el * dx;
        g[PAIR_LIST] = s_el * dy;
        g[2 * PAIR_LIST] = s_el * dz;
        g[3 * PAIR_LIST] = s_v * dx;
        g[4 * PAIR_LIST] = s_v * dy;
        g[5 * PAIR_LIST] = s_v * dz;
        g[6 * PAIR_LIST] = ee;
        g[7 * PAIR_LIST] = ev;
    }
    const int i_lo = S.lst[0] / Nj, n_i = S.lst[L - 1] / Nj - i_lo + 1;
    for (int q = tid; q <= n_i; q += HALF_THREADS)
        S.seg[q] = first_key_geq(S.lst, 0, L, (i_lo + q) * Nj);
    __syncthreads();
    if (warp == 0) {
        for (int q = 0; q < n_i; ++q) {
            for (int e = S.seg[q] + lane; e < S.seg[q + 1]; e += 32) {
                T* a = S.jacc + (S.lst[e] - (i_lo + q) * Nj) * 6;
                for (int m = 0; m < 6; ++m) a[m] += S.pv[m * PAIR_LIST + e];
            }
            __syncwarp();
        }
    } else {
        for (int q = warp - 1; q < n_i; q += HALF_WARPS - 1) {
            T v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
            for (int e = S.seg[q] + lane; e < S.seg[q + 1]; e += 32)
                for (int m = 0; m < 8; ++m) v[m] += S.pv[m * PAIR_LIST + e];
            for (int m = 0; m < 8; ++m) v[m] = warp_sum(v[m]);
            if (lane == 0) {
                T* r = S.irow + (i_lo + q) * 8;
                for (int m = 0; m < 8; ++m) r[m] += m < 6 ? -v[m] : v[m];
            }
        }
    }
    __syncthreads();
}

// Kernels A' and A'' (one routine): one block per cell c over its half
// stencil, the self cell's pairs i < j and the 13 positive neighbors.
//  - stage: the occupied slots of the 14 cells, compacted in slot order
//    (self cell first, so i = 0 .. n0-1 index both the i atoms and the
//    self cell's j atoms), in shared memory, in two rounds of one
//    independent load a slot (one warp a cell paid one L2 latency per
//    cell and field);
//  - filter: all threads walk the candidates (i, n), n > i, in key order
//    t = i Nj + n; the cheap test (molecule ids, then r2 < rcut2 under
//    the minimum image) keeps ~14% of them, and a warp ballot plus the
//    warps' counts append the survivors to the pair list in key order;
//  - whenever the list could overflow, and at the end, half_flush runs
//    the pair math on the listed pairs alone, with full warps;
//  - out: the cell's own rows (i side + the self cell's j sides) to
//    `own`, and the j sides of offset k (1..13) to part[k - 1] at the
//    neighbor's slots, 0 at an empty slot (each slot of part[k - 1] has
//    this one writer); rs_fold_kernel adds the 13 in order.
// A batched launch runs replica blockIdx.y (of the fold too) on its own
// cm, tables, box, own rows and 13 part arrays, as rs_full_kernel's
// blockIdx.z: the same arithmetic in the same order as its own launch.
template <typename T>
__global__ void __launch_bounds__(HALF_THREADS)
rs_half_cell_kernel(const T* __restrict__ cm, const T* __restrict__ tabs,
                    const T* __restrict__ box, T* __restrict__ own,
                    T* __restrict__ part, int nc1, int nc2, int nc3,
                    int ccap, int T_, int n_tab, int has_sapt, int cm_bs,
                    int tab_bs, int box_bs, T rcut2, T alpha, T conv) {
    const size_t rep = blockIdx.y;
    cm += rep * cm_bs;
    tabs += rep * tab_bs;
    box += rep * box_bs;
    extern __shared__ unsigned char smem_raw[];
    const int n_tabv = n_tab * T_ * T_, N = 14 * ccap;
    T* stab = reinterpret_cast<T*>(smem_raw);
    HalfSmem<T> S;
    S.sx = stab + n_tabv;
    S.sy = S.sx + N;
    S.sz = S.sy + N;
    S.sq = S.sz + N;
    S.jacc = S.sq + N;
    S.pv = S.jacc + 6 * N;
    S.irow = S.pv + 8 * PAIR_LIST;
    S.smol = reinterpret_cast<int*>(S.irow + 8 * ccap);
    S.sty = S.smol + N;
    S.nmap = S.sty + N;
    S.lst = S.nmap + N;
    S.seg = S.lst + PAIR_LIST;
    S.cnt = S.seg + ccap + 1;
    S.nstart = S.cnt + 16;
    S.nbid = S.nstart + 16;
    S.wcnt = S.nbid + 16;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    load_tabs(tabs, stab, n_tabv);
    const int c = blockIdx.x;
    const int c1 = c / (nc2 * nc3), c2 = (c / nc3) % nc2, c3 = c % nc3;
    const size_t C8 = (size_t)nc1 * nc2 * nc3 * ccap;
    own += rep * C8 * 8;
    part += rep * 13 * C8 * 6;

    // stage: the 14 cells' ids; each slot's occupancy (one load a slot,
    // all independent); its rank among its cell's occupied slots and the
    // cells' counts (ballots on shared flags); the cells' starts; the
    // occupied slots' copies at their compacted positions
    if (tid < 14) S.nbid[tid] = half_nb(c1, c2, c3, tid, nc1, nc2, nc3);
    __syncthreads();
#pragma unroll 4
    for (int u = tid; u < N; u += HALF_THREADS)
        S.nmap[u] = cm[((size_t)S.nbid[u / ccap] * ccap + u % ccap) * 8 + 5]
                    >= (T)0;
    __syncthreads();
    for (int k = warp; k < 14; k += HALF_WARPS) {
        int n = 0;
        for (int s0 = 0; s0 < ccap; s0 += 32) {
            const int s = s0 + lane;
            const bool occ = s < ccap && S.nmap[k * ccap + s];
            const unsigned bal = __ballot_sync(0xffffffffu, occ);
            if (s < ccap) S.nmap[k * ccap + s] = occ ? n + __popc(bal & lt)
                                                     : -1;
            n += __popc(bal);
        }
        if (lane == 0) S.cnt[k] = n;
    }
    __syncthreads();
    if (tid == 0) {
        int a = 0;
        for (int k = 0; k < 14; ++k) {
            S.nstart[k] = a;
            a += S.cnt[k];
        }
        S.nstart[14] = a;
    }
    __syncthreads();
    const int n0 = S.cnt[0], Nj = S.nstart[14];
#pragma unroll 4
    for (int u = tid; u < N; u += HALF_THREADS) {
        const int k = u / ccap, rank = S.nmap[u];
        if (rank < 0) continue;
        const int pos = S.nstart[k] + rank;
        const T* r = cm + ((size_t)S.nbid[k] * ccap + u % ccap) * 8;
        S.nmap[u] = pos;
        S.sx[pos] = r[0];
        S.sy[pos] = r[1];
        S.sz[pos] = r[2];
        S.sq[pos] = r[3];
        S.sty[pos] = (int)t_rint(r[4]);
        S.smol[pos] = (int)t_rint(r[5]);
    }
    for (int k = tid; k < 6 * Nj; k += HALF_THREADS) S.jacc[k] = 0;
    for (int k = tid; k < 8 * n0; k += HALF_THREADS) S.irow[k] = 0;
    __syncthreads();
    const PairConst<T> P = pair_const(stab, box, T_, has_sapt, rcut2, alpha,
                                      conv);

    // filter in key order; flush first whenever this pass's survivors
    // could overflow the list
    const int total = n0 * Nj;
    int L = 0, pass = 0;
    for (int base = 0; base < total; base += HALF_THREADS, ++pass) {
        const int t = base + tid;
        bool keep = false;
        if (t < total) {
            const int i = t / Nj, n = t - i * Nj;
            if (n > i && S.smol[n] != S.smol[i]) {
                T dx, dy, dz;
                keep = pair_r2(S.sx[i], S.sy[i], S.sz[i], S.sx[n], S.sy[n],
                               S.sz[n], P, dx, dy, dz) < P.rcut2;
            }
        }
        const unsigned bal = __ballot_sync(0xffffffffu, keep);
        int* wc = S.wcnt + (pass & 1) * HALF_WARPS;     // double-buffered
        if (lane == 0) wc[warp] = __popc(bal);
        __syncthreads();
        int off = 0, tot = 0;
        for (int w = 0; w < HALF_WARPS; ++w) {
            const int v = wc[w];
            off += w < warp ? v : 0;
            tot += v;
        }
        if (L + tot > PAIR_LIST) {                      // block-uniform
            half_flush(S, L, Nj, P);
            L = 0;
        }
        if (keep) S.lst[L + off + __popc(bal & lt)] = t;
        L += tot;
    }
    __syncthreads();
    if (L > 0) half_flush(S, L, Nj, P);

    // own rows: i side + the self cell's j side; part: offsets 1..13
    T* orow = own + (size_t)c * ccap * 8;
    for (int k = tid; k < ccap * 8; k += HALF_THREADS) {
        const int s = k >> 3, m = k & 7, i = S.nmap[s];
        orow[k] = i < 0 ? (T)0
                        : S.irow[i * 8 + m] + (m < 6 ? S.jacc[i * 6 + m]
                                                     : (T)0);
    }
    for (int k = 1; k < 14; ++k) {
        T* dst = part + ((size_t)(k - 1) * C8 + (size_t)S.nbid[k] * ccap) * 6;
        for (int q = tid; q < ccap * 6; q += HALF_THREADS) {
            const int n = S.nmap[k * ccap + q / 6];
            dst[q] = n < 0 ? (T)0 : S.jacc[n * 6 + q % 6];
        }
    }
}

// out[s] = own[s] + sum_k part[k][s] (forces; energies are own's)
template <typename T>
__global__ void rs_fold_kernel(const T* __restrict__ own,
                               const T* __restrict__ part,
                               T* __restrict__ out, int C8, int n_part) {
    const size_t rep = blockIdx.y;                  // replica of a batch
    own += rep * C8 * 8;
    part += rep * n_part * C8 * 6;
    out += rep * C8 * 8;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)C8 * 8) return;
    const long long s = t / 8;
    const int m = (int)(t % 8);
    T v = own[t];
    if (m < 6)
        for (int k = 0; k < n_part; ++k)
            v += part[((size_t)k * C8 + s) * 6 + m];
    out[t] = v;
}

template <typename T>
static int rs_pair_launch(const void* cm, const void* tabs, const void* box,
                          void* out, void* stream, int nc1, int nc2, int nc3,
                          int ccap, int parts, int c0, int n_c, int T_,
                          int n_tab, int has_sapt, int nb, int cm_bs,
                          int tab_bs, int box_bs, double rcut2,
                          double alpha, double conv) {
    const size_t shm = full_smem_t<T>(n_tab * T_ * T_, ccap);
    int err = allow_smem((const void*)rs_full_kernel<T>, shm);
    if (err) return err;
    if (c0 < 0 || n_c < 1 || c0 + n_c > nc1 * nc2 * nc3 || nb < 1
        || nb > 65535)
        return (int)cudaErrorInvalidValue;
    rs_full_kernel<T><<<dim3(n_c, parts, nb), FULL_THREADS, shm,
                        (cudaStream_t)stream>>>(
        (const T*)cm, (const T*)tabs, (const T*)box, (T*)out, nc1, nc2, nc3,
        ccap, c0, T_, n_tab, has_sapt, cm_bs, tab_bs, box_bs, (T)rcut2,
        (T)alpha, (T)conv);
    return (int)cudaGetLastError();
}

// A' and A'': rs_half_cell_kernel, then the fold of its 13 j-side arrays
template <typename T>
static int rs_half_launch(const void* cm, const void* tabs, const void* box,
                          void* own, void* part, void* out, void* stream,
                          int nc1, int nc2, int nc3, int ccap, int T_,
                          int n_tab, int has_sapt, int nb, int cm_bs,
                          int tab_bs, int box_bs, double rcut2,
                          double alpha, double conv) {
    const size_t shm = half_smem_t<T>(n_tab * T_ * T_, ccap);
    cudaStream_t s = (cudaStream_t)stream;
    int err = allow_smem((const void*)rs_half_cell_kernel<T>, shm);
    if (err) return err;
    if (nb < 1 || nb > 65535) return (int)cudaErrorInvalidValue;
    rs_half_cell_kernel<T><<<dim3(nc1 * nc2 * nc3, nb), HALF_THREADS, shm,
                             s>>>(
        (const T*)cm, (const T*)tabs, (const T*)box, (T*)own, (T*)part,
        nc1, nc2, nc3, ccap, T_, n_tab, has_sapt, cm_bs, tab_bs, box_bs,
        (T)rcut2, (T)alpha, (T)conv);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int C8 = nc1 * nc2 * nc3 * ccap;
    rs_fold_kernel<T><<<dim3((C8 * 8 + 255) / 256, nb), 256, 0, s>>>(
        (const T*)own, (const T*)part, (T*)out, C8, 13);
    return (int)cudaGetLastError();
}

#define RS_ENTRY(NAME, T)                                                    \
    KERNELS_API int NAME(const void* cm, const void* tabs, const void* box, \
                         void* own, void* part, void* out, void* stream,     \
                         int nc1, int nc2, int nc3, int ccap, int T_,        \
                         int n_tab, int has_sapt, int nb, int cm_bs,         \
                         int tab_bs, int box_bs, double rcut2,               \
                         double alpha, double conv) {                        \
        return rs_half_launch<T>(cm, tabs, box, own, part, out, stream,      \
                                 nc1, nc2, nc3, ccap, T_, n_tab, has_sapt,   \
                                 nb, cm_bs, tab_bs, box_bs, rcut2, alpha,    \
                                 conv);                                      \
    }
RS_ENTRY(rs_half_f32, float)
RS_ENTRY(rs_half_f64, double)

#define RS_PAIR_ENTRY(NAME, T)                                               \
    KERNELS_API int NAME(const void* cm, const void* tabs, const void* box, \
                         void* out, void* stream, int nc1, int nc2, int nc3, \
                         int ccap, int parts, int c0, int n_c, int T_,       \
                         int n_tab, int has_sapt, int nb, int cm_bs,         \
                         int tab_bs, int box_bs, double rcut2, double alpha, \
                         double conv) {                                      \
        return rs_pair_launch<T>(cm, tabs, box, out, stream, nc1, nc2, nc3,  \
                                 ccap, parts, c0, n_c, T_, n_tab, has_sapt,  \
                                 nb, cm_bs, tab_bs, box_bs, rcut2, alpha,    \
                                 conv);                                      \
    }
RS_PAIR_ENTRY(rs_pair_f32, float)
RS_PAIR_ENTRY(rs_pair_f64, double)

KERNELS_API const char* kernels_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
