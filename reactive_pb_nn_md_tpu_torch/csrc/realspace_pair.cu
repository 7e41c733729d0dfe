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
// kernel.  All three share pair_eval (erfc-Ewald + LJ / SAPT
// Buckingham-Tang-Toennies), so they compute one function.
//
// A: one warp per i slot; the lanes stride over the 27*ccap stencil
// candidates and the warp reduces the row, so each row is written once,
// with no atomics.  Every ordered pair is evaluated (energies carry 1/2).
// Bound on the H100: arithmetic (erfc, exp, divides) on the candidate
// pairs, ~15% of which are inside the cutoff; the candidates hit L1/L2.
//
// A' and A'' evaluate each unordered pair once: the self cell's strict
// upper triangle plus the 13 lexicographically positive neighbor cells
// (distinct for >= 3 cells an axis), which halves A's candidate math;
// the whole pair energy goes to the i row.  The j-side force partials
// need a reduction across i, which on the TPU is a column sum written to
// per-offset outputs.  Here a block runs one tile (ccap i slots x ccap j
// slots) at a time: one thread per pair stages the pair's force terms
// and energies in shared memory, then one thread per (row, value) sums
// the i side over j and one thread per (column, value) the j side over
// i, both in ascending order.  Every sum has a fixed order: the result
// is deterministic, with no atomics.
//  A'  : one block per cell; the j-side of offset k lands in a per-offset
//        array at the neighbor cell's slots (one writer per slot), and a
//        fold pass adds the 13 arrays to the cells' own rows.
//  A'' : one block per xy column walks the column's cells in z (the TPU
//        design's 5 column loads / 4 column outputs): the self column's
//        j-sides accumulate in the block's own rows, the other 12
//        offsets' in 4 per-neighbor-column accumulators in shared memory,
//        written once at the end and folded like A'.  z neighbors are
//        taken mod nc3 directly, so there are no ghost cells to fold.
//        100 blocks for the 10k box's (10, 10, 10) grid: fewer than the
//        132 SMs, which is the design's cost here (see PERF.md).
// Bound as A, on half the candidate pairs.
#include "common.cuh"

template <typename T>
struct PairConst {
    const T* stab;          // (n_tab, T, T) parameter tables, shared memory
    int T_, TT, has_sapt;
    T Lx, Ly, Lz, rcut2, alpha, conv, two_a_pi;
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
    P.rcut2 = rcut2;
    P.alpha = alpha;
    P.conv = conv;
    P.two_a_pi = (T)2.0 * alpha / (T)1.7724538509055160273;
    return P;
}

// Pair physics of slot i (position, charge, type, molecule) with packed
// slot pj.  False when the pair is not inter-molecular or outside the
// cutoff; else d = xi - xj under the minimum image, the force factors
// (dE/dxi = -s d) and the pair energies.
template <typename T>
__device__ __forceinline__ bool pair_eval(
        const T* __restrict__ pj, T xi, T yi, T zi, T qi, int ti, T moli,
        const PairConst<T>& P, T& dx, T& dy, T& dz, T& s_el, T& s_v,
        T& e_el, T& e_v) {
    const T molj = pj[5];
    if (molj < (T)0 || molj == moli) return false;
    dx = xi - pj[0];
    dy = yi - pj[1];
    dz = zi - pj[2];
    dx -= P.Lx * t_rint(dx * ((T)1 / P.Lx));
    dy -= P.Ly * t_rint(dy * ((T)1 / P.Ly));
    dz -= P.Lz * t_rint(dz * ((T)1 / P.Lz));
    const T r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 < P.rcut2)) return false;
    const T inv_r2 = (T)1 / r2;
    const T r = t_sqrt(r2);
    const T inv_r = (T)1 / r;
    // erfc-Ewald (pairwise_real_space_ewald)
    const T qq = qi * pj[3] * P.conv;
    const T ar = P.alpha * r;
    const T erfc_ar = t_erfc(ar);
    e_el = qq * erfc_ar * inv_r;
    s_el = qq * (erfc_ar * inv_r + P.two_a_pi * t_exp(-ar * ar)) * inv_r2;
    // vdW: LJ or SAPT Buckingham + Tang-Toennies
    const int tj = (int)t_rint(pj[4]);
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
    return true;
}

template <typename T>
__device__ __forceinline__ void load_tabs(const T* __restrict__ tabs, T* stab,
                                          int n) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) stab[k] = tabs[k];
}

template <typename T>
__global__ void rs_pair_kernel(const T* __restrict__ cm,
                               const T* __restrict__ tabs,
                               const T* __restrict__ box,
                               T* __restrict__ out,
                               int nc1, int nc2, int nc3, int ccap,
                               int T_, int n_tab, int has_sapt,
                               T rcut2, T alpha, T conv) {
    extern __shared__ unsigned char smem_raw[];
    T* stab = reinterpret_cast<T*>(smem_raw);
    load_tabs(tabs, stab, n_tab * T_ * T_);
    __syncthreads();
    const PairConst<T> P = pair_const(stab, box, T_, has_sapt, rcut2, alpha,
                                      conv);

    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int n_slots = nc1 * nc2 * nc3 * ccap;
    if (i >= n_slots) return;

    const T* own = cm + (size_t)i * 8;
    const T xi = own[0], yi = own[1], zi = own[2], qi = own[3];
    const int ti = (int)t_rint(own[4]);
    const T moli = own[5];
    const int c = i / ccap;
    const int c1 = c / (nc2 * nc3), c2 = (c / nc3) % nc2, c3 = c % nc3;

    T g[6] = {0, 0, 0, 0, 0, 0};
    T e_el = 0, e_vdw = 0;
    const int J = 27 * ccap;
    if (moli >= (T)0) {
        for (int jj = lane; jj < J; jj += 32) {
            const int k = jj / ccap;
            const int o1 = k / 9 - 1, o2 = (k / 3) % 3 - 1, o3 = k % 3 - 1;
            const int nb = (((c1 + o1 + nc1) % nc1) * nc2
                            + (c2 + o2 + nc2) % nc2) * nc3
                           + (c3 + o3 + nc3) % nc3;
            const int j = nb * ccap + (jj - k * ccap);
            if (j == i) continue;
            T dx, dy, dz, s_el, s_v, ee, ev;
            if (!pair_eval(cm + (size_t)j * 8, xi, yi, zi, qi, ti, moli, P,
                           dx, dy, dz, s_el, s_v, ee, ev))
                continue;
            e_el += ee;
            e_vdw += ev;
            g[0] -= s_el * dx; g[1] -= s_el * dy; g[2] -= s_el * dz;
            g[3] -= s_v * dx;  g[4] -= s_v * dy;  g[5] -= s_v * dz;
        }
    }
    for (int m = 0; m < 6; ++m) g[m] = warp_sum(g[m]);
    e_el = warp_sum(e_el);
    e_vdw = warp_sum(e_vdw);
    if (lane == 0) {
        T* o = out + (size_t)i * 8;
        for (int m = 0; m < 6; ++m) o[m] = g[m];
        o[6] = (T)0.5 * e_el;
        o[7] = (T)0.5 * e_vdw;
    }
}

// the half stencil: self first, then the 13 lexicographically positive
// offsets (_offsets(True) of the TPU kernel)
__constant__ int HALF_OFF[14][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, -1}, {0, 1, 0}, {0, 1, 1},
    {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
    {1, 0, 1}, {1, 1, -1}, {1, 1, 0}, {1, 1, 1}};

// pair results staged per tile chunk: PAIR_CAP pairs x 8 values
#define PAIR_CAP 768

// One tile of the half stencil: the ccap i slots of cell c against the
// ccap j slots of cell nb (self tile: only i < j), in chunks of i rows
// that fit PAIR_CAP pairs.  One thread per pair evaluates it and stages
// [s_el d (3), s_v d (3), e_el, e_v] in pg (shared); then one thread per
// (i row, value) sums its row over j in ascending order into irow[i*8 +
// m] (forces negated, energies whole), and one thread per (j slot, value)
// its column over i in ascending order into jout[j*jstride + m].  Fixed
// orders: deterministic, no atomics.
template <typename T>
__device__ void half_tile(const T* __restrict__ cm, int c, int nb, bool self,
                          int ccap, const PairConst<T>& P, T* irow, T* pg,
                          T* jout, int jstride) {
    const int ic_max = PAIR_CAP / ccap > 0 ? PAIR_CAP / ccap : 1;
    for (int i0 = 0; i0 < ccap; i0 += ic_max) {
        const int ic = ccap - i0 < ic_max ? ccap - i0 : ic_max;
        for (int t = threadIdx.x; t < ic * ccap; t += blockDim.x) {
            const int i = i0 + t / ccap, j = t % ccap;
            const T* pi = cm + ((size_t)c * ccap + i) * 8;
            T* g = pg + (size_t)t * 8;
            T dx, dy, dz, s_el, s_v, ee, ev;
            if (pi[5] >= (T)0 && (!self || i < j)
                && pair_eval(cm + ((size_t)nb * ccap + j) * 8, pi[0], pi[1],
                             pi[2], pi[3], (int)t_rint(pi[4]), pi[5], P, dx,
                             dy, dz, s_el, s_v, ee, ev)) {
                g[0] = s_el * dx; g[1] = s_el * dy; g[2] = s_el * dz;
                g[3] = s_v * dx;  g[4] = s_v * dy;  g[5] = s_v * dz;
                g[6] = ee;        g[7] = ev;
            } else {
                for (int m = 0; m < 8; ++m) g[m] = 0;
            }
        }
        __syncthreads();
        // rows, then columns (a self tile's columns are rows of irow too)
        const int n_row = ic * 8, n_col = ccap * 6;
        for (int t = threadIdx.x; t < n_row + (self ? 0 : n_col);
             t += blockDim.x) {
            if (t < n_row) {
                const int i = t / 8, m = t % 8;
                T sum = 0;
                for (int j = 0; j < ccap; ++j) sum += pg[(i * ccap + j) * 8 + m];
                irow[(i0 + i) * 8 + m] += m < 6 ? -sum : sum;
            } else {
                const int j = (t - n_row) / 6, m = (t - n_row) % 6;
                T sum = 0;
                for (int i = 0; i < ic; ++i) sum += pg[(i * ccap + j) * 8 + m];
                jout[j * jstride + m] += sum;
            }
        }
        if (self) {
            __syncthreads();
            for (int t = threadIdx.x; t < n_col; t += blockDim.x) {
                const int j = t / 6, m = t % 6;
                T sum = 0;
                for (int i = 0; i < ic; ++i) sum += pg[(i * ccap + j) * 8 + m];
                jout[j * jstride + m] += sum;
            }
        }
        __syncthreads();
    }
}

template <typename T>
__global__ void __launch_bounds__(256)
rs_half_kernel(const T* __restrict__ cm, const T* __restrict__ tabs,
               const T* __restrict__ box, T* __restrict__ own,
               T* __restrict__ part, int nc1, int nc2, int nc3, int ccap,
               int T_, int n_tab, int has_sapt, T rcut2, T alpha, T conv) {
    extern __shared__ unsigned char smem_raw[];
    const int n_tabv = n_tab * T_ * T_;
    T* stab = reinterpret_cast<T*>(smem_raw);
    T* irow = stab + n_tabv;                        // (ccap, 8)
    T* pg = irow + ccap * 8;                        // (PAIR_CAP, 8)
    load_tabs(tabs, stab, n_tabv);
    for (int k = threadIdx.x; k < ccap * 8; k += blockDim.x) irow[k] = 0;
    __syncthreads();
    const PairConst<T> P = pair_const(stab, box, T_, has_sapt, rcut2, alpha,
                                      conv);
    const int C8 = nc1 * nc2 * nc3 * ccap;
    const int c = blockIdx.x;
    const int c1 = c / (nc2 * nc3), c2 = (c / nc3) % nc2, c3 = c % nc3;
    half_tile(cm, c, c, true, ccap, P, irow, pg, irow, 8);
    for (int k = 1; k < 14; ++k) {
        const int nb = (((c1 + HALF_OFF[k][0] + nc1) % nc1) * nc2
                        + (c2 + HALF_OFF[k][1] + nc2) % nc2) * nc3
                       + (c3 + HALF_OFF[k][2] + nc3) % nc3;
        // part is zeroed by the wrapper; (k, nb) has this block alone
        half_tile(cm, c, nb, false, ccap, P, irow, pg,
                  part + ((size_t)(k - 1) * C8 + (size_t)nb * ccap) * 6, 6);
    }
    for (int k = threadIdx.x; k < ccap * 8; k += blockDim.x)
        own[(size_t)c * ccap * 8 + k] = irow[k];
}

template <typename T>
__global__ void __launch_bounds__(512)
rs_column_kernel(const T* __restrict__ cm, const T* __restrict__ tabs,
                 const T* __restrict__ box, T* __restrict__ own,
                 T* __restrict__ part, int nc1, int nc2, int nc3, int ccap,
                 int T_, int n_tab, int has_sapt, T rcut2, T alpha, T conv) {
    extern __shared__ unsigned char smem_raw[];
    const int n_tabv = n_tab * T_ * T_;
    const int zc = nc3 * ccap;
    T* stab = reinterpret_cast<T*>(smem_raw);
    T* fbuf = stab + n_tabv;                        // (nc3*ccap, 8)
    T* acc = fbuf + zc * 8;                         // (4, nc3*ccap, 6)
    T* pg = acc + 4 * zc * 6;                       // (PAIR_CAP, 8)
    load_tabs(tabs, stab, n_tabv);
    for (int k = threadIdx.x; k < zc * 8; k += blockDim.x) fbuf[k] = 0;
    for (int k = threadIdx.x; k < 4 * zc * 6; k += blockDim.x) acc[k] = 0;
    __syncthreads();
    const PairConst<T> P = pair_const(stab, box, T_, has_sapt, rcut2, alpha,
                                      conv);
    const int C8 = nc1 * nc2 * nc3 * ccap;
    const int p = blockIdx.x;
    const int c1 = p / nc2, c2 = p % nc2;
    for (int z = 0; z < nc3; ++z) {
        const int c = p * nc3 + z;
        T* irow = fbuf + z * ccap * 8;
        for (int k = 0; k < 14; ++k) {
            const int dx = HALF_OFF[k][0], dy = HALF_OFF[k][1];
            const int zz = (z + HALF_OFF[k][2] + nc3) % nc3;
            const int nb = (((c1 + dx + nc1) % nc1) * nc2
                            + (c2 + dy + nc2) % nc2) * nc3 + zz;
            // self column: its own rows; other columns: their accumulator
            // (dx, dy) = (0, 1), (1, -1), (1, 0), (1, 1) -> 0, 1, 2, 3
            const bool self_col = dx == 0 && dy == 0;
            const int m = dx == 0 ? 0 : dy + 2;
            T* jout = self_col ? fbuf + zz * ccap * 8
                               : acc + ((size_t)m * zc + zz * ccap) * 6;
            half_tile(cm, c, nb, k == 0, ccap, P, irow, pg, jout,
                      self_col ? 8 : 6);
        }
    }
    for (int k = threadIdx.x; k < zc * 8; k += blockDim.x)
        own[(size_t)p * zc * 8 + k] = fbuf[k];
    for (int m = 0; m < 4; ++m) {
        const int dx = m == 0 ? 0 : 1, dy = m == 0 ? 1 : m - 2;
        const int pm = ((c1 + dx + nc1) % nc1) * nc2 + (c2 + dy + nc2) % nc2;
        T* dst = part + ((size_t)m * C8 + (size_t)pm * zc) * 6;
        for (int k = threadIdx.x; k < zc * 6; k += blockDim.x)
            dst[k] = acc[(size_t)m * zc * 6 + k];
    }
}

// out[s] = own[s] + sum_k part[k][s] (forces; energies are own's)
template <typename T>
__global__ void rs_fold_kernel(const T* __restrict__ own,
                               const T* __restrict__ part,
                               T* __restrict__ out, int C8, int n_part) {
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
                          int ccap, int T_, int n_tab, int has_sapt,
                          double rcut2, double alpha, double conv) {
    const int n_slots = nc1 * nc2 * nc3 * ccap;
    const int threads = 256;                    // 8 warps = 8 slots
    const int blocks = (n_slots * 32 + threads - 1) / threads;
    const size_t shm = (size_t)n_tab * T_ * T_ * sizeof(T);
    rs_pair_kernel<T><<<blocks, threads, shm, (cudaStream_t)stream>>>(
        (const T*)cm, (const T*)tabs, (const T*)box, (T*)out, nc1, nc2, nc3,
        ccap, T_, n_tab, has_sapt, (T)rcut2, (T)alpha, (T)conv);
    return (int)cudaGetLastError();
}

template <typename T>
static int rs_half_launch(int column, const void* cm, const void* tabs,
                          const void* box, void* own, void* part, void* out,
                          void* stream, int nc1, int nc2, int nc3, int ccap,
                          int T_, int n_tab, int has_sapt, double rcut2,
                          double alpha, double conv) {
    // the layouts of rs_column_kernel / rs_half_kernel (the wrapper checks
    // the same sizes against the SM's limit)
    const size_t n_tabv = (size_t)n_tab * T_ * T_;
    const size_t shm = (column ? n_tabv + (size_t)nc3 * ccap * (8 + 4 * 6)
                                       + PAIR_CAP * 8
                               : n_tabv + (size_t)ccap * 8 + PAIR_CAP * 8)
                       * sizeof(T);
    cudaStream_t s = (cudaStream_t)stream;
    int err;
    if (column) {
        err = allow_smem((const void*)rs_column_kernel<T>, shm);
        if (err) return err;
        rs_column_kernel<T><<<nc1 * nc2, 512, shm, s>>>(
            (const T*)cm, (const T*)tabs, (const T*)box, (T*)own, (T*)part,
            nc1, nc2, nc3, ccap, T_, n_tab, has_sapt, (T)rcut2, (T)alpha,
            (T)conv);
    } else {
        err = allow_smem((const void*)rs_half_kernel<T>, shm);
        if (err) return err;
        rs_half_kernel<T><<<nc1 * nc2 * nc3, 256, shm, s>>>(
            (const T*)cm, (const T*)tabs, (const T*)box, (T*)own, (T*)part,
            nc1, nc2, nc3, ccap, T_, n_tab, has_sapt, (T)rcut2, (T)alpha,
            (T)conv);
    }
    err = (int)cudaGetLastError();
    if (err) return err;
    const int C8 = nc1 * nc2 * nc3 * ccap;
    rs_fold_kernel<T><<<(C8 * 8 + 255) / 256, 256, 0, s>>>(
        (const T*)own, (const T*)part, (T*)out, C8, column ? 4 : 13);
    return (int)cudaGetLastError();
}

#define RS_ENTRY(NAME, CALL, T)                                              \
    KERNELS_API int NAME(const void* cm, const void* tabs, const void* box, \
                         void* own, void* part, void* out, void* stream,     \
                         int nc1, int nc2, int nc3, int ccap, int T_,        \
                         int n_tab, int has_sapt, double rcut2,              \
                         double alpha, double conv) {                        \
        return rs_half_launch<T>(CALL, cm, tabs, box, own, part, out,        \
                                 stream, nc1, nc2, nc3, ccap, T_, n_tab,     \
                                 has_sapt, rcut2, alpha, conv);              \
    }
RS_ENTRY(rs_half_f32, 0, float)
RS_ENTRY(rs_half_f64, 0, double)
RS_ENTRY(rs_column_f32, 1, float)
RS_ENTRY(rs_column_f64, 1, double)

KERNELS_API int rs_pair_f32(const void* cm, const void* tabs,
                            const void* box, void* out, void* stream,
                            int nc1, int nc2, int nc3, int ccap, int T_,
                            int n_tab, int has_sapt, double rcut2,
                            double alpha, double conv) {
    return rs_pair_launch<float>(cm, tabs, box, out, stream, nc1, nc2, nc3,
                               ccap, T_, n_tab, has_sapt, rcut2, alpha,
                               conv);
}

KERNELS_API int rs_pair_f64(const void* cm, const void* tabs,
                            const void* box, void* out, void* stream,
                            int nc1, int nc2, int nc3, int ccap, int T_,
                            int n_tab, int has_sapt, double rcut2,
                            double alpha, double conv) {
    return rs_pair_launch<double>(cm, tabs, box, out, stream, nc1, nc2, nc3,
                               ccap, T_, n_tab, has_sapt, rcut2, alpha,
                               conv);
}

KERNELS_API const char* kernels_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
