// Kernel A: inter-molecular real-space pair sweep over a static cell grid.
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/realspace_pair.py:_kernel /
// _pair_math on its full 27-stencil path.  Input: the cell-packed atom
// array cm (n_cells*ccap, 8) row-major [x y z q type mol 0 0]; empty
// slots hold a sentinel position and mol = -1.  Output: per slot
// [dE_el/dx (3), dE_vdw/dx (3), e_el/2, e_vdw/2] -- analytic gradients
// come out of the forward sweep, so the backward needs no kernel.
//
// One warp per i slot; the lanes stride over the 27*ccap stencil
// candidates and the warp reduces the row, so each row is written once,
// with no atomics.  Every ordered pair is evaluated (energies carry 1/2).
// The (n_tab, T, T) parameter tables sit in shared memory.
//
// Bound on the H100: arithmetic (erfc, exp, divides) on ~1M candidate
// pairs per call at the flagship box, of which ~15% are inside the
// cutoff; the candidate loads hit L1/L2 (the whole packed array is 49 KB
// in fp32).  A later version can evaluate each unordered pair once.
#include "common.cuh"

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
    const int TT = T_ * T_;
    for (int k = threadIdx.x; k < n_tab * TT; k += blockDim.x)
        stab[k] = tabs[k];
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int n_slots = nc1 * nc2 * nc3 * ccap;
    if (i >= n_slots) return;

    const T Lx = box[0], Ly = box[4], Lz = box[8];   // orthorhombic box
    const T* own = cm + (size_t)i * 8;
    const T xi = own[0], yi = own[1], zi = own[2], qi = own[3];
    const int ti = (int)t_rint(own[4]);
    const T moli = own[5];
    const int c = i / ccap;
    const int c1 = c / (nc2 * nc3), c2 = (c / nc3) % nc2, c3 = c % nc3;
    const T two_a_pi = (T)2.0 * alpha / (T)1.7724538509055160273;

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
            const T* pj = cm + (size_t)j * 8;
            const T molj = pj[5];
            if (molj < (T)0 || molj == moli) continue;
            T dx = xi - pj[0], dy = yi - pj[1], dz = zi - pj[2];
            dx -= Lx * t_rint(dx * ((T)1 / Lx));
            dy -= Ly * t_rint(dy * ((T)1 / Ly));
            dz -= Lz * t_rint(dz * ((T)1 / Lz));
            const T r2 = dx * dx + dy * dy + dz * dz;
            if (!(r2 < rcut2)) continue;
            const T inv_r2 = (T)1 / r2;
            const T r = t_sqrt(r2);
            const T inv_r = (T)1 / r;
            // erfc-Ewald (pairwise_real_space_ewald)
            const T qq = qi * pj[3] * conv;
            const T ar = alpha * r;
            const T erfc_ar = t_erfc(ar);
            e_el += qq * erfc_ar * inv_r;
            const T s_el = qq * (erfc_ar * inv_r + two_a_pi * t_exp(-ar * ar))
                           * inv_r2;
            // vdW: LJ or SAPT Buckingham + Tang-Toennies
            const int tj = (int)t_rint(pj[4]);
            const int p = ti * T_ + tj;
            const T vt = stab[p];
            const T c12 = stab[TT + p], c6 = stab[2 * TT + p];
            T ev = 0, s_v = 0;
            if (vt == (T)0) {
                const T inv_r6 = inv_r2 * inv_r2 * inv_r2;
                const T inv_r12 = inv_r6 * inv_r6;
                ev = c12 * inv_r12 - c6 * inv_r6;
                s_v = ((T)12 * c12 * inv_r12 - (T)6 * c6 * inv_r6) * inv_r2;
            } else if (has_sapt && vt == (T)1) {
                const T A = stab[3 * TT + p], B = stab[4 * TT + p];
                const T Cs[4] = {c6, stab[5 * TT + p], stab[6 * TT + p],
                                 stab[7 * TT + p]};
                T x_tt = B * r;
                if (x_tt > (T)40) x_tt = (T)40;
                const T ex = t_exp(-x_tt);
                ev = A * ex;
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
                        ev -= fn * Cn * inv_rn;
                        s_v += (B * dfn * Cn * inv_rn
                                - (T)n * fn * Cn * inv_rn * inv_r) * inv_r;
                        inv_rn *= inv_r2;
                    }
                }
            }
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
