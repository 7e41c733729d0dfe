// Kernel E: the ground eigenpair of the EVB Hamiltonian, in fp64:
// Householder tridiagonalization, Sturm-count multisection for lambda_0,
// inverse iteration for c_0, the back-transform.
//
// No TPU kernel: the JAX package takes the ground state outside Pallas,
// jnp.linalg.eigh of H - H00 I (reactive_pb_nn_md_tpu/ops/ground_state.py:
// ground_state_eigh).  The port needs a kernel because torch.linalg.eigh
// checks its info on the host (a synchronization), which a CUDA graph
// capture refuses.
//
// One block of GS_THREADS threads solves A = H - H00 I (S x S, symmetric)
// whatever H's type, in fp64, for the lowest eigenpair alone:
//  0. The active block: rows past the last one with an off-diagonal
//     element (the parked states) are decoupled, so the method runs on
//     the leading nact x nact block, and a parked diagonal below that
//     block's lowest eigenvalue is the answer itself (c a unit vector).
//  1. Tridiagonalization, nact - 2 reflections H_k = I - tau v v^T
//     (LAPACK dlarfg: v_{k+1} = 1), T = Q^T A Q.  A reflection: p = tau A v
//     by parts (lane l a trailing row, warp 0 column k+1, warps 1.. even
//     segments of the other columns), three barriers: the parts, then p
//     and each warp's part of v^T p, then A -= v w^T + w v^T (w = p -
//     (tau/2)(v^T p) v; both triangles, the two products unfused, so A
//     stays symmetric bit for bit), after which warp 0, which updated
//     column k+1 alone, forms the next reflector from it (a butterfly
//     for its norm, a sqrt and two divides) while the others wait.  v
//     overwrites the column it eliminated, which nothing reads again.  A
//     column already reduced (tau = 0) costs its reflector alone.
//  2. lambda_0 by multisection on T (GS_MS_THREADS threads, a shift
//     each): from the Gershgorin interval of the lowest eigenvalue, each
//     thread tests whether T - x I has a non-positive LDL^T pivot (Sturm:
//     x >= lambda_0) by the leading minors' three-term recurrence, a
//     multiply-add a step and no divide; the interval narrows to the gap
//     between the last shift without one and the first with one (a
//     ballot, no atomics), 129x a round, until it is 4 eps max|bound|
//     wide: at most 8 rounds from any interval, GS_MAX_ROUNDS allowed.
//     lambda_0 is the interval's midpoint (not a Rayleigh quotient).
//     Meanwhile the other warps form the reflectors' Gram products for
//     step 4.
//  3. c_0 by inverse iteration on T at lambda_0 (warp 0): LU of the
//     tridiagonal T - lambda_0 I with partial pivoting (LAPACK dgttrf,
//     lane 0; a pivot below eps max|bound| raised to it, the pivots'
//     reciprocals by the lanes), GS_SOLVES solves by lane 0 from a fixed
//     start (a Weyl sequence), each from the last one's result over its
//     largest element.
//  4. The residual ||(T - lambda_0 I) y||_inf against 16 nact eps
//     ||T||_inf ||y||_inf, then c = H_0 ... H_{nact-3} y (warp 0, y in
//     registers): GS_GB reflectors at once, their dot products with y in
//     one interleaved butterfly, each corrected by the Gram products of
//     the ones applied before it.
// *info = the multisection rounds (0..GS_MAX_ROUNDS), or -1 when the
// interval did not close, the residual is above its bound or a value is
// not finite (the caller raises).  Nothing is atomic and every sum has a
// fixed order: two calls give the same bits.  The cost does not depend on
// the spectrum (cyclic Jacobi, this kernel's first method, needed more
// sweeps near a degeneracy); it grows with nact.
//
// Output in H's type: lambda_0 + H00 and c_0 / ||c_0||_2 with the largest
// |c_i| positive (the first such i); c is 0 on the parked rows.
//
// Memory: A in shared memory up to S = GS_SMEM_MAX_S (80 x 81 x 8 B =
// 52 KB), else in the caller's scratch (S ld doubles) in device memory;
// rows padded to an odd length ld, so that lanes walking a column meet no
// bank twice in a half warp; T, tau, p, the LU, y, the warps' parts of p
// (or the Gram products) always in shared memory (18 S doubles, S ints).
// Bound: the function's work is H in, (lambda, c) out and the (4/3) S^3
// flops of the tridiagonalization, the rest O(S^2): bytes win at S = 48
// (~5.6e-6 ms).  The kernel is a latency chain: a reflection's three
// barriers, two butterflies, a sqrt and a divide; the multisection's
// nact-long recurrences; the LU's divides and the solves' multiply-adds
// in one thread.
#include "common.cuh"

constexpr int GS_THREADS = 256;
constexpr int GS_MS_THREADS = 128;  // the multisection's: a shift each
constexpr int GS_GB = 8;            // reflectors a block of the back-transform
constexpr int GS_SMEM_MAX_S = 80;
constexpr int GS_MAX_ROUNDS = 10;
constexpr int GS_SOLVES = 3;
constexpr double GS_EPS = 2.220446049250313e-16;     // 2^-52
constexpr double GS_DBL_MAX = 1.7976931348623157e308;
constexpr double GS_GOLDEN = 0.6180339887498949;

__device__ __forceinline__ double warp_allmax(double v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ double warp_allmin(double v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// Whether T - x I (diagonal d, squared off-diagonal e2) has a
// non-positive LDL^T pivot, i.e. x >= lambda_0.  The pivots are the
// ratios q_i = p_i / p_{i-1} of the leading minors, p_i = (d_i - x)
// p_{i-1} - e2_{i-1} p_{i-2}: a multiply-add a step, no divide (each
// computed q_i is the ratio recurrence's with its coefficients perturbed
// by a few ulps); while every pivot so far is positive, p_{i-1} > 0 and
// q_i <= 0 is p_i <= 0.  Every fourth step p is rescaled by 2^-600
// (2^600) when it has left [2^-600, 2^600]: four steps of |d - x| + e2
// <= 2^100 cannot reach the ends of the double range.  Every step runs:
// once a pivot is non-positive the later ones do not matter.
__device__ __forceinline__ bool gs_sturm_negative(
        const double* d, const double* e2, int S, double x) {
    double p0 = 1.0, p1 = d[0] - x;
    bool neg = p1 <= 0.0;
    int i = 1;
    for (; i + 3 < S; i += 4) {
        // four steps, their inputs loaded first, then the rescale
        double di[4], ei[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            di[u] = d[i + u];
            ei[u] = e2[i + u - 1];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const double p2 = fma(di[u] - x, p1, -ei[u] * p0);
            neg |= p2 <= 0.0;
            p0 = p1;
            p1 = p2;
        }
        const double m = fmax(fabs(p0), fabs(p1));
        if (m > 0x1p600 || m < 0x1p-600) {
            const double f = m > 1.0 ? 0x1p-600 : 0x1p600;
            p0 *= f;
            p1 *= f;
        }
    }
    for (; i < S; ++i) {
        const double p2 = fma(d[i] - x, p1, -e2[i - 1] * p0);
        neg |= p2 <= 0.0;
        p0 = p1;
        p1 = p2;
    }
    return neg;
}

// LAPACK dlarfg on x = (x0, rest), ||rest||^2 = sig: H = I - t v v^T with
// v = (1, rest * scal) takes x to (beta, 0..0); t = 0 (H = I) when rest
// is 0.
__device__ __forceinline__ void gs_householder(double x0, double sig,
                                               double& t, double& beta,
                                               double& scal) {
    t = 0.0;
    beta = x0;
    scal = 0.0;
    if (sig != 0.0) {
        const double mu = sqrt(fma(x0, x0, sig));
        beta = x0 >= 0.0 ? -mu : mu;
        t = (beta - x0) / beta;
        scal = 1.0 / (x0 - beta);
    }
}

// The reflector of column k (warp 0): H_k = I - tau v v^T zeroes A's
// column k below row k + 1 (gs_householder); d_k, e_k = beta and tau_k
// into T, v_j (j >= k + 2) over x_j in A's column k (no later reflection
// reads it, and no other warp writes it: it is warp 0's column of the
// update before), tau into *refl.
__device__ __forceinline__ void gs_reflector(
        double* A, int ld, int k, int nact, double* d, double* e,
        double* tau, double* refl) {
    const int lane = threadIdx.x & 31;
    double sig = 0.0;
    for (int i = k + 2 + lane; i < nact; i += 32) {
        const double a = A[i * ld + k];
        sig = fma(a, a, sig);
    }
    sig = warp_allsum(sig);
    const double x0 = A[(k + 1) * ld + k];
    double t, beta, scal;
    gs_householder(x0, sig, t, beta, scal);
    for (int i = k + 2 + lane; i < nact; i += 32)
        A[i * ld + k] *= scal;
    if (lane == 0) {
        d[k] = A[k * ld + k];
        e[k] = beta;
        tau[k] = t;
        refl[0] = t;
    }
}

// Warp 0's part of the update of reflection k (column k1 = k + 1, all
// rows: A(i, k1) -= v_i w_k1 + w_i, w = W - K v) and, when reflection k1
// follows, its reflector (gs_reflector) from the new column held in
// registers; lane l has the rows k1 + l + 32 m, m < JR.
template <int JR>
__device__ __forceinline__ void gs_column_reflector(
        double* A, int ld, int k, int nact, const double* W, double K,
        double* d, double* e, double* tau, double* refl) {
    const int lane = threadIdx.x & 31, k1 = k + 1;
    const double wk1 = W[k1] - K;
    double a[JR], sig = 0.0;
#pragma unroll
    for (int m = 0; m < JR; ++m) {
        const int i = k1 + lane + 32 * m;
        a[m] = 0.0;
        if (i < nact) {
            const double vi = i == k1 ? 1.0 : A[i * ld + k];
            const double wi = W[i] - K * vi;
            a[m] = A[i * ld + k1] - (t_mul(vi, wk1) + t_mul(wi, 1.0));
            A[i * ld + k1] = a[m];
            if (i >= k1 + 2) sig = fma(a[m], a[m], sig);
        }
    }
    if (k1 + 2 >= nact) return;             // no reflection k1
    sig = warp_allsum(sig);
    const double x0 = __shfl_sync(0xffffffffu, a[0], 1);
    double t, beta, scal;
    gs_householder(x0, sig, t, beta, scal);
#pragma unroll
    for (int m = 0; m < JR; ++m) {
        const int i = k1 + lane + 32 * m;
        if (i >= k1 + 2 && i < nact) A[i * ld + k1] = a[m] * scal;
    }
    if (lane == 0) {
        d[k1] = a[0];
        e[k1] = beta;
        tau[k1] = t;
        *refl = t;
    }
}

// Kernel E at S (see the top of the file).  JR: the rows (elements) a
// lane holds in registers in warp 0's column of the update and in the
// back-transform, when nact <= 32 JR; past that both take slower paths
// through memory.
// A batched launch (a replica batch of the vmapped step) runs one block a
// replica: block b solves H + b h_bs (h_bs 0: one H for all) into its own
// lambda, c, info and scratch, by the same arithmetic as its own launch.
template <typename T, int JR>
__global__ void __launch_bounds__(GS_THREADS, 1)
ground_state_kernel(const T* __restrict__ H, T* __restrict__ lam_out,
                    T* __restrict__ c_out, int* __restrict__ info_out,
                    double* __restrict__ scratch, int S, int h_bs) {
    {
        const size_t rep = blockIdx.x;
        H += rep * h_bs;
        lam_out += rep;
        c_out += rep * S;
        info_out += rep;
        scratch += rep * (size_t)(S <= GS_SMEM_MAX_S ? 0 : S * (S | 1));
    }
    extern __shared__ double smem[];
    // the warps' last coupled rows, then the lowest parked row
    __shared__ int red_i[GS_THREADS / 32 + 1];
    // the multisection's rounds: the first lane of each 32 shifts that
    // has a non-positive pivot, two buffers (one barrier a round)
    __shared__ int first_neg[2][GS_MS_THREADS / 32];
    // lo, hi, tol, ||T||_inf, the lowest parked diagonal
    __shared__ double bnd[5];
    // the reflectors' tau, two buffers (reflection k reads k & 1)
    __shared__ double refl[2];
    __shared__ double vpw[GS_THREADS / 32];     // the warps' parts of v^T p
    const int ld = S | 1;           // odd: a column's doubles hit 16 banks
    const bool in_smem = S <= GS_SMEM_MAX_S;
    double* A = in_smem ? smem : scratch;
    double* vec = in_smem ? smem + (size_t)S * ld : smem;
    double* d = vec;                // T's diagonal
    double* e = d + S;              // T's off-diagonal
    double* e2 = e + S;
    double* tau = e2 + S;
    double* W = tau + S;            // p of the current reflection
    double* rd = W + S;             // LU of T - lambda_0 I: the pivots'
    double* dl = rd + S;            // reciprocals, multipliers,
    double* du = dl + S;            // first and
    double* du2 = du + S;           // second superdiagonals
    double* y = du2 + S;
    double* Pw = y + S;             // the warps' parts of p (nw S)
    int* swapped = (int*)(Pw + (size_t)(GS_THREADS / 32) * S);
    const int tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const double h00 = (double)H[0];

    // A, and the active block: rows >= nact have no off-diagonal element
    // (parked states), so T there is their diagonal and the reflections
    // run on the leading nact x nact block alone
    int last = -1;
    for (int i = warp; i < S; i += nw)
        for (int j = lane; j < S; j += 32) {
            const double a = (double)H[i * S + j];
            A[i * ld + j] = a - (i == j ? h00 : 0.0);
            if (i != j && a != 0.0) last = max(last, max(i, j));
        }
    for (int o = 16; o > 0; o >>= 1)
        last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    if (lane == 0) red_i[warp] = last;
    __syncthreads();
    int nact = 0;
    for (int w = 0; w < nw; ++w) nact = max(nact, red_i[w] + 1);

    // 1. Householder: reflection k zeroes column k below its subdiagonal.
    // Lane l takes the trailing rows k1 + l + 32 m, warp 0 the trailing
    // column k1, warp w > 0 a segment of the rest; warp 0 forms each
    // reflector and, after its column of the update, the next (one step,
    // the column in registers, when warp 0's rows fit: fused).
    const bool fused = nact <= 32 * JR;
    if (warp == 0 && nact > 2) gs_reflector(A, ld, 0, nact, d, e, tau, refl);
    __syncthreads();
    for (int k = 0; k + 2 < nact; ++k) {
        const int k1 = k + 1, n = nact - k1;
        const double t = refl[k & 1];
        const double* vk = A + k;           // v_j = vk[j ld], j >= k + 2
        if (t != 0.0) {                     // the same in every thread
            // warp 0 takes column k1 alone (it forms the next reflector
            // from it), warps 1.. the rest in even segments
            const int cs = (n - 1 + nw - 2) / (nw - 1);
            const int c0 = warp == 0 ? k1 : k1 + 1 + (warp - 1) * cs;
            const int c1 = warp == 0 ? k1 + 1 : min(c0 + cs, nact);
            // p's parts: warp w's columns of A v
            for (int i = k1 + lane; i < nact; i += 32) {
                const double* Ai = A + i * ld;
                double acc = 0.0;
                for (int j = c0; j < c1; ++j)
                    acc = fma(Ai[j], j == k1 ? 1.0 : vk[j * ld], acc);
                Pw[warp * S + i] = acc;
            }
            __syncthreads();
            // p = tau A v, warp w its rows k1 + 32 w + l (+ 32 nw m), and
            // its part of v^T p
            double vp = 0.0;
            for (int i = k1 + 32 * warp + lane; i < nact; i += 32 * nw) {
                double a = 0.0;
                for (int w = 0; w < nw; ++w) a += Pw[w * S + i];
                const double pi = t * a;
                W[i] = pi;
                vp = fma(i == k1 ? 1.0 : vk[i * ld], pi, vp);
            }
            vp = warp_allsum(vp);
            if (lane == 0) vpw[warp] = vp;
            __syncthreads();
            // K = (tau / 2) v^T p (the parts in a fixed order: the same
            // bits in every thread); A -= v w^T + w v^T, w = p - K v, on
            // warp w's columns (the whole trailing block: both triangles,
            // the two products unfused, so A stays symmetric bit for bit)
            vp = 0.0;
            for (int w = 0; w < nw; ++w) vp += vpw[w];
            const double K = 0.5 * t * vp;
            if (warp == 0 && fused) {
                // column k1, its new values in registers, then the next
                // reflector from them (no store and load between)
                gs_column_reflector<JR>(A, ld, k, nact, W, K, d, e, tau,
                                        refl + (k1 & 1));
            } else {
                for (int i = k1 + lane; i < nact; i += 32) {
                    const double vi = i == k1 ? 1.0 : vk[i * ld];
                    const double wi = W[i] - K * vi;
                    double* Ai = A + i * ld;
                    for (int j = c0; j < c1; ++j) {
                        const double vj = j == k1 ? 1.0 : vk[j * ld];
                        Ai[j] -= t_mul(vi, W[j] - K * vj) + t_mul(wi, vj);
                    }
                }
            }
        }
        if (warp == 0 && k + 3 < nact && !(fused && t != 0.0)) {
            __syncwarp();
            gs_reflector(A, ld, k1, nact, d, e, tau, refl + (k1 & 1));
        }
        __syncthreads();
    }

    // T of the active block: its last entries; e^2 and lambda_0's
    // Gershgorin interval; the lowest parked diagonal (warp 0)
    if (warp == 0) {
        for (int i = max(nact - 2, 0) + lane; i < nact; i += 32) {
            d[i] = A[i * ld + i];
            e[i] = i + 1 < nact ? A[(i + 1) * ld + i] : 0.0;
            tau[i] = 0.0;
        }
        double pm = INFINITY;
        int pi = S;
        for (int i = nact + lane; i < S; i += 32)
            if (A[i * ld + i] < pm) {
                pm = A[i * ld + i];
                pi = i;
            }
        for (int o = 16; o > 0; o >>= 1) {
            const double p2 = __shfl_xor_sync(0xffffffffu, pm, o);
            const int i2 = __shfl_xor_sync(0xffffffffu, pi, o);
            if (p2 < pm || (p2 == pm && i2 < pi)) {
                pm = p2;
                pi = i2;
            }
        }
        __syncwarp();
        double tn = 0.0, glo = INFINITY, dmin = INFINITY;
        for (int i = lane; i < nact; i += 32) {
            const double em = i > 0 ? fabs(e[i - 1]) : 0.0;
            const double ep = fabs(e[i]);
            e2[i] = e[i] * e[i];
            tn = fmax(tn, fabs(d[i]) + em + ep);
            glo = fmin(glo, d[i] - em - ep);
            dmin = fmin(dmin, d[i]);
        }
        tn = warp_allmax(tn);
        glo = warp_allmin(glo);
        dmin = warp_allmin(dmin);
        if (lane == 0) {
            const double fudge = 2.1 * nact * GS_EPS * tn;
            const double lo = glo - fudge, hi = dmin + fudge;
            bnd[0] = lo;
            bnd[1] = hi;
            bnd[2] = 4.0 * GS_EPS * fmax(fabs(lo), fabs(hi));
            bnd[3] = tn;
            bnd[4] = pm;
            red_i[GS_THREADS / 32] = pi;
        }
    }
    __syncthreads();
    // the back-transform goes GS_GB reflectors at once when y fits in
    // registers: the other warps form the reflectors' Gram products
    // G[k][m] = v_k^T v_{k+m} (0 < m < GS_GB) in Pw meanwhile, and arrive
    // at barrier 2, where warp 0 waits for them before it
    const bool gram = nact >= 3 && nact <= 32 * JR;
    if (tid >= GS_MS_THREADS) {
        if (gram) {
            for (int q = tid - GS_MS_THREADS; q < (nact - 2) * (GS_GB - 1);
                 q += GS_THREADS - GS_MS_THREADS) {
                const int k = q / (GS_GB - 1), m = q % (GS_GB - 1) + 1;
                if (k + m > nact - 3) continue;
                const double* vk = A + k;
                const double* vm = A + k + m;
                double g = vk[(k + m + 1) * ld];
                for (int j = k + m + 2; j < nact; ++j)
                    g = fma(vk[j * ld], vm[j * ld], g);
                Pw[q] = g;
            }
            asm volatile("bar.arrive 2, %0;" ::"n"(GS_THREADS - GS_MS_THREADS
                                                    + 32) : "memory");
        }
        return;
    }

    // 2. multisection on the active block, the first GS_MS_THREADS
    // threads: thread t tests lo + (t + 1) h, h = (hi - lo) /
    // (GS_MS_THREADS + 1)
    double lo = bnd[0], hi = bnd[1];
    const double tol = bnd[2], tnorm = bnd[3];
    int rounds = 0;
    while (nact > 0 && hi - lo > tol && rounds < GS_MAX_ROUNDS) {
        const double h = (hi - lo) / (double)(GS_MS_THREADS + 1);
        const bool neg = gs_sturm_negative(d, e2, nact,
                                           lo + h * (double)(tid + 1));
        const unsigned b = __ballot_sync(0xffffffffu, neg);
        int* fn = first_neg[rounds & 1];
        if (lane == 0) fn[warp] = b ? __ffs(b) - 1 : 32;
        asm volatile("bar.sync 1, %0;" ::"n"(GS_MS_THREADS) : "memory");
        int ts = GS_MS_THREADS;
        for (int w = 0; w < GS_MS_THREADS / 32; ++w)
            if (fn[w] < 32) {
                ts = w * 32 + fn[w];
                break;
            }
        if (ts < GS_MS_THREADS) {
            hi = lo + h * (double)(ts + 1);
            if (ts > 0) lo = lo + h * (double)ts;
        } else {
            lo = lo + h * (double)GS_MS_THREADS;
        }
        ++rounds;
    }
    const bool closed = nact == 0 || hi - lo <= tol;
    // a parked state below the active block's lowest eigenvalue is the
    // ground state itself (rows >= nact are decoupled)
    const double pm = bnd[4];
    const int pidx = red_i[GS_THREADS / 32];
    const bool parked = nact == 0 || pm < lo + 0.5 * (hi - lo);
    const bool blocked = !parked && gram;
    if (warp != 0) return;
    if (parked) {
        for (int i = lane; i < S; i += 32)
            c_out[i] = (T)(i == pidx ? 1.0 : 0.0);
        if (lane == 0) {
            lam_out[0] = (T)(pm + h00);
            info_out[0] = closed ? rounds : -1;
        }
        return;
    }
    const double lam = lo + 0.5 * (hi - lo);
    const int N = nact;

    // 3. inverse iteration on the active block's T at lambda_0: the start
    // vector by the lanes, the LU's recurrence by lane 0 (carried values
    // in registers, the next step's inputs loaded before this step's
    // stores), the pivots' reciprocals by the lanes, the solves by lane 0
    // (a multiply-add chain, inputs loaded a step ahead)
    const double scale = fmax(fabs(bnd[0]), fabs(bnd[1]));
    const double ptol = scale > 0.0 ? GS_EPS * scale : 1.0;
    for (int i = lane; i < N; i += 32) {
        du2[i] = 0.0;
        swapped[i] = 0;
        y[i] = 2.0 * fmod((double)(i + 1) * GS_GOLDEN, 1.0) - 1.0;
    }
    __syncwarp();
    if (lane == 0) {
        // LAPACK dgttrf on (e, d - lambda_0, e)
        double di = d[0] - lam, ui = e[0];
        double li = e[0], dn = N > 1 ? d[1] - lam : 0.0, un = e[N > 1];
        for (int i = 0; i + 1 < N; ++i) {
            const double li1 = e[i + 1];
            const double dn1 = i + 2 < N ? d[i + 2] - lam : 0.0;
            const double un1 = i + 2 < N ? e[i + 2] : 0.0;
            if (fabs(di) >= fabs(li)) {
                const double f = di != 0.0 ? li / di : 0.0;
                rd[i] = di;
                dl[i] = f;
                du[i] = ui;
                di = dn - f * ui;
                ui = un;
            } else {
                const double f = di / li;
                rd[i] = li;
                dl[i] = f;
                du[i] = dn;
                du2[i] = un;
                swapped[i] = 1;
                di = ui - f * dn;
                ui = -f * un;
            }
            li = li1;
            dn = dn1;
            un = un1;
        }
        rd[N - 1] = di;
        du[N - 1] = 0.0;
    }
    __syncwarp();
    for (int i = lane; i < N; i += 32) {
        const double p = fabs(rd[i]) < ptol ? copysign(ptol, rd[i]) : rd[i];
        rd[i] = 1.0 / p;
    }
    __syncwarp();
    if (lane == 0) {
        double inv = 1.0;
        for (int s = 0; s < GS_SOLVES; ++s) {
            // L: b(i+1) -= l_i b(i), rows i and i+1 swapped first where
            // the LU swapped them
            double cur = y[0] * inv;
            double nxt = N > 1 ? y[1] * inv : 0.0;
            double li = dl[0];
            int sw = swapped[0];
            for (int i = 0; i + 1 < N; ++i) {
                const double nxt1 = i + 2 < N ? y[i + 2] * inv : 0.0;
                const double li1 = dl[i + 1];
                const int sw1 = swapped[i + 1];
                if (sw) {
                    y[i] = nxt;
                    cur = cur - li * nxt;
                } else {
                    y[i] = cur;
                    cur = nxt - li * cur;
                }
                nxt = nxt1;
                li = li1;
                sw = sw1;
            }
            y[N - 1] = cur;
            // U: y(i) = (b(i) - u_i y(i+1) - u2_i y(i+2)) / pivot_i
            double y1 = 0.0, y2 = 0.0, big = 0.0;
            double bi = y[N - 1], ui = du[N - 1], u2i = du2[N - 1],
                   ri = rd[N - 1];
            for (int i = N - 1; i >= 0; --i) {
                const int i1 = i > 0 ? i - 1 : 0;
                const double bn = y[i1], un = du[i1], u2n = du2[i1],
                             rn = rd[i1];
                const double r = (bi - ui * y1 - u2i * y2) * ri;
                y[i] = r;
                y2 = y1;
                y1 = r;
                big = fmax(big, fabs(r));
                bi = bn;
                ui = un;
                u2i = u2n;
                ri = rn;
            }
            inv = 1.0 / big;
        }
    }
    __syncwarp();

    // 4. residual on T (a value that is not finite fails it), then the
    // back-transform, normalization, sign (warp 0)
    double big = 0.0;
    for (int i = lane; i < N; i += 32) big = fmax(big, fabs(y[i]));
    big = warp_allmax(big);
    const double rbound = 16.0 * N * GS_EPS * tnorm * big;
    bool bad = !closed || !(big > 0.0);
    for (int i = lane; i < N; i += 32) {
        double r = (d[i] - lam) * y[i];
        if (i > 0) r += e[i - 1] * y[i - 1];
        if (i + 1 < N) r += e[i] * y[i + 1];
        if (!(fabs(r) <= rbound) || !(fabs(y[i]) <= GS_DBL_MAX)) bad = true;
    }
    const bool ok = !__any_sync(0xffffffffu, bad);
    // y -= tau_k (v_k^T y) v_k from k = N - 3 down; lane l owns the y_j
    // with j = l mod 32 throughout (in registers when blocked), so no lane
    // reads another's element
    if (blocked) {
        // a block of reflectors k = kh, kh - 1, .. kl: z_k = v_k^T y for
        // all of them (one interleaved butterfly), then s_k = tau_k z_k in
        // turn, each z below corrected by s_k G; y -= sum s_k v_k
        double yr[JR];
#pragma unroll
        for (int m = 0; m < JR; ++m) {
            const int j = lane + 32 * m;
            yr[m] = j < N ? y[j] : 0.0;
        }
        asm volatile("bar.sync 2, %0;" ::"n"(GS_THREADS - GS_MS_THREADS + 32)
                     : "memory");
        for (int kh = N - 3; kh >= 0; kh -= GS_GB) {
            double v[GS_GB][JR], z[GS_GB];
#pragma unroll
            for (int b = 0; b < GS_GB; ++b) {
                const int k = kh - b;
                z[b] = 0.0;
#pragma unroll
                for (int m = 0; m < JR; ++m) {
                    const int j = lane + 32 * m;
                    v[b][m] = k < 0 || j <= k || j >= N ? 0.0
                              : j == k + 1             ? 1.0
                                                       : A[j * ld + k];
                    z[b] = fma(v[b][m], yr[m], z[b]);
                }
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                for (int b = 0; b < GS_GB; ++b)
                    z[b] += __shfl_xor_sync(0xffffffffu, z[b], o);
#pragma unroll
            for (int b = 0; b < GS_GB; ++b) {
                const int k = kh - b;
                const double sb = k < 0 ? 0.0 : tau[k] * z[b];
#pragma unroll
                for (int c = b + 1; c < GS_GB; ++c)
                    if (kh - c >= 0)
                        z[c] -= sb * Pw[(kh - c) * (GS_GB - 1) + c - b - 1];
#pragma unroll
                for (int m = 0; m < JR; ++m) yr[m] -= sb * v[b][m];
            }
        }
#pragma unroll
        for (int m = 0; m < JR; ++m) {
            const int j = lane + 32 * m;
            if (j < N) y[j] = yr[m];
        }
    } else {
        for (int k = N - 3; k >= 0; --k) {
            const double* vk = A + k;
            double s = 0.0;
            for (int j = lane; j < N; j += 32)
                if (j > k) s = fma(j == k + 1 ? 1.0 : vk[j * ld], y[j], s);
            s = tau[k] * warp_allsum(s);
            for (int j = lane; j < N; j += 32)
                if (j > k) y[j] -= s * (j == k + 1 ? 1.0 : vk[j * ld]);
        }
    }
    __syncwarp();
    double nrm = 0.0, amax = -1.0;
    int imax = N;
    for (int i = lane; i < N; i += 32) {
        nrm = fma(y[i], y[i], nrm);
        if (fabs(y[i]) > amax) {
            amax = fabs(y[i]);
            imax = i;
        }
    }
    nrm = warp_allsum(nrm);
    // the first index of the largest |y_i|
    for (int o = 16; o > 0; o >>= 1) {
        const double a2 = __shfl_xor_sync(0xffffffffu, amax, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, imax, o);
        if (a2 > amax || (a2 == amax && i2 < imax)) {
            amax = a2;
            imax = i2;
        }
    }
    // (imax = N only when y is not finite: then info = -1); c is 0 on the
    // parked rows
    const double f = (imax < N && y[imax] < 0.0 ? -1.0 : 1.0) / sqrt(nrm);
    for (int i = lane; i < S; i += 32) c_out[i] = (T)(i < N ? f * y[i] : 0.0);
    if (lane == 0) {
        lam_out[0] = (T)(lam + h00);
        info_out[0] = ok ? rounds : -1;
    }
}

// dynamic shared memory: A (S x ld) when it fits, and T, tau, w, the LU,
// y (10 S doubles), the warps' parts of p (GS_THREADS / 32 S doubles) and
// the LU's row swaps (S ints)
static size_t gs_smem(int S) {
    const size_t ld = S | 1;
    return (S <= GS_SMEM_MAX_S ? S * ld * sizeof(double) : 0)
           + (10 + GS_THREADS / 32) * (size_t)S * sizeof(double)
           + (size_t)S * sizeof(int);
}

// doubles of device scratch a launch at S needs: A when it does not fit
// in shared memory, else none
KERNELS_API int ground_state_scratch(int S) {
    return S <= GS_SMEM_MAX_S ? 0 : S * (S | 1);
}

// the most multisection rounds a launch takes (info's largest value)
KERNELS_API int ground_state_max_rounds() { return GS_MAX_ROUNDS; }

template <typename T, int JR>
static int ground_state_launch_jr(const void* H, void* lam, void* c,
                                  void* info, void* scratch, void* stream,
                                  int S, int nb, int h_bs) {
    const size_t shm = gs_smem(S);
    const int err = allow_smem((const void*)ground_state_kernel<T, JR>, shm);
    if (err) return err;
    if (nb < 1) return (int)cudaErrorInvalidValue;
    ground_state_kernel<T, JR><<<nb, GS_THREADS, shm,
                                 (cudaStream_t)stream>>>(
        (const T*)H, (T*)lam, (T*)c, (int*)info, (double*)scratch, S, h_bs);
    return (int)cudaGetLastError();
}

// JR by S: 1 up to 32 (the 10k path's cap), else 3 (the flagship's 48 and
// 80; past 96 coupled states both register paths give way to the ones
// through memory)
template <typename T>
static int ground_state_launch(const void* H, void* lam, void* c, void* info,
                               void* scratch, void* stream, int S, int nb,
                               int h_bs) {
    if (S <= 32)
        return ground_state_launch_jr<T, 1>(H, lam, c, info, scratch, stream,
                                            S, nb, h_bs);
    return ground_state_launch_jr<T, 3>(H, lam, c, info, scratch, stream, S,
                                        nb, h_bs);
}

// nb replicas (1: one H); h_bs the elements between two replicas' H (0: one
// H for all); lam, c, info and the scratch (nb ground_state_scratch(S)
// doubles) hold nb results in replica order
KERNELS_API int ground_state_f32(const void* H, void* lam, void* c,
                                 void* info, void* scratch, void* stream,
                                 int S, int nb, int h_bs) {
    return ground_state_launch<float>(H, lam, c, info, scratch, stream, S,
                                      nb, h_bs);
}

KERNELS_API int ground_state_f64(const void* H, void* lam, void* c,
                                 void* info, void* scratch, void* stream,
                                 int S, int nb, int h_bs) {
    return ground_state_launch<double>(H, lam, c, info, scratch, stream, S,
                                       nb, h_bs);
}
