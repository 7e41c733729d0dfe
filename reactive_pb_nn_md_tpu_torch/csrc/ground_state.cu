// Kernel E: the ground eigenpair of the EVB Hamiltonian, by parallel
// cyclic Jacobi in fp64.
//
// No TPU kernel: the JAX package takes the ground state outside Pallas,
// jnp.linalg.eigh of H - H00 I (reactive_pb_nn_md_tpu/ops/ground_state.py:
// ground_state_eigh), with the cyclic-Jacobi jacobi_eigh as its TPU analog.
// The port needs a kernel because torch.linalg.eigh checks its info on the
// host (a synchronization), which a CUDA graph capture refuses.
//
// One block solves A = H - H00 I (S x S, symmetric) whatever H's type, in
// fp64.  A sweep is m - 1 rounds (m = S rounded up to even; an odd S pads
// one zero row that never rotates); round r pairs the indices by the
// round-robin (chess-tournament) order, m / 2 disjoint pairs that together
// meet every pair once a sweep.  A round: one thread per pair computes its
// rotation (Rutishauser's t = sgn(theta) / (|theta| + sqrt(theta^2 + 1))),
// then the block applies all of them to the rows of A, then to the columns
// of A and V, the rotated pair's element set to 0.  Three barriers a
// round; nothing is atomic, so two calls give the same bits.
//
// Convergence: sweeps run while the off-diagonal Frobenius norm is above
// 1e-14 ||A||_F (tested on the device, a block reduction in a fixed
// order), at most GS_MAX_SWEEPS; a pair whose element is negligible beside
// both diagonals (NR's test, from the fourth sweep) is set to 0 and not
// rotated.  *info = the sweeps done, or -1 when the cap was reached
// unconverged: the caller raises.
//
// Output in H's type: lambda_0 + H00 and c_0 with the largest |c_i|
// positive (the first such i).
//
// Memory: A and V in shared memory up to S = GS_SMEM_MAX_S (2 x 80 x 81 x
// 8 B = 104 KB), else in the caller's scratch (2 m (m + 1) doubles) in
// device memory; rows padded to an odd length, so that a warp walking a
// column (lanes over rows) meets no bank twice in a half warp; the
// rotations of a round (c, s, p, q) always in shared memory.  A warp per
// pair, its lanes along the row or column: no index division in the
// passes.
// Work: a rotated pair costs 18 m flops a round (rows of A, columns of A
// and V), so a sweep 9 m^2 (m - 1): 4.5 MFLOP at S = 80.  The bound that
// chip_smoke.py gives E counts the function, not this method: the H in
// and (lambda, c) out, and the (4/3) S^3 flops of a dense symmetric
// tridiagonalization (0.68 MFLOP at S = 80).  E is far from it: one block
// and three barriers a round make it a latency chain.
#include "common.cuh"

constexpr int GS_THREADS = 512;
constexpr int GS_MAX_SWEEPS = 30;
constexpr int GS_SMEM_MAX_S = 80;

// the pair k of round r among m indices (m even): position 0 stays, the
// others turn by one a round
__device__ __forceinline__ void gs_pair(int k, int r, int m, int& p, int& q) {
    const int n1 = m - 1;
    int a = (k == 0) ? 0 : 1 + (k - 1 + r) % n1;
    int b = 1 + (m - 2 - k + r) % n1;
    p = min(a, b);
    q = max(a, b);
}

// sum of v over the block, the same bits in every thread
__device__ double gs_block_sum(double v, double* red) {
    v = warp_allsum(v);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    __syncthreads();
    if (lane == 0) red[warp] = v;
    __syncthreads();
    double s = 0.0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w];
    return s;
}

template <typename T>
__global__ void __launch_bounds__(GS_THREADS)
ground_state_kernel(const T* __restrict__ H, T* __restrict__ lam_out,
                    T* __restrict__ c_out, int* __restrict__ info_out,
                    double* __restrict__ scratch, int S, int use_smem) {
    extern __shared__ double smem[];
    __shared__ double red[GS_THREADS / 32];
    __shared__ int pick[2];
    const int m = S + (S & 1);
    const int ld = m + 1;          // odd: a column's doubles hit 16 banks
    const int half = m / 2;
    double* A = use_smem ? smem : scratch;
    double* V = A + (size_t)m * ld;
    double* rc = use_smem ? smem + 2 * (size_t)m * ld : smem;
    double* rs = rc + half;
    int* rp = (int*)(rs + half);
    int* rq = rp + half;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
    const double h00 = (double)H[0];

    double fro = 0.0;
    for (int i = warp; i < m; i += nw) {
        for (int j = lane; j < m; j += 32) {
            double a = 0.0;
            if (i < S && j < S)
                a = (double)H[i * S + j] - (i == j ? h00 : 0.0);
            A[i * ld + j] = a;
            V[i * ld + j] = (i == j) ? 1.0 : 0.0;
            fro += a * a;
        }
    }
    const double tol2 = 1e-28 * gs_block_sum(fro, red);

    int sweeps = -1;               // sweeps done once converged
    for (int sweep = 0; sweep <= GS_MAX_SWEEPS; ++sweep) {
        double off = 0.0;
        for (int i = warp; i < m; i += nw)
            for (int j = lane; j < m; j += 32)
                if (j != i) off += A[i * ld + j] * A[i * ld + j];
        if (gs_block_sum(off, red) <= tol2) {
            sweeps = sweep;
            break;
        }
        if (sweep == GS_MAX_SWEEPS) break;
        for (int r = 0; r < m - 1; ++r) {
            for (int k = tid; k < half; k += nt) {
                int p, q;
                gs_pair(k, r, m, p, q);
                double c = 1.0, s = 0.0;
                const double apq = A[p * ld + q];
                if (q < S && apq != 0.0) {
                    const double app = A[p * ld + p], aqq = A[q * ld + q];
                    const double g = 100.0 * fabs(apq);
                    if (sweep > 3 && fabs(app) + g == fabs(app)
                        && fabs(aqq) + g == fabs(aqq)) {
                        A[p * ld + q] = 0.0;    // negligible: no rotation
                        A[q * ld + p] = 0.0;
                    } else {
                        const double theta = 0.5 * (aqq - app) / apq;
                        double t;
                        if (fabs(theta) > 1e150) {
                            t = 0.5 / theta;
                        } else {
                            t = 1.0 / (fabs(theta)
                                       + sqrt(theta * theta + 1.0));
                            if (theta < 0.0) t = -t;
                        }
                        c = 1.0 / sqrt(t * t + 1.0);
                        s = t * c;
                    }
                }
                rc[k] = c;
                rs[k] = s;
                rp[k] = p;
                rq[k] = q;
            }
            __syncthreads();
            // rows p and q of every rotated pair: A <- J^T A; a warp per
            // pair, its lanes along the row
            for (int k = warp; k < half; k += nw) {
                const double s = rs[k];
                if (s == 0.0) continue;
                const double c = rc[k];
                double* Ap = A + rp[k] * ld;
                double* Aq = A + rq[k] * ld;
                for (int j = lane; j < m; j += 32) {
                    const double apj = Ap[j], aqj = Aq[j];
                    Ap[j] = c * apj - s * aqj;
                    Aq[j] = s * apj + c * aqj;
                }
            }
            __syncthreads();
            // columns p and q: A <- A J, V <- V J; the pair's own element
            // (written by no other thread) is set to 0
            for (int k = warp; k < half; k += nw) {
                const double s = rs[k];
                if (s == 0.0) continue;
                const double c = rc[k];
                const int p = rp[k], q = rq[k];
                for (int i = lane; i < m; i += 32) {
                    const double aip = A[i * ld + p], aiq = A[i * ld + q];
                    A[i * ld + p] = (i == q) ? 0.0 : c * aip - s * aiq;
                    A[i * ld + q] = (i == p) ? 0.0 : s * aip + c * aiq;
                    const double vip = V[i * ld + p], viq = V[i * ld + q];
                    V[i * ld + p] = c * vip - s * viq;
                    V[i * ld + q] = s * vip + c * viq;
                }
            }
            __syncthreads();
        }
    }

    if (tid == 0) {
        int g = 0;
        for (int i = 1; i < S; ++i)
            if (A[i * ld + i] < A[g * ld + g]) g = i;
        int big = 0;
        for (int i = 1; i < S; ++i)
            if (fabs(V[i * ld + g]) > fabs(V[big * ld + g])) big = i;
        pick[0] = g;
        pick[1] = big;
        lam_out[0] = (T)(A[g * ld + g] + h00);
        info_out[0] = sweeps;
    }
    __syncthreads();
    const int g = pick[0];
    const double sign = V[pick[1] * ld + g] < 0.0 ? -1.0 : 1.0;
    for (int i = tid; i < S; i += nt) c_out[i] = (T)(sign * V[i * ld + g]);
}

// dynamic shared memory: A and V (m x (m + 1) each) when they fit, and
// the rotations of a round (c, s and the pair, m / 2 each)
static size_t gs_smem(int S, int use_smem) {
    const size_t m = S + (S & 1);
    return (use_smem ? 2 * m * (m + 1) * sizeof(double) : 0)
           + m * sizeof(double) + m * sizeof(int);
}

// doubles of device scratch a launch at S needs: A and V when they do not
// fit in shared memory, else none
KERNELS_API int ground_state_scratch(int S) {
    const int m = S + (S & 1);
    return S <= GS_SMEM_MAX_S ? 0 : 2 * m * (m + 1);
}

template <typename T>
static int ground_state_launch(const void* H, void* lam, void* c, void* info,
                               void* scratch, void* stream, int S) {
    const int use_smem = S <= GS_SMEM_MAX_S;
    const size_t shm = gs_smem(S, use_smem);
    const int err = allow_smem((const void*)ground_state_kernel<T>, shm);
    if (err) return err;
    ground_state_kernel<T><<<1, GS_THREADS, shm, (cudaStream_t)stream>>>(
        (const T*)H, (T*)lam, (T*)c, (int*)info, (double*)scratch, S,
        use_smem);
    return (int)cudaGetLastError();
}

KERNELS_API int ground_state_f32(const void* H, void* lam, void* c,
                                 void* info, void* scratch, void* stream,
                                 int S) {
    return ground_state_launch<float>(H, lam, c, info, scratch, stream, S);
}

KERNELS_API int ground_state_f64(const void* H, void* lam, void* c,
                                 void* info, void* scratch, void* stream,
                                 int S) {
    return ground_state_launch<double>(H, lam, c, info, scratch, stream, S);
}

