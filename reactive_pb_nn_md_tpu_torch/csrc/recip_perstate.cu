// Kernel C: per-diabat reciprocal-space delta energies (C1) and their
// backward (C2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:_fwd_kernel
// and _bwd_kernel.  For every state s
//
//   E_s = sum_m cbw(m) [F0r Gr + F0i Gi + (Gr^2 + Gi^2)/2],
//   G_s(m1, m) = sum_u dq_su (ar + i ai)(m1, u) (bcr + i bci)(u, m),
//
// with every array real (the caller splits A, BC, F0 into parts) and row
// major: dq (S,U), ar/ai (K,U), bcr/bci (U,Mh), f0r/f0i/cbw (K,Mh).
//
// All products are one register-blocked complex GEMM template (cgemm):
// 32x64 output tiles, 16-deep slices staged in shared memory, 2x4 complex
// accumulators per thread, operands produced by loader functors so that
// W = dq * A is formed while it is loaded and never stored.
//  C1: G tiles reduced in place against cbw / F0; each block writes one
//      partial per state (no atomics, no cross-block carry); the wrapper
//      sums the partials.  G never reaches device memory.
//  C2: dG = gbar_s cbw (F0 + G) is recomputed by the same GEMM and stored
//      (scratch from the wrapper), then contracted by separate kernels:
//      dW = dG conj(BC)^T -> ddq, dA;  dBC = conj(W)^T dG;  dF0.
// Bound on the H100: arithmetic.  C1 is 8 S K Mh U flops (3.6 GFLOP at
// S = 80, K = 32, U = 320), C2 three times that; the operands (< 3 MB)
// live in L2.  No tensor cores: the fp64 path needs full precision and
// the fp32 path must not drop to TF32.
#include "common.cuh"

namespace {

constexpr int BM = 32, BN = 64, BK = 16, TX = 16, TY = 16;
constexpr int TM = BM / TY, TN = BN / TX, NT = TX * TY;

template <typename T, typename AL, typename BL, typename EP>
__global__ void __launch_bounds__(NT)
cgemm_kernel(AL al, BL bl, EP ep, int R, int C, int D) {
    __shared__ T sAr[BK][BM], sAi[BK][BM];
    __shared__ T sBr[BK][BN], sBi[BK][BN];
    __shared__ T red[NT];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * TX + tx;
    const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN, z = blockIdx.z;
    T accr[TM][TN], acci[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) accr[i][j] = acci[i][j] = (T)0;

    for (int k0 = 0; k0 < D; k0 += BK) {
        for (int idx = tid; idx < BM * BK; idx += NT) {
            int rr, kk;
            if (AL::K_FAST) { rr = idx / BK; kk = idx % BK; }
            else { kk = idx / BM; rr = idx % BM; }
            T re = 0, im = 0;
            if (r0 + rr < R && k0 + kk < D) al(z, r0 + rr, k0 + kk, re, im);
            sAr[kk][rr] = re;
            sAi[kk][rr] = im;
        }
        for (int idx = tid; idx < BK * BN; idx += NT) {
            int cc, kk;
            if (BL::K_FAST) { cc = idx / BK; kk = idx % BK; }
            else { kk = idx / BN; cc = idx % BN; }
            T re = 0, im = 0;
            if (c0 + cc < C && k0 + kk < D) bl(z, k0 + kk, c0 + cc, re, im);
            sBr[kk][cc] = re;
            sBi[kk][cc] = im;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            T ar[TM], ai[TM], br[TN], bi[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) {
                ar[i] = sAr[kk][ty * TM + i];
                ai[i] = sAi[kk][ty * TM + i];
            }
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                br[j] = sBr[kk][tx + j * TX];
                bi[j] = sBi[kk][tx + j * TX];
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    accr[i][j] += ar[i] * br[j] - ai[i] * bi[j];
                    acci[i][j] += ar[i] * bi[j] + ai[i] * br[j];
                }
        }
        __syncthreads();
    }

    T local = 0;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int r = r0 + ty * TM + i, c = c0 + tx + j * TX;
            if (r < R && c < C) ep(z, r, c, accr[i][j], acci[i][j], local);
        }
    if (EP::REDUCE) {
        red[tid] = local;
        __syncthreads();
        for (int s = NT / 2; s > 0; s >>= 1) {
            if (tid < s) red[tid] += red[tid + s];
            __syncthreads();
        }
        if (tid == 0)
            ep.finish(z, blockIdx.y * gridDim.x + blockIdx.x, red[0]);
    }
}

// ---- operand loaders: (z, row, depth) -> complex value
template <typename T>
struct WLoad {            // W[s](m1, u) = dq[s,u] (ar + i ai)[m1,u]; z = s
    static constexpr bool K_FAST = true;
    const T *dq, *ar, *ai;
    int U;
    __device__ void operator()(int s, int m1, int u, T& re, T& im) const {
        const T w = dq[(size_t)s * U + u];
        re = w * ar[(size_t)m1 * U + u];
        im = w * ai[(size_t)m1 * U + u];
    }
};

template <typename T>
struct WConjT {           // conj(W)^T: row u, depth (s, m1)
    static constexpr bool K_FAST = false;
    const T *dq, *ar, *ai;
    int U, K;
    __device__ void operator()(int, int u, int k, T& re, T& im) const {
        const int s = k / K, m1 = k % K;
        const T w = dq[(size_t)s * U + u];
        re = w * ar[(size_t)m1 * U + u];
        im = -w * ai[(size_t)m1 * U + u];
    }
};

template <typename T>
struct BCLoad {           // BC(u, m)
    static constexpr bool K_FAST = false;
    const T *bcr, *bci;
    int Mh;
    __device__ void operator()(int, int u, int m, T& re, T& im) const {
        re = bcr[(size_t)u * Mh + m];
        im = bci[(size_t)u * Mh + m];
    }
};

template <typename T>
struct BCConjT {          // conj(BC)^T: depth m, column u
    static constexpr bool K_FAST = true;
    const T *bcr, *bci;
    int Mh;
    __device__ void operator()(int, int m, int u, T& re, T& im) const {
        re = bcr[(size_t)u * Mh + m];
        im = -bci[(size_t)u * Mh + m];
    }
};

template <typename T, bool KF>
struct RowLoad {          // dG(r, m) rows, r = s*K + m1
    static constexpr bool K_FAST = KF;
    const T *gr, *gi;
    int Mh;
    __device__ void operator()(int, int r, int m, T& re, T& im) const {
        re = gr[(size_t)r * Mh + m];
        im = gi[(size_t)r * Mh + m];
    }
};

// ---- epilogues
template <typename T>
struct EnergyEpi {        // partial sums of cbw [F0 . G + |G|^2 / 2]
    static constexpr bool REDUCE = true;
    const T *f0r, *f0i, *cbw;
    T* partial;
    int Mh, nblk;
    __device__ void operator()(int, int m1, int m, T gr, T gi, T& acc) const {
        const size_t k = (size_t)m1 * Mh + m;
        acc += cbw[k] * (f0r[k] * gr + f0i[k] * gi
                         + (T)0.5 * (gr * gr + gi * gi));
    }
    __device__ void finish(int s, int b, T v) const {
        partial[(size_t)s * nblk + b] = v;
    }
};

template <typename T>
struct DGEpi {            // dG = gbar_s cbw (F0 + G)
    static constexpr bool REDUCE = false;
    const T *gbar, *f0r, *f0i, *cbw;
    T *dgr, *dgi;
    int K, Mh;
    __device__ void operator()(int s, int m1, int m, T gr, T gi, T&) const {
        const size_t k = (size_t)m1 * Mh + m;
        const size_t o = ((size_t)s * K + m1) * Mh + m;
        const T g = gbar[s] * cbw[k];
        dgr[o] = g * (f0r[k] + gr);
        dgi[o] = g * (f0i[k] + gi);
    }
    __device__ void finish(int, int, T) const {}
};

template <typename T>
struct StoreEpi {         // plain complex store, row stride ld
    static constexpr bool REDUCE = false;
    T *outr, *outi;
    int ld;
    __device__ void operator()(int, int r, int c, T gr, T gi, T&) const {
        outr[(size_t)r * ld + c] = gr;
        outi[(size_t)r * ld + c] = gi;
    }
    __device__ void finish(int, int, T) const {}
};

template <typename T, typename AL, typename BL, typename EP>
void cgemm(AL al, BL bl, EP ep, int R, int C, int D, int Z,
           cudaStream_t st) {
    dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM, Z), block(TX, TY);
    cgemm_kernel<T, AL, BL, EP><<<grid, block, 0, st>>>(al, bl, ep, R, C, D);
}

template <typename T>
__global__ void ddq_kernel(const T* dwr, const T* dwi, const T* ar,
                           const T* ai, T* ddq, int S, int U, int K) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= S * U) return;
    const int s = t / U, u = t % U;
    T acc = 0;
    for (int m1 = 0; m1 < K; ++m1) {
        const size_t o = ((size_t)s * K + m1) * U + u;
        acc += dwr[o] * ar[(size_t)m1 * U + u] + dwi[o] * ai[(size_t)m1 * U + u];
    }
    ddq[t] = acc;
}

template <typename T>
__global__ void da_kernel(const T* dwr, const T* dwi, const T* dq, T* dar,
                          T* dai, int S, int U, int K) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= K * U) return;
    const int m1 = t / U, u = t % U;
    T accr = 0, acci = 0;
    for (int s = 0; s < S; ++s) {
        const size_t o = ((size_t)s * K + m1) * U + u;
        const T w = dq[(size_t)s * U + u];
        accr += dwr[o] * w;
        acci += dwi[o] * w;
    }
    dar[t] = accr;
    dai[t] = acci;
}

template <typename T>
__global__ void df0_kernel(const T* dgr, const T* dgi, const T* gbar,
                           const T* f0r, const T* f0i, const T* cbw,
                           T* df0r, T* df0i, int S, int K, int Mh) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= K * Mh) return;
    T sr = 0, si = 0, gsum = 0;
    for (int s = 0; s < S; ++s) {
        sr += dgr[(size_t)s * K * Mh + t];
        si += dgi[(size_t)s * K * Mh + t];
        gsum += gbar[s];
    }
    df0r[t] = sr - gsum * cbw[t] * f0r[t];
    df0i[t] = si - gsum * cbw[t] * f0i[t];
}

template <typename T>
int perstate_fwd(const T* dq, const T* ar, const T* ai, const T* bcr,
                 const T* bci, const T* f0r, const T* f0i, const T* cbw,
                 T* partial, cudaStream_t st, int S, int U, int K, int Mh) {
    const int nblk = ((Mh + BN - 1) / BN) * ((K + BM - 1) / BM);
    cgemm<T>(WLoad<T>{dq, ar, ai, U}, BCLoad<T>{bcr, bci, Mh},
             EnergyEpi<T>{f0r, f0i, cbw, partial, Mh, nblk}, K, Mh, U, S,
             st);
    return (int)cudaGetLastError();
}

template <typename T>
int perstate_bwd(const T* gbar, const T* dq, const T* ar, const T* ai,
                 const T* bcr, const T* bci, const T* f0r, const T* f0i,
                 const T* cbw, T* dgr, T* dgi, T* dwr, T* dwi, T* ddq,
                 T* dar, T* dai, T* dbcr, T* dbci, T* df0r, T* df0i,
                 cudaStream_t st, int S, int U, int K, int Mh) {
    // dG = gbar cbw (F0 + G), G recomputed
    cgemm<T>(WLoad<T>{dq, ar, ai, U}, BCLoad<T>{bcr, bci, Mh},
             DGEpi<T>{gbar, f0r, f0i, cbw, dgr, dgi, K, Mh}, K, Mh, U, S,
             st);
    int err = (int)cudaGetLastError();
    if (err) return err;
    // dW (S*K, U) = dG conj(BC)^T
    cgemm<T>(RowLoad<T, true>{dgr, dgi, Mh}, BCConjT<T>{bcr, bci, Mh},
             StoreEpi<T>{dwr, dwi, U}, S * K, U, Mh, 1, st);
    // dBC (U, Mh) = conj(W)^T dG
    cgemm<T>(WConjT<T>{dq, ar, ai, U, K}, RowLoad<T, false>{dgr, dgi, Mh},
             StoreEpi<T>{dbcr, dbci, Mh}, U, Mh, S * K, 1, st);
    err = (int)cudaGetLastError();
    if (err) return err;
    const int th = 256;
    ddq_kernel<T><<<(S * U + th - 1) / th, th, 0, st>>>(dwr, dwi, ar, ai,
                                                        ddq, S, U, K);
    da_kernel<T><<<(K * U + th - 1) / th, th, 0, st>>>(dwr, dwi, dq, dar,
                                                       dai, S, U, K);
    df0_kernel<T><<<(K * Mh + th - 1) / th, th, 0, st>>>(
        dgr, dgi, gbar, f0r, f0i, cbw, df0r, df0i, S, K, Mh);
    return (int)cudaGetLastError();
}

}  // namespace

KERNELS_API int perstate_tile(int which) { return which == 0 ? BM : BN; }

#define PERSTATE_API(SUF, T)                                                 \
    KERNELS_API int perstate_fwd_##SUF(                                     \
        const void* dq, const void* ar, const void* ai, const void* bcr,    \
        const void* bci, const void* f0r, const void* f0i, const void* cbw, \
        void* partial, void* st, int S, int U, int K, int Mh) {             \
        return perstate_fwd<T>((const T*)dq, (const T*)ar, (const T*)ai,    \
                               (const T*)bcr, (const T*)bci, (const T*)f0r, \
                               (const T*)f0i, (const T*)cbw, (T*)partial,   \
                               (cudaStream_t)st, S, U, K, Mh);              \
    }                                                                       \
    KERNELS_API int perstate_bwd_##SUF(                                     \
        const void* gbar, const void* dq, const void* ar, const void* ai,   \
        const void* bcr, const void* bci, const void* f0r, const void* f0i, \
        const void* cbw, void* dgr, void* dgi, void* dwr, void* dwi,        \
        void* ddq, void* dar, void* dai, void* dbcr, void* dbci,            \
        void* df0r, void* df0i, void* st, int S, int U, int K, int Mh) {    \
        return perstate_bwd<T>(                                             \
            (const T*)gbar, (const T*)dq, (const T*)ar, (const T*)ai,       \
            (const T*)bcr, (const T*)bci, (const T*)f0r, (const T*)f0i,     \
            (const T*)cbw, (T*)dgr, (T*)dgi, (T*)dwr, (T*)dwi, (T*)ddq,     \
            (T*)dar, (T*)dai, (T*)dbcr, (T*)dbci, (T*)df0r, (T*)df0i,       \
            (cudaStream_t)st, S, U, K, Mh);                                 \
    }

PERSTATE_API(f32, float)
PERSTATE_API(f64, double)
