// Kernel C: per-diabat reciprocal-space delta energies (C1) and their
// backward (C2).
//
// Replaces reactive_pb_nn_md_tpu/ops/pallas/recip_perstate.py:_fwd ->
// _fwd_kernel (C1) and _bwd -> _bwd_kernel (C2).  For every state s
//
//   E_s = sum_m cbw(m) [F0r Gr + F0i Gi + (Gr^2 + Gi^2)/2],
//   G_s(m1, m) = sum_u dq_su (ar + i ai)(m1, u) (bcr + i bci)(u, m),
//
// with every array real (the caller splits A, BC, F0 into parts) and row
// major: dq (S,U), ar/ai (K,U), bcr/bci (U,Mh), f0r/f0i/cbw (K,Mh).  The
// rows of G are r = s K + m1, so one GEMM covers every state.
//
// Every product is one complex GEMM template (cgemm) over 64 x 32 (fp64)
// or 64 x 64 (fp32) output tiles, BK-deep operand slices double-buffered
// in shared memory and filled with 16-byte cp.async.  Every operand is a
// row-major array: BC, the dG rows, and W = dq A, which a small kernel
// writes once per call into scratch (forming W inside the GEMM's loader
// cost more than the write: its loads stalled every slice).  Each slice is
// stored in the layout its fragments are read in (depth-contiguous rows,
// or row-contiguous depth planes), every row padded by 4 elements, so that
// neither the 16-byte copies nor the 8-byte fragment reads of a half warp
// meet in a bank; conjugates are negated in registers.
//  fp64: the tensor cores (DMMA) through mma.sync.m16n8k8.f64 (the sm_90
//        shape; sm_80's m8n8k4 runs at a lower rate), 4 warps of 32x16.
//        DMMA computes IEEE fp64 fused multiply-adds into fp64
//        accumulators, the type of the FMA path; only the order of the
//        sums differs.  Each complex depth step is four real MMAs
//        (Ar Br, -Ai Bi, Ar Bi, Ai Br): the 8 real operations per complex
//        multiply-add that the bound counts (no 3-multiply form, which
//        would round differently).
//  fp32: CUDA-core FMAs, 256 threads of 4x4 complex (16 shared-memory
//        values read per 64 FMAs).  The tensor cores' fp32-input mode is
//        TF32, which the port bars (package __init__).
//  C1: G tiles reduced in place against cbw / F0; each block writes one
//      partial per row r (no atomics); the wrapper sums them in order.
//      G never reaches device memory.
//  C2: dG = gbar_s cbw (F0 + G) is recomputed by the same GEMM and stored
//      (scratch), then contracted:  dW = dG conj(BC)^T -> ddq, dA;
//      dBC = conj(W)^T dG;  dF0.  A product whose tiles leave resident
//      block slots empty splits its depth over blockIdx.z (dBC: whole
//      states per chunk) into as many chunks as one wave holds; a fold
//      sums the partials in chunk order.  ddq, dA and dF0 are sums over
//      one axis of dW or dG, 8 warps to an output column and their
//      partials folded in warp order.  No atomics: C2 is deterministic.
// Blocks per product (output tiles x depth chunks; U = 4 S), fp64 / fp32,
// against 396 / 264 resident blocks (3 / 2 per SM):
//                            G, C1 (D = U)   dW (D = Mh)     dBC (D = S K)
//   S = 48, K = 32, U = 192    408 / 216       144x2 / 72x3    51x7 / 27x8
//   S = 80, K = 32, U = 320    680 / 360       400 / 200       85x4 / 45x5
//   S = 32, K = 64, U = 128    2112 / 1056     128x3 / 64x4    132x3 / 66x4
// Bound on the H100: operations.  Each product is 8 S K U Mh flops (3.57
// GFLOP at S = 80, K = 32), C1 one and C2 three, against operands of a
// few MB that stay in L2 (dG, 22 MB at S = 80, is written once and read
// three times; at the 10k shapes it is 69 MB and does not fit); fp64 at
// the DMMA peak, fp32 at the FMA peak.
// A batched launch (a replica batch of the vmapped MD step) runs nb
// replicas in every kernel of C1 and C2 at once: the cgemm's z axis
// holds (replica, depth chunk), the other kernels take the replica on
// blockIdx.y; every operand moves by its batch stride (0: shared), the
// scratch and the outputs by a replica's size.  The depth split is the
// one replica's, so each replica's sums run in the same order as its own
// launch's.
#include <stdint.h>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64, PAD = 4, NSM = 132;

// per type: depth of a slice, threads, output tile columns, blocks
// resident per SM (registers and shared memory); fp64 warps own 32 x 16
// of the output (NI = 2 m16n8 tiles wide)
template <typename T>
struct Cfg;
template <>
struct Cfg<double> {
    static constexpr int BK = 16, NT = 128, NI = 2, BN = 16 * NI, BPS = 3;
};
template <>
struct Cfg<float> {
    static constexpr int BK = 32, NT = 256, BN = 64, BPS = 2;
};

// elements of one operand slice in shared memory: MNS rows or columns of
// the output, BK deep, depth-contiguous (KC) or not
template <typename T, bool KC, int MNS>
constexpr int slice_elems() {
    return KC ? MNS * (Cfg<T>::BK + PAD) : Cfg<T>::BK * (MNS + PAD);
}

// offset of element (mn, k) of such a slice
template <typename T, bool KC, int MNS>
__device__ __forceinline__ int soff(int mn, int k) {
    return KC ? mn * (Cfg<T>::BK + PAD) + k : k * (MNS + PAD) + mn;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// D += A B on the fp64 tensor cores: A 16x8 (row), B 8x8 (col), D 16x8
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[4],
                                        const double (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// ---- operands: element (mn, depth k) of A (mn = output row) or B (mn =
// output column) in a row-major array: p[mn ld + k] (KC: stored
// depth-contiguous) or p[k ld + mn]; CONJ: the core negates the imaginary
// part.  ld, and the arrays' addresses, 16-byte aligned -> cp.async;
// otherwise element loads (operator()).
template <typename T, bool KC_, bool CONJ_>
struct ArrOp {
    static constexpr bool KC = KC_, CONJ = CONJ_;
    const T *re, *im;
    int ld;
    bool vec;
    size_t bs;        // elements from one replica's array to the next's
    __device__ void operator()(int mn, int k, T& r, T& i) const {
        const size_t o = KC ? (size_t)mn * ld + k : (size_t)k * ld + mn;
        r = re[o];
        i = im[o];
    }
    __device__ void at(size_t rep) {
        re += rep * bs;
        im += rep * bs;
    }
};

template <bool KC, bool CONJ, typename T>
ArrOp<T, KC, CONJ> arr_op(const T* re, const T* im, int ld, size_t bs) {
    const bool vec = (size_t)ld * sizeof(T) % 16 == 0
                     && bs * sizeof(T) % 16 == 0
                     && (uintptr_t)re % 16 == 0 && (uintptr_t)im % 16 == 0;
    return ArrOp<T, KC, CONJ>{re, im, ld, vec, bs};
}

// One BK-deep slice of an operand into shared memory: MNS rows mn0.. of
// MN, depth k0.. below kend; zeros outside them.  The caller commits.
template <typename T, int MNS, typename OP>
__device__ __forceinline__ void load_slice(const OP& op, T* sre, T* sim,
                                           int mn0, int MN, int k0, int kend,
                                           int tid) {
    constexpr int BK = Cfg<T>::BK, NT = Cfg<T>::NT;
    if (op.vec) {
        constexpr int V = 16 / sizeof(T);
        constexpr int CPR = (OP::KC ? BK : MNS) / V;    // chunks per row
        for (int q = tid; q < MNS * BK / V; q += NT) {
            const int row = q / CPR, e0 = (q % CPR) * V;
            int mn, k, valid;
            if (OP::KC) {
                mn = mn0 + row;
                k = k0 + e0;
                valid = mn < MN ? min(V, kend - k) : 0;
            } else {
                k = k0 + row;
                mn = mn0 + e0;
                valid = k < kend ? min(V, MN - mn) : 0;
            }
            valid = max(valid, 0);
            const size_t o = OP::KC ? (size_t)mn * op.ld + k
                                    : (size_t)k * op.ld + mn;
            const int so = row * ((OP::KC ? BK : MNS) + PAD) + e0;
            cp_async16(sre + so, valid ? op.re + o : op.re,
                       valid * (int)sizeof(T));
            cp_async16(sim + so, valid ? op.im + o : op.im,
                       valid * (int)sizeof(T));
        }
        return;
    }
    for (int idx = tid; idx < MNS * BK; idx += NT) {
        const int mn_l = OP::KC ? idx / BK : idx % MNS;
        const int k_l = OP::KC ? idx % BK : idx / MNS;
        const int mn = mn0 + mn_l, k = k0 + k_l;
        T re = 0, im = 0;
        if (mn < MN && k < kend) op(mn, k, re, im);
        const int so = soff<T, OP::KC, MNS>(mn_l, k_l);
        sre[so] = re;
        sim[so] = im;
    }
}

// ---- fp64 core: DMMA.  Warp (wm, wn) of the 2x2 grid owns rows
// wm 32 + [0, 32) and columns wn WN + [0, WN), WN = 8 NI: 2 x NI m16n8
// tiles.  Fragments (g = lane / 4, t = lane % 4): A (g, t) (g+8, t)
// (g, t+4) (g+8, t+4); B (k t, n g) (k t+4, n g); C (g, 2t) (g, 2t+1)
// (g+8, 2t) (g+8, 2t+1).
struct MmaCore {
    static constexpr int NI = Cfg<double>::NI, WN = 8 * NI,
                         BN = Cfg<double>::BN;
    double cr[2][NI][4], ci[2][NI][4];

    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < NI; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) cr[i][j][e] = ci[i][j][e] = 0.0;
    }

    template <typename AOP, typename BOP>
    __device__ void step(const double* sAr, const double* sAi,
                         const double* sBr, const double* sBi, int tid) {
        constexpr int BK = Cfg<double>::BK;
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int rb = (warp >> 1) * 32, cb = (warp & 1) * WN;
#pragma unroll
        for (int ks = 0; ks < BK; ks += 8) {
            double ar[2][4], ai[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int o = soff<double, AOP::KC, BM>(
                        rb + mi * 16 + g + (e & 1) * 8, ks + t + (e >> 1) * 4);
                    ar[mi][e] = sAr[o];
                    ai[mi][e] = AOP::CONJ ? -sAi[o] : sAi[o];
                }
            }
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
                double br[2], bi[2], nbi[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int o = soff<double, BOP::KC, BN>(cb + ni * 8 + g,
                                                            ks + t + e * 4);
                    br[e] = sBr[o];
                    bi[e] = BOP::CONJ ? -sBi[o] : sBi[o];
                    nbi[e] = -bi[e];
                }
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_f64(cr[mi][ni], ar[mi], br);
                    mma_f64(cr[mi][ni], ai[mi], nbi);
                    mma_f64(ci[mi][ni], ar[mi], bi);
                    mma_f64(ci[mi][ni], ai[mi], br);
                }
            }
        }
    }

    // ep on every element inside (R, C); REDUCE: per-row sums over the
    // block's columns, in a fixed order, to ep.finish(r, blockIdx.x)
    template <typename EP>
    __device__ void epilogue(const EP& ep, double* red, int r0, int c0,
                             int R, int C, int z, int tid) {
        const int warp = tid >> 5, lane = tid & 31;
        const int g = lane >> 2, t = lane & 3;
        const int rb = (warp >> 1) * 32, cb = (warp & 1) * WN;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int rl = rb + mi * 16 + g + h * 8, r = r0 + rl;
                double local = 0.0;
#pragma unroll
                for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int c = c0 + cb + ni * 8 + 2 * t + e;
                        if (r < R && c < C)
                            ep(z, r, c, cr[mi][ni][2 * h + e],
                               ci[mi][ni][2 * h + e], local);
                    }
                if (EP::REDUCE) {
                    local += __shfl_xor_sync(0xffffffffu, local, 1);
                    local += __shfl_xor_sync(0xffffffffu, local, 2);
                    if (t == 0) red[(warp & 1) * BM + rl] = local;
                }
            }
        if (EP::REDUCE) {
            __syncthreads();
            if (tid < BM && r0 + tid < R)
                ep.finish(r0 + tid, blockIdx.x, red[tid] + red[BM + tid]);
        }
    }
};

// ---- fp32 core: FMA, thread (tx, ty) of 16x16 owns rows ty 4 + i and
// columns tx 4 + j (B row-contiguous) or tx + 16 j (B depth-contiguous),
// reading 4 depths at a time as float4.
struct FmaCore {
    static constexpr int BN = Cfg<float>::BN;
    float cr[4][4], ci[4][4];

    __device__ void zero() {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cr[i][j] = ci[i][j] = 0.f;
    }

    template <bool KC>
    __device__ static int col(int tx, int j) {
        return KC ? tx + 16 * j : tx * 4 + j;
    }

    // v[i][kk] = element (mn_i, kq + kk) of a slice of MNS, mn_i = m0 + i,
    // or m0 + 16 i when `spread` (columns of a depth-contiguous B)
    template <bool KC, int MNS>
    __device__ static void frag(const float* s, int m0, bool spread, int kq,
                                float (&v)[4][4]) {
        if (KC) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 q = *reinterpret_cast<const float4*>(
                    s + soff<float, true, MNS>(spread ? m0 + 16 * i : m0 + i,
                                               kq));
                v[i][0] = q.x; v[i][1] = q.y; v[i][2] = q.z; v[i][3] = q.w;
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float4 q = *reinterpret_cast<const float4*>(
                    s + soff<float, false, MNS>(m0, kq + kk));
                v[0][kk] = q.x; v[1][kk] = q.y; v[2][kk] = q.z; v[3][kk] = q.w;
            }
        }
    }

    template <typename AOP, typename BOP>
    __device__ void step(const float* sAr, const float* sAi, const float* sBr,
                         const float* sBi, int tid) {
        constexpr int BK = Cfg<float>::BK;
        const int tx = tid & 15, ty = tid >> 4;
        const int b0 = BOP::KC ? tx : tx * 4;
#pragma unroll 2
        for (int kq = 0; kq < BK; kq += 4) {
            float ar[4][4], ai[4][4], br[4][4], bi[4][4];
            frag<AOP::KC, BM>(sAr, ty * 4, false, kq, ar);
            frag<AOP::KC, BM>(sAi, ty * 4, false, kq, ai);
            frag<BOP::KC, BN>(sBr, b0, BOP::KC, kq, br);
            frag<BOP::KC, BN>(sBi, b0, BOP::KC, kq, bi);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float a_r = ar[i][kk];
                    const float a_i = AOP::CONJ ? -ai[i][kk] : ai[i][kk];
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        const float b_r = br[j][kk];
                        const float b_i = BOP::CONJ ? -bi[j][kk] : bi[j][kk];
                        cr[i][j] = fmaf(a_r, b_r, cr[i][j]);
                        cr[i][j] = fmaf(-a_i, b_i, cr[i][j]);
                        ci[i][j] = fmaf(a_r, b_i, ci[i][j]);
                        ci[i][j] = fmaf(a_i, b_r, ci[i][j]);
                    }
                }
        }
    }

    template <typename EP, bool BKC>
    __device__ void epilogue(const EP& ep, float*, int r0, int c0, int R,
                             int C, int z, int tid) {
        const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = r0 + ty * 4 + i;
            float local = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = c0 + col<BKC>(tx, j);
                if (r < R && c < C) ep(z, r, c, cr[i][j], ci[i][j], local);
            }
            if (EP::REDUCE) {
#pragma unroll
                for (int o = 8; o > 0; o >>= 1)
                    local += __shfl_xor_sync(0xffffffffu, local, o);
                if (tx == 0 && r < R) ep.finish(r, blockIdx.x, local);
            }
        }
    }
};

template <typename T>
using Core = typename std::conditional<std::is_same<T, double>::value,
                                       MmaCore, FmaCore>::type;

// shared memory of one stage: A re, A im, B re, B im
template <typename T, typename AOP, typename BOP>
struct Smem {
    static constexpr int A = slice_elems<T, AOP::KC, BM>(),
                         B = slice_elems<T, BOP::KC, Cfg<T>::BN>(),
                         STAGE = 2 * (A + B);
    static constexpr size_t BYTES = 2 * STAGE * sizeof(T);    // 2 stages
};

// out(R, C) = A(R, D) B(D, C) over depth chunk z: [z dchunk, (z+1) dchunk)
// of replica rep, blockIdx.z = rep nzr + z (a batched launch: each
// replica's operands and outputs `bs` elements past the previous one's)
template <typename T, typename AOP, typename BOP, typename EP>
__global__ void __launch_bounds__(Cfg<T>::NT, Cfg<T>::BPS)
cgemm_kernel(AOP a, BOP b, EP ep, int R, int C, int D, int dchunk,
             int nzr) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* sm = reinterpret_cast<T*>(smem_raw);
    using SM = Smem<T, AOP, BOP>;
    constexpr int BK = Cfg<T>::BK, BN = Cfg<T>::BN;
    const int tid = threadIdx.x;
    const int rep = blockIdx.z / nzr;
    a.at(rep);
    b.at(rep);
    ep.at(rep);
    const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN,
              z = blockIdx.z - rep * nzr;
    const int kbeg = z * dchunk, kend = min(D, kbeg + dchunk);
    const int nk = (kend - kbeg + BK - 1) / BK;

    Core<T> core;
    core.zero();
    auto load = [&](int st, int k0) {
        T* s = sm + st * SM::STAGE;
        load_slice<T, BM>(a, s, s + SM::A, r0, R, k0, kend, tid);
        load_slice<T, BN>(b, s + 2 * SM::A, s + 2 * SM::A + SM::B, c0, C, k0,
                          kend, tid);
    };
    if (nk > 0) load(0, kbeg);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load((kt + 1) & 1, kbeg + (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        const T* s = sm + (kt & 1) * SM::STAGE;
        core.template step<AOP, BOP>(s, s + SM::A, s + 2 * SM::A,
                                     s + 2 * SM::A + SM::B, tid);
        __syncthreads();
    }
    if constexpr (std::is_same<T, double>::value)
        core.epilogue(ep, sm, r0, c0, R, C, z, tid);
    else
        core.template epilogue<EP, BOP::KC>(ep, sm, r0, c0, R, C, z, tid);
}

// ---- epilogues: ep(z, r, c, re, im, acc); REDUCE ones sum acc per row
template <typename T>
struct EnergyEpi {        // per-row partials of cbw [F0 . G + |G|^2 / 2]
    static constexpr bool REDUCE = true;
    const T *f0r, *f0i, *cbw;
    T* partial;
    int K, Mh, ncb;
    size_t f0_bs, cbw_bs, p_bs;
    __device__ void at(size_t rep) {
        f0r += rep * f0_bs;
        f0i += rep * f0_bs;
        cbw += rep * cbw_bs;
        partial += rep * p_bs;
    }
    __device__ void operator()(int, int r, int m, T gr, T gi, T& acc) const {
        const size_t k = (size_t)(r % K) * Mh + m;
        acc += cbw[k] * (f0r[k] * gr + f0i[k] * gi
                         + (T)0.5 * (gr * gr + gi * gi));
    }
    __device__ void finish(int r, int cb, T v) const {
        partial[(size_t)r * ncb + cb] = v;
    }
};

template <typename T>
struct DGEpi {            // dG = gbar_s cbw (F0 + G), row r = s K + m1
    static constexpr bool REDUCE = false;
    const T *gbar, *f0r, *f0i, *cbw;
    T *dgr, *dgi;
    int K, Mh;
    size_t g_bs, f0_bs, cbw_bs, dg_bs;
    __device__ void at(size_t rep) {
        gbar += rep * g_bs;
        f0r += rep * f0_bs;
        f0i += rep * f0_bs;
        cbw += rep * cbw_bs;
        dgr += rep * dg_bs;
        dgi += rep * dg_bs;
    }
    __device__ void operator()(int, int r, int m, T gr, T gi, T&) const {
        const int s = r / K;
        const size_t k = (size_t)(r - s * K) * Mh + m;
        const size_t o = (size_t)r * Mh + m;
        const T g = gbar[s] * cbw[k];
        dgr[o] = g * (f0r[k] + gr);
        dgi[o] = g * (f0i[k] + gi);
    }
    __device__ void finish(int, int, T) const {}
};

template <typename T>
struct StoreEpi {         // complex store, row stride ld, chunk z at z zs
    static constexpr bool REDUCE = false;
    T *outr, *outi;
    int ld;
    size_t zs, bs;
    __device__ void at(size_t rep) {
        outr += rep * bs;
        outi += rep * bs;
    }
    __device__ void operator()(int z, int r, int c, T gr, T gi, T&) const {
        const size_t o = z * zs + (size_t)r * ld + c;
        outr[o] = gr;
        outi[o] = gi;
    }
    __device__ void finish(int, int, T) const {}
};

// dW's and dBC's stores: one type each, so each product's kernel has a
// name of its own in a profile
template <typename T>
struct DWEpi : StoreEpi<T> {};
template <typename T>
struct DBCEpi : StoreEpi<T> {};

// nz depth chunks of each of nb replicas
template <typename T, typename AOP, typename BOP, typename EP>
int cgemm(AOP a, BOP b, EP ep, int R, int C, int D, int nz, int dchunk,
          int nb, cudaStream_t st) {
    constexpr size_t smem = Smem<T, AOP, BOP>::BYTES;
    const void* kern = (const void*)cgemm_kernel<T, AOP, BOP, EP>;
    static const int attr = allow_smem(kern, smem);
    if (attr) return attr;
    if ((long long)nz * nb > 65535) return (int)cudaErrorInvalidValue;
    constexpr int BN = Cfg<T>::BN;
    dim3 grid((C + BN - 1) / BN, (R + BM - 1) / BM, nz * nb);
    cgemm_kernel<T, AOP, BOP, EP><<<grid, Cfg<T>::NT, smem, st>>>(
        a, b, ep, R, C, D, dchunk, nz);
    return (int)cudaGetLastError();
}

// Depth chunks of a product with `tiles` output tiles and depth D, cut in
// whole units (slices, or states): as many as still fit the resident
// blocks of one wave (`slots`), so that no SM idles and no partials are
// written for a product that fills the card alone.
int split_depth(int tiles, int slots, int D, int unit, int& dchunk) {
    const int units = (D + unit - 1) / unit;
    int n = tiles >= slots ? 1 : slots / tiles;
    n = n < units ? n : units;
    dchunk = ((units + n - 1) / n) * unit;
    return (D + dchunk - 1) / dchunk;
}

template <typename T>
int tiles_of(int R, int C) {
    return ((R + BM - 1) / BM) * ((C + Cfg<T>::BN - 1) / Cfg<T>::BN);
}

// which = 2: dW (S K x U, depth Mh); 3: dBC (U x Mh, depth S K, whole
// states per chunk)
template <typename T>
int bwd_split(int which, int S, int U, int K, int Mh, int& dchunk) {
    constexpr int slots = NSM * Cfg<T>::BPS;
    if (which == 2)
        return split_depth(tiles_of<T>(S * K, U), slots, Mh, Cfg<T>::BK,
                           dchunk);
    return split_depth(tiles_of<T>(U, Mh), slots, S * K, K, dchunk);
}

// ---- scratch (one buffer from the wrapper): W, then for C2 dG, dW and
// the depth chunks' partials; every piece starts 16-byte aligned
template <typename T>
size_t up16(size_t n) {
    constexpr size_t V = 16 / sizeof(T);
    return (n + V - 1) / V * V;
}

template <typename T>
struct Scratch {
    int ldw;                      // W's row stride, U padded to 16 bytes
    size_t w, dg, dw, part, total;    // offsets and size, elements
    Scratch(int S, int U, int K, int Mh, bool bwd) {
        const size_t SK = (size_t)S * K;
        ldw = (int)up16<T>(U);
        w = 0;
        dg = 2 * SK * ldw;
        if (!bwd) {
            total = dg;
            return;
        }
        dw = dg + 2 * up16<T>(SK * Mh);
        part = dw + 2 * up16<T>(SK * U);
        int dchunk;
        const int n2 = bwd_split<T>(2, S, U, K, Mh, dchunk);
        const int n3 = bwd_split<T>(3, S, U, K, Mh, dchunk);
        const size_t p2 = n2 > 1 ? 2 * n2 * up16<T>(SK * U) : 0;
        const size_t p3 = n3 > 1 ? 2 * n3 * up16<T>((size_t)U * Mh) : 0;
        total = part + (p2 > p3 ? p2 : p3);
    }
};

// Strides of a batched launch (a replica batch of the vmapped step): the
// elements from one replica's array to the next's, 0 for an array the
// batch shares; every output and the scratch are per replica.
struct Batch {
    int nb;
    size_t gbar, dq, a, bc, f0, cbw;
};

// W(r, u) = dq[s,u] (ar + i ai)[m1,u], r = s K + m1, row stride ldw;
// replica blockIdx.y, its W `ws` elements past the previous one's
template <typename T>
__global__ void w_kernel(const T* dq, const T* ar, const T* ai, T* wr,
                         T* wi, int S, int U, int K, int ldw, Batch bt,
                         size_t ws) {
    const size_t t = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (t >= (size_t)S * K * U) return;
    const size_t rep = blockIdx.y;
    dq += rep * bt.dq;
    ar += rep * bt.a;
    ai += rep * bt.a;
    wr += rep * ws;
    wi += rep * ws;
    const int u = (int)(t % U), r = (int)(t / U);
    const int s = r / K, m1 = r - s * K;
    const T w = dq[(size_t)s * U + u];
    wr[(size_t)r * ldw + u] = w * ar[(size_t)m1 * U + u];
    wi[(size_t)r * ldw + u] = w * ai[(size_t)m1 * U + u];
}

template <typename T>
int make_w(const T* dq, const T* ar, const T* ai, T* wr, T* wi, int S,
           int U, int K, int ldw, const Batch& bt, size_t ws,
           cudaStream_t st) {
    const size_t n = (size_t)S * K * U;
    if (bt.nb < 1 || bt.nb > 65535) return (int)cudaErrorInvalidValue;
    w_kernel<T><<<dim3((unsigned)((n + 255) / 256), bt.nb), 256, 0, st>>>(
        dq, ar, ai, wr, wi, S, U, K, ldw, bt, ws);
    return (int)cudaGetLastError();
}

// replica blockIdx.y: its partials `ps`, its outputs `os` elements past
// the previous replica's
template <typename T>
__global__ void fold_kernel(const T* part, int nz, size_t n, size_t zs,
                            T* outr, T* outi, size_t ps, size_t os) {
    const size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
    if (i >= n) return;
    const size_t rep = blockIdx.y;
    part += rep * ps;
    outr += rep * os;
    outi += rep * os;
    T sr = 0, si = 0;
    for (int z = 0; z < nz; ++z) {
        sr += part[zs * z + i];
        si += part[zs * z + zs / 2 + i];
    }
    outr[i] = sr;
    outi[i] = si;
}

// Sums over an axis j < n for outputs i < N, in a fixed order: lane l of
// block b owns output 32 b + l, warp w the terms j = w, w + 8, ...; the 8
// warp partials are folded in warp order.  term(i, j, a, b) adds to a, b.
// Replica blockIdx.y (term.at moves its arrays).
template <typename T, typename TERM>
__global__ void __launch_bounds__(256)
rowsum_kernel(TERM term, int N, int n) {
    __shared__ T pa[8][32], pb[8][32], extra;
    term.at(blockIdx.y);
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int i = blockIdx.x * 32 + lane;
    if (w == 0) term.block_init(lane, extra);
    T a = 0, b = 0;
    if (i < N)
        for (int j = w; j < n; j += 8) term(i, j, a, b);
    pa[w][lane] = a;
    pb[w][lane] = b;
    __syncthreads();
    if (w == 0 && i < N) {
        for (int v = 1; v < 8; ++v) {
            a += pa[v][lane];
            b += pb[v][lane];
        }
        term.store(i, a, b, extra);
    }
}

// The terms of C2's row sums.  at(rep) moves a term's arrays to replica
// rep: the scratch (dW, dG) ws elements a replica, the inputs by the
// batch's strides, the outputs os elements a replica.
template <typename T>
struct DdqTerm {          // ddq[s,u] = sum_m1 Re(dW[s,m1,u] conj(A[m1,u]))
    const T *dwr, *dwi, *ar, *ai;
    T* ddq;
    int U, K;
    size_t ws, a_bs, os;
    __device__ void at(size_t rep) {
        dwr += rep * ws;
        dwi += rep * ws;
        ar += rep * a_bs;
        ai += rep * a_bs;
        ddq += rep * os;
    }
    __device__ void block_init(int, T&) const {}
    __device__ void operator()(int i, int m1, T& a, T&) const {
        const int s = i / U, u = i - s * U;
        const size_t o = ((size_t)s * K + m1) * U + u;
        a += dwr[o] * ar[(size_t)m1 * U + u] + dwi[o] * ai[(size_t)m1 * U + u];
    }
    __device__ void store(int i, T a, T, T) const { ddq[i] = a; }
};

template <typename T>
struct DaTerm {           // dA[m1,u] = sum_s dW[s,m1,u] dq[s,u]
    const T *dwr, *dwi, *dq;
    T *dar, *dai;
    int U, K;
    size_t ws, dq_bs, os;
    __device__ void at(size_t rep) {
        dwr += rep * ws;
        dwi += rep * ws;
        dq += rep * dq_bs;
        dar += rep * os;
        dai += rep * os;
    }
    __device__ void block_init(int, T&) const {}
    __device__ void operator()(int i, int s, T& a, T& b) const {
        const int u = i % U;
        const size_t o = (size_t)s * K * U + i;
        const T w = dq[(size_t)s * U + u];
        a += dwr[o] * w;
        b += dwi[o] * w;
    }
    __device__ void store(int i, T a, T b, T) const {
        dar[i] = a;
        dai[i] = b;
    }
};

template <typename T>
struct Df0Term {          // dF0 = sum_s dG - (sum_s gbar) cbw F0
    const T *dgr, *dgi, *gbar, *f0r, *f0i, *cbw;
    T *df0r, *df0i;
    int S, KMh;
    size_t ws, g_bs, f0_bs, cbw_bs, os;
    __device__ void at(size_t rep) {
        dgr += rep * ws;
        dgi += rep * ws;
        gbar += rep * g_bs;
        f0r += rep * f0_bs;
        f0i += rep * f0_bs;
        cbw += rep * cbw_bs;
        df0r += rep * os;
        df0i += rep * os;
    }
    __device__ void block_init(int lane, T& gsum) const {
        T v = 0;
        for (int s = lane; s < S; s += 32) v += gbar[s];
        v = warp_sum(v);
        if (lane == 0) gsum = v;
    }
    __device__ void operator()(int i, int s, T& a, T& b) const {
        a += dgr[(size_t)s * KMh + i];
        b += dgi[(size_t)s * KMh + i];
    }
    __device__ void store(int i, T a, T b, T gsum) const {
        df0r[i] = a - gsum * cbw[i] * f0r[i];
        df0i[i] = b - gsum * cbw[i] * f0i[i];
    }
};

template <typename T, typename TERM>
void rowsum(TERM term, int N, int n, int nb, cudaStream_t st) {
    rowsum_kernel<T, TERM><<<dim3((N + 31) / 32, nb), 256, 0, st>>>(term, N,
                                                                     n);
}

// C1 of nb replicas (Batch: the inputs' strides); partial holds nb
// replicas' (S K, ncb) partials, scratch nb Scratch(fwd) totals
template <typename T>
int perstate_fwd(const T* dq, const T* ar, const T* ai, const T* bcr,
                 const T* bci, const T* f0r, const T* f0i, const T* cbw,
                 T* partial, T* scratch, cudaStream_t st, int S, int U, int K,
                 int Mh, const Batch& bt) {
    const Scratch<T> sc(S, U, K, Mh, false);
    const size_t SK = (size_t)S * K, ws = sc.total;
    T *wr = scratch + sc.w, *wi = wr + SK * sc.ldw;
    int err = make_w(dq, ar, ai, wr, wi, S, U, K, sc.ldw, bt, ws, st);
    if (err) return err;
    const int ncb = (Mh + Cfg<T>::BN - 1) / Cfg<T>::BN;
    return cgemm<T>(
        arr_op<true, false>((const T*)wr, (const T*)wi, sc.ldw, ws),
        arr_op<false, false>(bcr, bci, Mh, bt.bc),
        EnergyEpi<T>{f0r, f0i, cbw, partial, K, Mh, ncb, bt.f0, bt.cbw,
                     SK * ncb},
        S * K, Mh, U, 1, U, bt.nb, st);
}

// C2 of nb replicas: every output holds nb replicas' values in order,
// scratch nb Scratch(bwd) totals
template <typename T>
int perstate_bwd(const T* gbar, const T* dq, const T* ar, const T* ai,
                 const T* bcr, const T* bci, const T* f0r, const T* f0i,
                 const T* cbw, T* scratch, T* ddq, T* dar, T* dai, T* dbcr,
                 T* dbci, T* df0r, T* df0i, cudaStream_t st, int S, int U,
                 int K, int Mh, const Batch& bt) {
    const Scratch<T> sc(S, U, K, Mh, true);
    const int SK = S * K, th = 256, nb = bt.nb;
    const size_t ws = sc.total, KU = (size_t)K * U, UMh = (size_t)U * Mh,
                 KMh = (size_t)K * Mh;
    T *wr = scratch + sc.w, *wi = wr + (size_t)SK * sc.ldw;
    T *dgr = scratch + sc.dg, *dgi = dgr + up16<T>((size_t)SK * Mh);
    T *dwr = scratch + sc.dw, *dwi = dwr + up16<T>((size_t)SK * U);
    T* part = scratch + sc.part;
    int err = make_w(dq, ar, ai, wr, wi, S, U, K, sc.ldw, bt, ws, st);
    if (err) return err;
    // dG = gbar cbw (F0 + G), G recomputed
    err = cgemm<T>(
        arr_op<true, false>((const T*)wr, (const T*)wi, sc.ldw, ws),
        arr_op<false, false>(bcr, bci, Mh, bt.bc),
        DGEpi<T>{gbar, f0r, f0i, cbw, dgr, dgi, K, Mh, bt.gbar, bt.f0,
                 bt.cbw, ws},
        SK, Mh, U, 1, U, nb, st);
    if (err) return err;
    // dW (S K, U) = dG conj(BC)^T, depth Mh
    int dchunk;
    int nz = bwd_split<T>(2, S, U, K, Mh, dchunk);
    size_t n = (size_t)SK * U, zs = 2 * up16<T>(n);
    err = cgemm<T>(
        arr_op<true, false>((const T*)dgr, (const T*)dgi, Mh, ws),
        arr_op<true, true>(bcr, bci, Mh, bt.bc),
        nz == 1 ? DWEpi<T>{{dwr, dwi, U, 0, ws}}
                : DWEpi<T>{{part, part + zs / 2, U, zs, ws}},
        SK, U, Mh, nz, dchunk, nb, st);
    if (err) return err;
    if (nz > 1)
        fold_kernel<T><<<dim3((unsigned)((n + th - 1) / th), nb), th, 0,
                         st>>>(part, nz, n, zs, dwr, dwi, ws, ws);
    // dBC (U, Mh) = conj(W)^T dG, depth S K in whole states
    nz = bwd_split<T>(3, S, U, K, Mh, dchunk);
    n = UMh;
    zs = 2 * up16<T>(n);
    err = cgemm<T>(
        arr_op<false, true>((const T*)wr, (const T*)wi, sc.ldw, ws),
        arr_op<false, false>((const T*)dgr, (const T*)dgi, Mh, ws),
        nz == 1 ? DBCEpi<T>{{dbcr, dbci, Mh, 0, UMh}}
                : DBCEpi<T>{{part, part + zs / 2, Mh, zs, ws}},
        U, Mh, SK, nz, dchunk, nb, st);
    if (err) return err;
    if (nz > 1)
        fold_kernel<T><<<dim3((unsigned)((n + th - 1) / th), nb), th, 0,
                         st>>>(part, nz, n, zs, dbcr, dbci, ws, UMh);
    rowsum<T>(DdqTerm<T>{dwr, dwi, ar, ai, ddq, U, K, ws, bt.a,
                         (size_t)S * U},
              S * U, K, nb, st);
    rowsum<T>(DaTerm<T>{dwr, dwi, dq, dar, dai, U, K, ws, bt.dq, KU},
              K * U, S, nb, st);
    rowsum<T>(Df0Term<T>{dgr, dgi, gbar, f0r, f0i, cbw, df0r, df0i, S,
                         K * Mh, ws, bt.gbar, bt.f0, bt.cbw, KMh},
              K * Mh, S, nb, st);
    return (int)cudaGetLastError();
}

}  // namespace

// columns of C1's output tiles: its partials per row
KERNELS_API int perstate_tile_cols(int f64) {
    return f64 ? Cfg<double>::BN : Cfg<float>::BN;
}

// elements of scratch the C1 (bwd 0) or C2 (bwd 1) entry point takes
KERNELS_API int perstate_scratch(int f64, int bwd, int S, int U, int K,
                                 int Mh) {
    return f64 ? (int)Scratch<double>(S, U, K, Mh, bwd).total
               : (int)Scratch<float>(S, U, K, Mh, bwd).total;
}

// nb replicas; *_bs: the elements between two replicas' arrays of an
// input (0: one array shared by the batch); partial, scratch and every
// output hold nb replicas' in order
#define PERSTATE_API(SUF, T)                                                 \
    KERNELS_API int perstate_fwd_##SUF(                                     \
        const void* dq, const void* ar, const void* ai, const void* bcr,    \
        const void* bci, const void* f0r, const void* f0i, const void* cbw, \
        void* partial, void* scratch, void* st, int S, int U, int K,        \
        int Mh, int nb, int dq_bs, int a_bs, int bc_bs, int f0_bs,          \
        int cbw_bs) {                                                       \
        const Batch bt{nb, 0, (size_t)dq_bs, (size_t)a_bs, (size_t)bc_bs,  \
                       (size_t)f0_bs, (size_t)cbw_bs};                      \
        return perstate_fwd<T>((const T*)dq, (const T*)ar, (const T*)ai,    \
                               (const T*)bcr, (const T*)bci, (const T*)f0r, \
                               (const T*)f0i, (const T*)cbw, (T*)partial,   \
                               (T*)scratch, (cudaStream_t)st, S, U, K, Mh,  \
                               bt);                                         \
    }                                                                       \
    KERNELS_API int perstate_bwd_##SUF(                                     \
        const void* gbar, const void* dq, const void* ar, const void* ai,   \
        const void* bcr, const void* bci, const void* f0r, const void* f0i, \
        const void* cbw, void* scratch, void* ddq, void* dar, void* dai,    \
        void* dbcr, void* dbci, void* df0r, void* df0i, void* st, int S,    \
        int U, int K, int Mh, int nb, int gbar_bs, int dq_bs, int a_bs,     \
        int bc_bs, int f0_bs, int cbw_bs) {                                 \
        const Batch bt{nb, (size_t)gbar_bs, (size_t)dq_bs, (size_t)a_bs,   \
                       (size_t)bc_bs, (size_t)f0_bs, (size_t)cbw_bs};       \
        return perstate_bwd<T>(                                             \
            (const T*)gbar, (const T*)dq, (const T*)ar, (const T*)ai,       \
            (const T*)bcr, (const T*)bci, (const T*)f0r, (const T*)f0i,     \
            (const T*)cbw, (T*)scratch, (T*)ddq, (T*)dar, (T*)dai,          \
            (T*)dbcr, (T*)dbci, (T*)df0r, (T*)df0i, (cudaStream_t)st, S, U, \
            K, Mh, bt);                                                     \
    }

PERSTATE_API(f32, float)
PERSTATE_API(f64, double)
