// Kernel F: the fixed-order segment sum.
//
// out[r, t, c] = sum of src[r, m, c] over every m with idx[r, m] = t,
// taken in ascending m, for rows t < n and columns c < d.
//
// Replaces no TPU kernel.  It is the backward of the step's gathers on
// positions (ops/kernels/segment_sum.py take_rows: x[j] over the pair
// rows, the couplings' atoms, the bonded terms' sites, the repulsion's
// rows), which torch's indexing backward, scatter_add and index_add sum
// with atomics on the card, in an order that changes from run to run.
// On the TPU the JAX step's scatter-adds run in their compiled order, so
// one input gives one result there; this kernel gives the port the same.
//
// The order is handed in: perm lists the entries m of every row t in
// ascending (t, m) and off[t] .. off[t + 1] are row t's (the wrapper
// sorts integer keys idx * M + m on the card, which is exact).  One
// thread owns one (t, c) element and adds its row's entries into one
// register in ascending m: no floating-point atomics, no shared memory,
// one writer an element, and the sums round as the CPU's index_add does
// (0 + s_1 + s_2 + ..., no fused multiply-add).  Four entries' loads are
// issued ahead of their adds, which stay in order.
//
// A batch of nb replicas is one launch, blockIdx.y the replica:
//  - idx shared by the batch: perm and off are one replica's (off_bs 0),
//    src and out advance by src_bs and out_bs elements a replica;
//  - idx batched: perm indexes the stacked (nb * M) entries (src_bs 0)
//    and off holds nb * n + 1 offsets, replica r's rows starting at
//    r * n (off_bs = n).
// Each replica's element is summed in the same order as a launch of that
// replica alone, so the batch equals its single launches bit for bit.
//
// Bound: bytes.  src is read once (each entry feeds one element), perm
// and off once, out written once: at the flagship's x[j] backward (~44k
// entries of 3 fp64 values) ~1.5 MB, 0.45 us at 3.35 TB/s.  The kernel
// is bound by the latency of its dependent loads (perm, then src) over
// a few thousand threads; PERF.md has the times.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ src,
                   const long long* __restrict__ perm,
                   const long long* __restrict__ off, T* __restrict__ out,
                   int n, int d, int src_bs, int off_bs, int out_bs) {
    const int r = blockIdx.y;
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)n * d) return;
    const int t = (int)(e / d);
    const int c = (int)(e - (long long)t * d);
    const long long* o = off + (long long)r * off_bs;
    const T* s = src + (long long)r * src_bs + c;
    const long long k1 = o[t + 1];
    long long k = o[t];
    T acc = T(0);
    for (; k + 4 <= k1; k += 4) {
        const long long p0 = perm[k], p1 = perm[k + 1], p2 = perm[k + 2],
                        p3 = perm[k + 3];
        const T v0 = s[p0 * d], v1 = s[p1 * d], v2 = s[p2 * d],
                v3 = s[p3 * d];
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
    }
    for (; k < k1; ++k) acc += s[perm[k] * d];
    out[(long long)r * out_bs + e] = acc;
}

template <typename T>
int segment_sum_launch(const void* src, const void* perm, const void* off,
                       void* out, void* stream, int n, int d, int nb,
                       int src_bs, int off_bs, int out_bs) {
    const long long elems = (long long)n * d;
    if (elems == 0 || nb == 0) return (int)cudaGetLastError();
    const dim3 grid((unsigned)((elems + kThreads - 1) / kThreads),
                    (unsigned)nb);
    segment_sum_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)src, (const long long*)perm, (const long long*)off,
        (T*)out, n, d, src_bs, off_bs, out_bs);
    return (int)cudaGetLastError();
}

}  // namespace

#define SEGMENT_ENTRY(SUF, T)                                              \
    KERNELS_API int segment_sum_##SUF(                                     \
        const void* src, const void* perm, const void* off, void* out,    \
        void* stream, int n, int d, int nb, int src_bs, int off_bs,       \
        int out_bs) {                                                      \
        return segment_sum_launch<T>(src, perm, off, out, stream, n, d,   \
                                     nb, src_bs, off_bs, out_bs);         \
    }
SEGMENT_ENTRY(f32, float)
SEGMENT_ENTRY(f64, double)
