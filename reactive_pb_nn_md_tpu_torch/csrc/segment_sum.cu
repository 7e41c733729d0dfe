// Kernel F: the fixed-order segment sum, with the order it sums in.
//
// out[r, t, c] = sum of src[r, m, c] over every m with idx[r, m] = t,
// taken in ascending m, for rows t < n and columns c < d.  An entry
// idx < 0 is padding and an entry idx >= n is out of range: neither adds
// to any row.
//
// Replaces no TPU kernel.  It is the backward of the step's gathers on
// positions (ops/kernels/segment_sum.py take_rows: x[j] over the pair
// rows, the couplings' atoms, the bonded terms' sites, the repulsion's
// rows), which torch's indexing backward, scatter_add and index_add sum
// with atomics on the card, in an order that changes from run to run.
// On the TPU the JAX step's scatter-adds run in their compiled order, so
// one input gives one result there; this kernel gives the port the same.
//
// At most three launches a call, no atomic operation of any kind, no host
// read:
//
//  1. segment_tile_sort_kernel, a block a tile of kTile consecutive
//     entries: a bitonic sort in shared memory of the keys
//     bucket * kTile + i (i the entry's place in the tile, so the keys
//     are unique and the sort is stable in m), where a bucket is a run
//     of 2^rb_shift rows, padding is bucket 0 and rows beyond n the last.
//     It writes the tile's entries of the real buckets in that order,
//     each as (row << 32 | m), and, for every bucket c, the number of the
//     tile's entries in buckets <= c (a search in the sorted keys):
//     start[c][tile].
//  2. segment_bucket_order_kernel, a block a bucket: its entries are the
//     tiles' runs start[k][b] .. start[k + 1][b], taken in ascending
//     tile, hence in ascending m.  Their number and the count of every
//     entry before the bucket (padding included) come from the column
//     of start alone, by integer scans.  The block takes the list in
//     chunks of kChunk, sorts each by the key (row in the bucket) * kChunk
//     + place, counts each row's entries, scans the counts into the rows'
//     offsets (written to off), and places every entry in perm: row t's
//     entries are perm[off[t] .. off[t + 1]] in ascending m.  A bucket of
//     one chunk is sorted once; a longer one twice (count, then place).
//     This is segment_order's (perm, off) (ops/kernels/segment_sum.py,
//     the torch-sort order, its plain version) on [off[0], off[n]): the
//     padding's places perm[0 .. off[0]] are left unwritten.
//     An index of one tile (M <= kTile) into at most kDirectRows rows
//     skips kernel 2: kernel 1 takes every row as a bucket, and its
//     sorted tile and its counts are perm (padding first, as in
//     segment_order) and off.
//  3. segment_sum_kernel: one thread owns one (r, t, c) element and adds
//     its row's entries into one register in ascending m: no
//     floating-point atomics, no shared memory, one writer an element,
//     and the sums round as the CPU's index_add does (0 + s_1 + s_2 +
//     ..., no fused multiply-add).  Four entries' loads are issued ahead
//     of their adds, which stay in order.
//
// A batch of nb replicas is one launch of each, blockIdx.y the replica:
// an index shared by the batch is ordered once (nbi = 1, perm_bs = off_bs
// = 0); a batched one (nbi = nb) orders each replica's rows on its own.
// Rows and entries are a replica's own, so the 32-bit keys bound n and M
// of one replica, not nb n; every offset across replicas, tiles or
// columns is 64-bit.  Each replica's element is summed in the same order
// as a launch of that replica alone, so the batch equals its single
// launches bit for bit.
//
// Bound: bytes.  src is read once (each entry feeds one element), idx
// once, out written once: at the flagship's largest call (19,392 entries
// into 649 rows of 3, fp64) ~0.64 MB, 0.19 us at 3.35 TB/s.  The sorts
// are latency-bound, one block's chain of stages: those whose pairs lie
// within 64 keys run in a warp's registers (shuffles, no barrier), the
// others in shared memory with a barrier each (15 of 66 stages at 2048
// keys), and the first kernel's block is sized to its keys and searches.
// The sum is bound by its longest row (one thread loops over a row's
// entries: splitting it would change the order of the adds).  PERF.md
// has the times.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;         // the sum
constexpr int kSortThreads = 1024;    // the two order kernels
constexpr int kTile = 2048;           // entries a tile (kernel 1)
constexpr int kChunk = 4096;          // a bucket's entries sorted at once
constexpr unsigned kNoKey = 0xffffffffu;
// an index of one tile into at most this many rows is ordered by the
// first kernel alone, a row a bucket (its row offsets: n + 1 searches)
constexpr int kDirectRows = 16384;

// the stages (k, j), j = jmax, jmax / 2, .., 1 (jmax <= 32), of a bitonic
// sort on the 64 keys s[64 seg ..] one warp holds in registers: a0 the
// lane's key at 64 seg + lane, a1 at 64 seg + 32 + lane
__device__ __forceinline__ void warp_stages(unsigned& a0, unsigned& a1,
                                            int seg, int k, int jmax) {
    const int lane = threadIdx.x & 31;
    const int e0 = 64 * seg + lane;
    const bool asc0 = (e0 & k) == 0, asc1 = ((e0 + 32) & k) == 0;
    for (int j = jmax; j > 0; j >>= 1) {
        if (j == 32) {
            if ((a0 > a1) == asc0) {
                const unsigned t = a0;
                a0 = a1;
                a1 = t;
            }
        } else {
            const unsigned b0 = __shfl_xor_sync(0xffffffffu, a0, j);
            const unsigned b1 = __shfl_xor_sync(0xffffffffu, a1, j);
            const bool lower = (lane & j) == 0;
            a0 = asc0 == lower ? min(a0, b0) : max(a0, b0);
            a1 = asc1 == lower ? min(a1, b1) : max(a1, b1);
        }
    }
}

// the warp stages of merge size k (k <= 64: all of them, from k / 2; else
// j = 32 .. 1) on every 64-key segment, a warp a segment
__device__ __forceinline__ void segment_stages(unsigned* s, int p, int k) {
    const int lane = threadIdx.x & 31;
    for (int seg = threadIdx.x >> 5; seg < p / 64; seg += blockDim.x >> 5) {
        unsigned a0 = s[64 * seg + lane], a1 = s[64 * seg + 32 + lane];
        if (k <= 64) {
            for (int kk = 2; kk <= 64; kk <<= 1)
                warp_stages(a0, a1, seg, kk, kk >> 1);
        } else {
            warp_stages(a0, a1, seg, k, 32);
        }
        s[64 * seg + lane] = a0;
        s[64 * seg + 32 + lane] = a1;
    }
    __syncthreads();
}

// ascending bitonic sort of s[0, p), p a power of two >= 64; the caller
// has synchronized after filling s.  Stages whose pairs lie within 64
// keys run in a warp's registers (shuffles, no barrier), the others in
// shared memory, a barrier each
__device__ void block_sort(unsigned* s, int p) {
    segment_stages(s, p, 64);
    for (int k = 128; k <= p; k <<= 1) {
        for (int j = k >> 1; j >= 64; j >>= 1) {
            for (int t = threadIdx.x; t < p / 2; t += blockDim.x) {
                const int i = 2 * t - (t & (j - 1));
                const int l = i + j;
                const unsigned a = s[i], b = s[l];
                if ((a > b) == ((i & k) == 0)) {
                    s[i] = b;
                    s[l] = a;
                }
            }
            __syncthreads();
        }
        segment_stages(s, p, k);
    }
}

// keys a sort pads to: a power of two, at least the 64 a warp holds
__device__ __forceinline__ int sort_size(int len) {
    int p = 64;
    while (p < len) p <<= 1;
    return p;
}

// exclusive prefix sum of v over the block's threads in thread order (an
// integer scan, exact); *total gets the sum of all.  Every thread calls.
__device__ int block_exscan(int v, int* warp_tot, int* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    int x = v;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_tot[w] = x;
    __syncthreads();
    if (w == 0) {
        int s = lane < nw ? warp_tot[lane] : 0;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, s, o);
            if (lane >= o) s += y;
        }
        if (lane < nw) warp_tot[lane] = s;
    }
    __syncthreads();
    const int before = (w ? warp_tot[w - 1] : 0) + x - v;
    *total = warp_tot[nw - 1];
    __syncthreads();
    return before;
}

// perm: null, or (one tile, rows as buckets) the order itself: every
// place of the sorted tile as perm, start the row offsets off
__global__ void __launch_bounds__(kSortThreads)
segment_tile_sort_kernel(const long long* __restrict__ idx,
                         long long* __restrict__ ent,
                         int* __restrict__ start, int* __restrict__ perm,
                         int m, int n, int nt, int nbk, int rb_shift) {
    __shared__ unsigned key[kTile];
    __shared__ int row[kTile];
    const int b = blockIdx.x, r = blockIdx.y;
    const int t0 = b * kTile;
    const int len = min(kTile, m - t0);
    const int p = sort_size(len);
    const long long* id = idx + (long long)r * m + t0;
    for (int i = threadIdx.x; i < p; i += blockDim.x) {
        unsigned k = kNoKey;
        if (i < len) {
            const long long v = id[i];
            const unsigned bk = v < 0 ? 0u
                                : v >= n ? (unsigned)nbk + 1u
                                         : 1u + (unsigned)(v >> rb_shift);
            k = bk * kTile + (unsigned)i;
            row[i] = (int)v;
        }
        key[i] = k;
    }
    __syncthreads();
    block_sort(key, p);
    long long* e = ent + ((long long)r * nt + b) * kTile;
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
        const unsigned k = key[j];
        const unsigned bk = k / kTile;
        const int i = (int)(k % kTile);
        if (perm) perm[(long long)r * m + j] = i;
        else if (bk >= 1u && bk <= (unsigned)nbk)
            e[j] = ((long long)row[i] << 32) | (unsigned)(t0 + i);
    }
    int* st = start + (long long)r * (nbk + 1) * nt + b;
    for (int c = threadIdx.x; c <= nbk; c += blockDim.x) {
        const unsigned below = (unsigned)(c + 1) * kTile;
        int lo = 0, hi = len;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (key[mid] < below) lo = mid + 1;
            else hi = mid;
        }
        st[(long long)c * nt] = lo;
    }
}

// one chunk of bucket k's list (positions p0 .. p0 + len) into key / cm,
// sorted by (row in the bucket, place), and each row's run in it
__device__ void bucket_chunk(const long long* __restrict__ ent,
                             const int* s0, const int* so, unsigned* key,
                             int* cm, int* runs, int* rune, int p0,
                             int len, int nt, int rb, int row0) {
    for (int rl = threadIdx.x; rl < rb; rl += blockDim.x) {
        runs[rl] = 0;
        rune[rl] = 0;
    }
    const int p = sort_size(len);
    for (int j = threadIdx.x; j < p; j += blockDim.x) {
        unsigned k = kNoKey;
        if (j < len) {
            const int q = p0 + j;
            // the tile holding place q: the last b with so[b] <= q (an
            // empty tile shares its offset with the next)
            int lo = 0, hi = nt - 1;
            while (lo < hi) {
                const int mid = (lo + hi + 1) >> 1;
                if (so[mid] <= q) lo = mid;
                else hi = mid - 1;
            }
            const long long e =
                ent[(long long)lo * kTile + s0[lo] + (q - so[lo])];
            cm[j] = (int)(unsigned)e;
            k = (unsigned)((int)(e >> 32) - row0) * kChunk + (unsigned)j;
        }
        key[j] = k;
    }
    __syncthreads();
    block_sort(key, p);
    for (int j = threadIdx.x; j < len; j += blockDim.x) {
        const unsigned rl = key[j] / kChunk;
        if (j == 0 || key[j - 1] / kChunk != rl) runs[rl] = j;
        if (j == len - 1 || key[j + 1] / kChunk != rl) rune[rl] = j + 1;
    }
    __syncthreads();
}

__global__ void __launch_bounds__(kSortThreads)
segment_bucket_order_kernel(const long long* __restrict__ ents,
                            const int* __restrict__ start,
                            int* __restrict__ perm, int* __restrict__ off,
                            int m, int n, int nt, int nbk, int rb_shift) {
    extern __shared__ int smem[];
    __shared__ int warp_tot[32];
    const int rb = 1 << rb_shift;
    unsigned* key = (unsigned*)smem;       // kChunk
    int* cm = smem + kChunk;               // kChunk: the chunk's m
    int* runs = cm + kChunk;               // rb: a row's run in the chunk
    int* rune = runs + rb;                 // rb
    int* cnt = rune + rb;                  // rb: a row's entries, placed
    int* rowoff = cnt + rb;                // rb
    int* s0 = rowoff + rb;                 // nt: the bucket's run a tile
    int* so = s0 + nt;                     // nt: its place in the list
    const int k = blockIdx.x, r = blockIdx.y;
    const int row0 = k << rb_shift;
    const long long* ent = ents + (long long)r * nt * kTile;
    const int* st = start + (long long)r * (nbk + 1) * nt;
    int* pr = perm + (long long)r * m;
    int* of = off + (long long)r * (n + 1);

    // the list: tile b's run st[k][b] .. st[k + 1][b]; before it come
    // sum_b st[k][b] entries (padding and the buckets below)
    const int g = (nt + blockDim.x - 1) / blockDim.x;
    const int b0 = min(nt, (int)threadIdx.x * g), b1 = min(nt, b0 + g);
    int mine = 0, below = 0;
    for (int b = b0; b < b1; ++b) {
        const int a = st[(long long)k * nt + b];
        s0[b] = a;
        const int z = st[(long long)(k + 1) * nt + b];
        so[b] = z - a;
        mine += z - a;
        below += a;
    }
    int total, base;
    int at = block_exscan(mine, warp_tot, &total);
    block_exscan(below, warp_tot, &base);
    for (int b = b0; b < b1; ++b) {
        const int c = so[b];
        so[b] = at;
        at += c;
    }
    for (int rl = threadIdx.x; rl < rb; rl += blockDim.x) cnt[rl] = 0;
    __syncthreads();

    const int chunks = (total + kChunk - 1) / kChunk;
    for (int pass = 0; pass < 2; ++pass) {
        for (int c = 0; c < chunks; ++c) {
            const int p0 = c * kChunk, len = min(kChunk, total - p0);
            if (pass == 0 || chunks > 1)
                bucket_chunk(ent, s0, so, key, cm, runs, rune, p0, len, nt,
                             rb, row0);
            if (pass == 1) {
                for (int j = threadIdx.x; j < len; j += blockDim.x) {
                    const int rl = (int)(key[j] / kChunk);
                    pr[base + rowoff[rl] + cnt[rl] + (j - runs[rl])] =
                        cm[key[j] % kChunk];
                }
                __syncthreads();
            }
            for (int rl = threadIdx.x; rl < rb; rl += blockDim.x)
                cnt[rl] += rune[rl] - runs[rl];
            __syncthreads();
        }
        if (pass == 0) {
            // the rows' offsets; the counts restart for the placing pass
            int rows_total;
            const int v = (int)threadIdx.x < rb ? cnt[threadIdx.x] : 0;
            const int ex = block_exscan(v, warp_tot, &rows_total);
            if ((int)threadIdx.x < rb) {
                rowoff[threadIdx.x] = ex;
                cnt[threadIdx.x] = 0;
                if (row0 + (int)threadIdx.x < n)
                    of[row0 + threadIdx.x] = base + ex;
            }
            if (k == nbk - 1 && threadIdx.x == 0) of[n] = base + total;
            __syncthreads();
            if (total == 0) return;
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ src, const int* __restrict__ perm,
                   const int* __restrict__ off, T* __restrict__ out, int n,
                   int d, long long src_bs, long long perm_bs,
                   long long off_bs) {
    const int r = blockIdx.y;
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= (long long)n * d) return;
    const int t = (int)(e / d);
    const int c = (int)(e - (long long)t * d);
    const int* o = off + r * off_bs;
    const int* pm = perm + r * perm_bs;
    const T* s = src + r * src_bs + c;
    const int k1 = o[t + 1];
    int k = o[t];
    T acc = T(0);
    for (; k + 4 <= k1; k += 4) {
        const long long p0 = pm[k], p1 = pm[k + 1], p2 = pm[k + 2],
                        p3 = pm[k + 3];
        const T v0 = s[p0 * d], v1 = s[p1 * d], v2 = s[p2 * d],
                v3 = s[p3 * d];
        acc += v0;
        acc += v1;
        acc += v2;
        acc += v3;
    }
    for (; k < k1; ++k) acc += s[(long long)pm[k] * d];
    out[r * (long long)n * d + e] = acc;
}

int nbuckets(int n, int rb_shift) {
    return (n + (1 << rb_shift) - 1) >> rb_shift;
}

// the first kernel's block: a thread a pair of the keys it sorts and at
// most 8 searches a thread, 64 to kSortThreads threads
int tile_threads(int keys, int searches) {
    int t = 64;
    while (t < kSortThreads && (2 * t < keys || 8 * t < searches)) t <<= 1;
    return t;
}

size_t order_smem(int nt, int rb_shift) {
    return sizeof(int) * (2 * (size_t)kChunk + 4 * ((size_t)1 << rb_shift)
                          + 2 * (size_t)nt);
}

// kernels 1 and 2: perm (nbi, m) and off (nbi, n + 1) of idx (nbi, m);
// ent (nbi, nt, kTile) and start (nbi, nbk + 1, nt) are scratch
int order_launch(const void* idx, void* ent, void* start, void* perm,
                 void* off, cudaStream_t stream, int m, int n, int nbi,
                 int rb_shift) {
    if (n == 0 || nbi == 0) return (int)cudaGetLastError();
    const int nt = (m + kTile - 1) / kTile;
    if (nt == 1 && n <= kDirectRows) {
        // one tile: sorted by row, it is the order (one launch)
        segment_tile_sort_kernel<<<dim3(1, nbi), tile_threads(m, n + 1), 0,
                                   stream>>>(
            (const long long*)idx, nullptr, (int*)off, (int*)perm, m, n, 1,
            n, 0);
        return (int)cudaGetLastError();
    }
    const int nbk = nbuckets(n, rb_shift);
    const int tile = m < kTile ? m : kTile;
    if (nt > 0)
        segment_tile_sort_kernel<<<dim3(nt, nbi),
                                   tile_threads(tile, nbk + 1), 0, stream>>>(
            (const long long*)idx, (long long*)ent, (int*)start, nullptr, m,
            n, nt, nbk, rb_shift);
    const size_t smem = order_smem(nt, rb_shift);
    const int err = allow_smem((const void*)segment_bucket_order_kernel,
                               smem);
    if (err) return err;
    segment_bucket_order_kernel<<<dim3(nbk, nbi), kSortThreads, smem,
                                  stream>>>(
        (const long long*)ent, (const int*)start, (int*)perm, (int*)off, m,
        n, nt, nbk, rb_shift);
    return (int)cudaGetLastError();
}

template <typename T>
int segment_sum_launch(const void* src, const void* idx, void* ent,
                       void* start, void* perm, void* off, void* out,
                       void* stream, int m, int n, int d, int nb, int nbi,
                       int rb_shift) {
    const cudaStream_t s = (cudaStream_t)stream;
    const long long elems = (long long)n * d;
    if (elems == 0 || nb == 0) return (int)cudaGetLastError();
    const int err = order_launch(idx, ent, start, perm, off, s, m, n, nbi,
                                 rb_shift);
    if (err) return err;
    const dim3 grid((unsigned)((elems + kThreads - 1) / kThreads),
                    (unsigned)nb);
    const long long shared = nbi == 1 ? 0 : 1;
    segment_sum_kernel<T><<<grid, kThreads, 0, s>>>(
        (const T*)src, (const int*)perm, (const int*)off, (T*)out, n, d,
        (long long)m * d, shared * m, shared * (n + 1));
    return (int)cudaGetLastError();
}

}  // namespace

KERNELS_API int segment_order(const void* idx, void* ent, void* start,
                              void* perm, void* off, void* stream, int m,
                              int n, int nbi, int rb_shift) {
    return order_launch(idx, ent, start, perm, off, (cudaStream_t)stream, m,
                        n, nbi, rb_shift);
}

#define SEGMENT_ENTRY(SUF, T)                                              \
    KERNELS_API int segment_sum_##SUF(                                     \
        const void* src, const void* idx, void* ent, void* start,         \
        void* perm, void* off, void* out, void* stream, int m, int n,     \
        int d, int nb, int nbi, int rb_shift) {                            \
        return segment_sum_launch<T>(src, idx, ent, start, perm, off, out, \
                                     stream, m, n, d, nb, nbi, rb_shift);  \
    }
SEGMENT_ENTRY(f32, float)
SEGMENT_ENTRY(f64, double)
