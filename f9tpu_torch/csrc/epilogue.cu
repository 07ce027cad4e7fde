// The batch graph's epilogue on Hopper (sm_90a): one kernel pair.
//
// Replaces what XLA fuses on the TPU in f9tpu/pipeline/graph.py:188-271
// (mask, DC mean, gain, peak / RMS reductions, position-keyed TPDF dither,
// round, clip, routed-silent channels) plus f9tpu/ops/devcodec.py's
// interleaved pack.  No Pallas kernel computes it: the JAX graph writes the
// SRC output y once and lets each consumer fusion recompute
// z = where(valid, (y - mean) * g, 0) instead of writing z.  Its plain twin
// is f9tpu_torch/ops/epilogue.py:epilogue_reference, which this kernel
// matches bit for bit (codes, payload, sums of squares, peaks, means).
//
// What bounds it.  The function must read y once and write the codes
// once: at bench.py's shape (32 rows x 1,141,440 outputs, 146.1 MB of
// float32) that is 292.2 MB = 0.087 ms at 3.35 TB/s with int32 codes,
// 255.7 MB = 0.076 ms with the 24-bit payload.  The DC mean has to be known
// before the first code, and y (146 MB) outgrows the 50 MB L2, so a
// DC-removing epilogue reads y twice: 0.131 ms (int32) and 0.120 ms
// (payload) is this design's floor.  Measured on an H100 (PERF.md section
// 6), neither pass is at the memory rate: pass 1 reads at the rate torch's
// own reductions reach on this card (~2.2 TB/s), and pass 2 is bound by its
// consumers' instructions (about 36 a sample: the noise hash, the rounding,
// the clamp, the staging store), not by bytes in flight: its producer
// waits for a free stage three quarters of the time.
//
// Design: how bytes reach and leave the SMs.
//   * Persistent blocks.  Each pass launches k blocks per SM (k from the
//     occupancy of its shared memory, the SM count from the device), block
//     b walking units b, b + G, b + 2G, ...: a unit is one TILE = 4096
//     samples of one (file, channel) row in pass 1, TILE frames of one file
//     across its C channels in pass 2.  Pass 2 walks the units from the
//     last, so it starts on what pass 1 read last.
//   * A ring of shared-memory stages filled by the TMA.  A block is 8
//     consumer warps and one producer warp; one producer thread walks the
//     block's units ahead of the consumers and keeps up to NS (2-4) row
//     tiles of 16 KB in flight by 1-D bulk copies (full and empty
//     mbarriers, parity waits), across channels and across units, so the
//     next tiles arrive while the consumers run a tile's trees and stores.
//     A bulk copy needs 16-byte-aligned ends: it carries the aligned middle
//     of a tile's valid span, and the consumers load the (at most 3 + 3)
//     head and tail elements themselves; past the valid span they read 0.
//   * Stores through shared memory.  Pass 2 builds a row tile's int32 or
//     int16 codes (two buffers, so a store overlaps the next tile), or a
//     unit's interleaved payload bytes across all C channels (a 16-bit and
//     an 8-bit store a 24-bit sample, by address parity), in a staging
//     buffer at the output's own alignment, and writes its aligned middle
//     with one TMA bulk store (bulk groups; a buffer is written again only
//     after its store has read it); the few bytes outside the aligned
//     middle are stored by the threads.  A payload whose unit does not fit
//     beside a ring of 2 (4096 * C * bytes past ~184 KB: 24-bit buses of 16
//     channels and up, 16-bit of 23 and up) is stored by each thread in
//     place.
//   * L2 hints, not an access-policy window.  Pass 1 reads the units it
//     reaches last, about half the L2's bytes, with an evict_last policy and
//     the rest with evict_first; pass 2 reads y and writes the codes with
//     evict_first, which also drops the evict_last lines as it reads them,
//     so nothing stays in L2 past the pair and no stream attribute is set.
//   * Few instructions a sample: one rounding conversion (round to an int,
//     clamp as ints), the noise's 16-bit halves made floats by their bits,
//     and no checks on a tile whose samples are all valid and staged.
//
// What the design keeps, and why the results are the twin's bits.
//   * The reductions' order is the twin's halving tree: consumer thread t
//     holds tile elements t + 256k (read from the ring stage) and halves its
//     16 registers (k + 8, + 4, + 2, + 1); after one barrier warp 0 halves
//     over thread index (128, 64, 32) and shuffles (16 ... 1).  Every float
//     operation is an _rn intrinsic, so no FMA contraction moves a rounding.
//     A row's mean, sums and codes depend on its own samples only.
//   * Tile partials are folded without float atomics, behind integer
//     tickets per row (pass 1) and per file (pass 2).  A block takes the
//     tickets of all the units it walked at the end of its walk, after one
//     fence (a ticket per tile, fence and atomic in the consumers' path,
//     cost ~6 us a tile on an H100), and folds the rows or files it completed: each
//     row's partials in ascending order from +0.0 by one thread, streamed
//     through shared memory, then a file's channels in ascending order.
//     The strided walk spreads every row over every block, so the block
//     that finishes last folds them all; the folds run in parallel.
//   * Routed-silent channels come as a (C,) byte mask.  The stream's chunk
//     finish is pass 2 with no mask, no statistics and its absolute
//     position as the noise's base (pos0).
// Why CUDA and not Triton: bitwise control of every rounding (the twin is
// the specification), the TMA ring, and the ctypes build the SRC kernel
// already uses.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

#include "tma.cuh"

constexpr int TILE = 4096;
constexpr int THREADS = 256;             // the consumer threads: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = THREADS + 32;      // and the producer warp
constexpr int PER = TILE / THREADS;      // tile elements per thread
static_assert(PER == 16, "the register halving steps are written for 16");
constexpr int NS_MAX = 4;                // ring stages
constexpr int STAGE_FLOATS = TILE + 4;   // a tile at any 4-byte alignment
constexpr int STAGE_BYTES = STAGE_FLOATS * 4;
constexpr int MAX_DEVICES = 64;

template <bool B>
struct Bool {
    static constexpr bool value = B;
};

__device__ __forceinline__ uint32_t splitmix32(uint32_t h)
{
    h ^= h >> 16;
    h *= 0x21F0AAADu;
    h ^= h >> 15;
    h *= 0x735A2D97u;
    h ^= h >> 15;
    return h;
}

// x < 2^16 as a float (exact) by its bits: 2^23 + x, less 2^23, both exact;
// no conversion instruction (they issue at a quarter of the float rate)
__device__ __forceinline__ float u16_to_float(uint32_t x)
{
    return __fsub_rn(__uint_as_float(0x4B000000u | x), 8388608.0f);
}

// The NB low bytes of q, little-endian, at b: one 16-bit store (and one
// byte for NB = 3) where b is even, else the byte first.  For a stereo bus
// the parity is the same across a warp.
template <int NB>
__device__ __forceinline__ void store_le(unsigned char* b, uint32_t q)
{
    const bool even = (reinterpret_cast<uintptr_t>(b) & 1) == 0;
    if constexpr (NB == 2) {
        if (even) {
            *reinterpret_cast<unsigned short*>(b) = (unsigned short)q;
        } else {
            b[0] = (unsigned char)q;
            b[1] = (unsigned char)(q >> 8);
        }
    } else {
        if (even) {
            *reinterpret_cast<unsigned short*>(b) = (unsigned short)q;
            b[2] = (unsigned char)(q >> 16);
        } else {
            b[0] = (unsigned char)q;
            *reinterpret_cast<unsigned short*>(b + 1) = (unsigned short)(q >> 8);
        }
    }
}

// rint, clamp to [lo, hi] and truncate, as float32 and then int, in one
// conversion: round half to even to an int (saturating), clamped as ints.
// A NaN gives lo, as fmaxf(NaN, lo) did.  Equal for every float: an
// integral float outside [lo, hi] clamps to the same end either way.
__device__ __forceinline__ int round_clip(float v, int lo, int hi)
{
    return v != v ? lo : min(max(__float2int_rn(v), lo), hi);
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float fmax_nan(float m, float x)
{
    return (x > m || x != x) ? x : m;
}

// the consumer warps' barrier (named barrier 1; the producer never joins)
__device__ __forceinline__ void consumer_sync()
{
    asm volatile("bar.sync 1, %0;\n" :: "n"(THREADS) : "memory");
}

// A thread's part of the halving tree of one tile whose element t + 256k is
// thread t's v[k]: it halves its registers (k + 8, + 4, + 2, + 1).
__device__ __forceinline__ double thread_sum(const double (&v)[PER])
{
    double w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = __dadd_rn(v[k], v[k + 8]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __dadd_rn(w[k], w[k + 4]);
    w[0] = __dadd_rn(w[0], w[2]);
    w[1] = __dadd_rn(w[1], w[3]);
    return __dadd_rn(w[0], w[1]);
}

// thread_sum of the squares of z[k] (each exact in float64), squared as the
// first halving step reads them.
__device__ __forceinline__ double thread_sumsq(const float (&z)[PER])
{
    double w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        const double a = z[k], b = z[k + 8];
        w[k] = __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __dadd_rn(w[k], w[k + 4]);
    w[0] = __dadd_rn(w[0], w[2]);
    w[1] = __dadd_rn(w[1], w[3]);
    return __dadd_rn(w[0], w[1]);
}

// The rest of the tree, by warp 0 after one barrier of the consumers that
// follows every thread t's red[t] = thread_sum: halving over thread index
// (t + 128, then t + 64, then t + 32: lane l adds the pairs of l, l + 32,
// l + 64 and l + 96 in that order), then warp shuffles (16 ... 1).  The sum
// lands in lane 0.  The caller alternates two `red` arrays, so no second
// barrier guards this read.
__device__ __forceinline__ double warp0_tree(const double* red)
{
    const int l = threadIdx.x;
    const double r0 = __dadd_rn(red[l], red[l + 128]);
    const double r1 = __dadd_rn(red[l + 32], red[l + 160]);
    const double r2 = __dadd_rn(red[l + 64], red[l + 192]);
    const double r3 = __dadd_rn(red[l + 96], red[l + 224]);
    double s = __dadd_rn(__dadd_rn(r0, r2), __dadd_rn(r1, r3));
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    return s;
}

// warp0_tree's largest value (any order: max is exact).
__device__ __forceinline__ float warp0_max(const float* red)
{
    const int l = threadIdx.x;
    float m = fmax_nan(fmax_nan(red[l], red[l + 128]), fmax_nan(red[l + 32], red[l + 160]));
    m = fmax_nan(m, fmax_nan(fmax_nan(red[l + 64], red[l + 192]),
                             fmax_nan(red[l + 96], red[l + 224])));
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
        m = fmax_nan(m, __shfl_down_sync(0xffffffffu, m, off));
    return m;
}

// an asynchronous copy global -> shared of 8 bytes (no register round
// trip, so a thread's copies all go out before it waits once)
__device__ __forceinline__ void copy8_async(void* dst, const void* src)
{
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(smem_u32(dst)), "l"(src)
                 : "memory");
}

__device__ __forceinline__ void copies_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread started has landed
__device__ __forceinline__ void copies_wait()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the last committed group of this thread's copies have landed
__device__ __forceinline__ void copies_wait_prior()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// One row of tile partials to fold: `cnt` float64 sums at d.
struct FoldRow {
    const double* d;
    int cnt;
};

// Fold rows 0 .. nr-1 (nr <= THREADS; `row_of(i)` gives row i, at most
// `per` partials each) by the consumers: thread i adds row i's partials in
// ascending order from +0.0, ((0 + d[0]) + d[1]) + ..., into sums[i].  The
// partials stream through the free shared memory `buf` in chunks of w
// columns of every row, two chunks in flight by asynchronous copies, so a
// chunk's adds run while the next one lands.
template <typename RowOf>
__device__ __forceinline__ void fold_rows(int nr, RowOf row_of, int per, FoldRow* rows,
                                          unsigned char* buf, int buf_bytes, double* sums)
{
    const int tid = threadIdx.x;
    if (tid < nr) rows[tid] = row_of(tid);
    consumer_sync();
    if (nr == 0) return;
    // w = 2^lw columns a chunk, rows w + 1 apart (fewer bank conflicts)
    int lw = 0;
    while (((2LL << lw) + 1) * nr * 8 * 2 <= buf_bytes && (1 << lw) < per) ++lw;
    const int w = 1 << lw;
    double* region[2] = {reinterpret_cast<double*>(buf),
                         reinterpret_cast<double*>(buf) + (long long)(w + 1) * nr};
    // chunk c: columns [c * w, c * w + w) of every row
    auto load = [&](int c) {
        double* dst = region[c & 1];
        for (int idx = tid; idx < (nr << lw); idx += THREADS) {
            const int i = idx >> lw, j = idx & (w - 1);
            if ((c << lw) + j < rows[i].cnt)
                copy8_async(dst + i * (w + 1) + j, rows[i].d + (c << lw) + j);
        }
        copies_commit();
    };
    const int chunks = (per + w - 1) >> lw;
    double acc = 0.0;
    const int cnt = tid < nr ? rows[tid].cnt : 0;
    load(0);
    for (int c = 0; c < chunks; ++c) {
        if (c + 1 < chunks) {
            load(c + 1);
            copies_wait_prior();                 // chunk c has landed
        } else {
            copies_wait();
        }
        consumer_sync();
        const double* src = region[c & 1] + tid * (w + 1);
        const int n = min(w, cnt - (c << lw));
#pragma unroll 8
        for (int j = 0; j < n; ++j) acc = __dadd_rn(acc, src[j]);
        consumer_sync();                         // the region is loaded again
    }
    if (tid < nr) sums[tid] = acc;
    consumer_sync();
}

// What the TMA carries of a row tile's valid elements [0, cnt) at `src`:
// the bulk copy lands element e at stage[sh + e] for e in [e0, e1) (its
// 16-byte-aligned middle); the rest are loaded by the consumers.  e1 == e0:
// nothing by TMA.  Producer and consumers compute it alike.
struct Span {
    int sh, e0, e1;
};

__device__ __forceinline__ Span span_of(const float* src, long long cnt)
{
    Span s;
    s.sh = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    s.e0 = (4 - s.sh) & 3;
    const long long m = cnt - s.e0;
    s.e1 = m >= 4 ? s.e0 + (int)(m & ~3LL) : s.e0;
    return s;
}

// the producer's part for one row tile: wait for the stage, announce the
// bytes, start the copy.  Returns whether it used a stage.
__device__ __forceinline__ bool produce(float* ring, uint64_t* full, uint64_t* empty, int ns,
                                        int& slot, const float* src, long long cnt,
                                        uint64_t policy)
{
    if (cnt <= 0) return false;
    const Span sp = span_of(src, cnt);
    if (sp.e1 <= sp.e0) return false;
    const int s = slot % ns;
    const int round = slot / ns;
    if (round > 0) mbar_wait(empty + s, (uint32_t)((round + 1) & 1));
    const uint32_t bytes = 4u * (uint32_t)(sp.e1 - sp.e0);
    mbar_arrive_expect_tx(full + s, bytes);
    bulk_g2s_hint(ring + (long long)s * STAGE_FLOATS + sp.sh + sp.e0, src + sp.e0, bytes,
                  full + s, policy);
    ++slot;
    return true;
}

// The consumers' loads of one row tile (valid elements [0, cnt) at `src`,
// 0 past them): thread t's element t + 256k as float, from the ring stage
// or, for the head and tail, from memory.  Returns whether a stage holds
// the tile: the caller releases it (`release`) once it has used every
// value, not before.
template <typename T, bool STREAMING>
__device__ __forceinline__ bool consume(T (&v)[PER], const float* ring, uint64_t* full, int ns,
                                        int slot, const float* src, long long cnt)
{
    const int tid = threadIdx.x;
    Span sp{0, 0, 0};
    if (cnt > 0) sp = span_of(src, cnt);
    const bool staged = sp.e1 > sp.e0;
    const int s = slot % ns;
    if (staged) mbar_wait(full + s, (uint32_t)((slot / ns) & 1));
    const float* st = ring + (long long)s * STAGE_FLOATS + sp.sh;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int e = tid + THREADS * k;
        float x = 0.f;
        if (e >= sp.e0 && e < sp.e1) x = st[e];
        else if (e < cnt) x = STREAMING ? __ldcs(src + e) : __ldg(src + e);
        v[k] = (T)x;
    }
    return staged;
}

// Hand a stage back to the producer, after every value read from it has
// been used: an instruction that uses a loaded register waits for the load,
// so no read is still in flight when the next bulk copy overwrites the
// stage (releasing right after issuing the reads let a warp's last read
// meet the next tile's bytes on a 72-channel bus).  The proxy fence orders
// the reads (generic proxy) before that copy's writes (async proxy).
__device__ __forceinline__ void release(uint64_t* empty, int ns, int& slot, bool staged)
{
    if (!staged) return;
    fence_proxy_async_smem();
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + slot % ns);
    ++slot;
}

// Set up the ring's barriers (full: the producer's arrival plus the
// bytes; empty: one arrival per consumer warp).
__device__ __forceinline__ void ring_init(uint64_t* full, uint64_t* empty, int ns)
{
    if (threadIdx.x == 0) {
        for (int s = 0; s < ns; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, WARPS);
        }
        fence_mbarrier_init();
    }
    __syncthreads();
}

// The tickets of the block's walk steps base, base + G, ... (up to THREADS
// of them, one per consumer thread; step i is unit i, or unit units-1-i in
// a reverse walk): the counter `tickets[unit / per]` of each is raised by
// one after a fence of the partials this block wrote, and a counter that
// reaches `per` (its last ticket) is done: its index lands in `done`.
// Returns how many are done (block-uniform).
__device__ __forceinline__ int take_tickets(unsigned int* tickets, int per, long long base,
                                            int units, bool reverse, int* done, int& n_last)
{
    const int tid = threadIdx.x;
    if (tid == 0) n_last = 0;
    __threadfence();
    consumer_sync();
    const long long step = base + (long long)tid * gridDim.x;
    if (step < units) {
        const int i = (int)((reverse ? units - 1 - step : step) / per);
        if (atomicAdd(tickets + i, 1u) == (unsigned int)(per - 1))
            done[atomicAdd(&n_last, 1)] = i;
    }
    consumer_sync();
    const int n = n_last;
    if (n) __threadfence();                      // before the partials are read
    return n;
}

struct DcArgs {
    const float* y;
    const int* out_frames;
    double* tiles;                // (rows, n_tiles)
    float* mean;                  // (rows,)
    unsigned int* tickets;        // (rows,) zeroed
    int C;
    long long stride;
    long long keep;
    int n_tiles;
    int units;                    // rows * n_tiles
    int hot_from;                 // units from here on are read evict_last
    int ns;
};

// Pass 1: unit u = tile u % n_tiles of row u / n_tiles, read once (positions
// at or past the file's out_frames read as 0.0; a tile wholly past them is
// not read); its float64 sum goes to `tiles`, and the block that takes the
// row's last ticket folds the row into the float32 mean, __ddiv_rn then
// __double2float_rn, as the twin rounds it.
__global__ void __launch_bounds__(BLOCK, 3)
dc_pass(const DcArgs a)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double red[2][THREADS];           // alternate tiles
    __shared__ __align__(8) uint64_t full[NS_MAX], empty[NS_MAX];
    __shared__ int done[THREADS], n_last;
    __shared__ FoldRow rows[THREADS];
    float* ring = reinterpret_cast<float*>(smem);
    const int tid = threadIdx.x;
    ring_init(full, empty, a.ns);

    if (tid >= THREADS) {                        // the producer warp
        if (tid == THREADS) {
            const uint64_t keep_l2 = policy_evict_last(), drop_l2 = policy_evict_first();
            int slot = 0;
            for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
                const int row = u / a.n_tiles;
                const long long t0 = (long long)(u - row * a.n_tiles) * TILE;
                const long long n = min((long long)a.out_frames[row / a.C], a.keep);
                produce(ring, full, empty, a.ns, slot, a.y + row * a.stride + t0,
                        min((long long)TILE, n - t0), u >= a.hot_from ? keep_l2 : drop_l2);
            }
        }
        return;
    }

    int slot = 0, par = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
        const int row = u / a.n_tiles;
        const int tile = u - row * a.n_tiles;
        const long long n = min((long long)a.out_frames[row / a.C], a.keep);
        const long long t0 = (long long)tile * TILE;
        if (t0 < n) {                            // block-uniform
            double v[PER];
            const bool staged = consume<double, false>(
                v, ring, full, a.ns, slot, a.y + row * a.stride + t0, min((long long)TILE, n - t0));
            red[par][tid] = thread_sum(v);
            release(empty, a.ns, slot, staged);
            consumer_sync();
            if (tid < 32) {
                const double s = warp0_tree(red[par]);
                if (tid == 0) a.tiles[(long long)row * a.n_tiles + tile] = s;
            }
            par ^= 1;
        }
    }
    // the row's tickets, one per unit walked, all after the walk; the rows
    // this block completed are folded here, a thread each, from the ring
    for (long long base = blockIdx.x; base < a.units; base += (long long)THREADS * gridDim.x) {
        const int n_done = take_tickets(a.tickets, a.n_tiles, base, a.units, false, done, n_last);
        // a row's tiles past its file's end add +0.0: only the valid ones
        auto row_of = [&](int i) {
            const int row = done[i];
            const long long n = min((long long)a.out_frames[row / a.C], a.keep);
            return FoldRow{a.tiles + (long long)row * a.n_tiles, (int)((n + TILE - 1) / TILE)};
        };
        fold_rows(n_done, row_of, a.n_tiles, rows, smem, a.ns * STAGE_BYTES, red[0]);
        if (tid < n_done) {
            const int row = done[tid];
            const int frames = a.out_frames[row / a.C];
            a.mean[row] = __double2float_rn(__ddiv_rn(red[0][tid], (double)max(frames, 1)));
        }
        consumer_sync();                         // `done` is written again
    }
}

struct FinishArgs {
    const float* y;
    const int* out_frames;        // (files,) or null: nothing masked
    const long long* seeds;       // (files * C,) uint32 values, or null: no dither
    const float* gain_lin;        // (files,) or null
    const float* mean;            // (files * C,) or null: no DC removal
    const unsigned char* silent;  // (C,), nonzero = written as zeros; or null
    void* out;
    double* sq_tiles;             // (files * C, n_tiles)
    float* pk_tiles;              // (files * C, n_tiles)
    double* sumsq;                // (files,)
    float* peak;                  // (files,)
    unsigned int* tickets;        // (files,) zeroed
    int C;
    long long stride;
    long long keep;
    int n_tiles;
    int units;                    // files * n_tiles
    float scale;
    int lo, hi;                   // the codes' range: -scale, and clip_hi as an int
    float gain;
    long long pos0;
    int stats;
    int ns;                       // ring stages
    int nbuf;                     // staging buffers; 0: the payload is stored in place
    int buf_bytes;                // one staging buffer (a multiple of 16)
};

// Pass 2: unit u = frame tile u % n_tiles of file u / n_tiles across its C
// channels, walked from the last unit.  MODE 0: int32 codes (files, C,
// keep); 1: int16 codes; 2 and 3: the 16- and 24-bit interleaved payload
// (files, keep * C * nb).
template <int MODE>
__global__ void __launch_bounds__(BLOCK, 2)
finish_pass(const FinishArgs a)
{
    constexpr int NB = MODE == 3 ? 3 : 2;        // payload bytes per sample
    constexpr int ES = MODE == 0 ? 4 : 2;        // planar code bytes
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double red[2][THREADS];           // alternate tiles
    __shared__ float redf[2][THREADS];
    __shared__ __align__(8) uint64_t full[NS_MAX], empty[NS_MAX];
    __shared__ int done[THREADS], n_last;
    __shared__ FoldRow rows[THREADS];
    float* ring = reinterpret_cast<float*>(smem);
    unsigned char* staging = smem + (long long)a.ns * STAGE_BYTES;
    const int tid = threadIdx.x;
    const int C = a.C;
    ring_init(full, empty, a.ns);

    if (tid >= THREADS) {                        // the producer warp
        if (tid == THREADS) {
            const uint64_t drop_l2 = policy_evict_first();
            int slot = 0;
            for (int i = blockIdx.x; i < a.units; i += gridDim.x) {
                const int u = a.units - 1 - i;
                const int f = u / a.n_tiles;
                const long long t0 = (long long)(u - f * a.n_tiles) * TILE;
                const long long n =
                    a.out_frames ? min((long long)a.out_frames[f], a.keep) : a.keep;
                for (int c = 0; c < C; ++c)
                    produce(ring, full, empty, a.ns, slot,
                            a.y + ((long long)f * C + c) * a.stride + t0,
                            min((long long)TILE, n - t0), drop_l2);
            }
        }
        return;
    }

    const uint64_t drop_l2 = policy_evict_first();
    const long long row_bytes = a.keep * C * NB;
    int slot = 0, sidx = 0, par = 0;
    for (int i = blockIdx.x; i < a.units; i += gridDim.x) {
        const int u = a.units - 1 - i;
        const int f = u / a.n_tiles;
        const int tile = u - f * a.n_tiles;
        const long long t0 = (long long)tile * TILE;
        const long long n = a.out_frames ? min((long long)a.out_frames[f], a.keep) : a.keep;
        const int span = (int)min((long long)TILE, a.keep - t0);   // codes written
        const float g = a.gain_lin ? __fmul_rn(a.gain, a.gain_lin[f]) : a.gain;
        // the payload's unit: bytes [0, nbytes) at dst, staged at pay + p
        unsigned char* dst = (unsigned char*)a.out + (long long)f * row_bytes
                             + t0 * C * NB;
        unsigned char* pay = nullptr;
        if constexpr (MODE >= 2) {
            if (a.nbuf) {                        // block-uniform
                pay = staging + (long long)(sidx % a.nbuf) * a.buf_bytes
                      + (reinterpret_cast<uintptr_t>(dst) & 15);
                if (a.nbuf == 1) {               // its last store has read it
                    if (tid == 0) bulk_wait_read_all();
                    consumer_sync();
                }
            }
        }

        for (int c = 0; c < C; ++c) {
            const long long row = (long long)f * C + c;
            const float mu = a.mean ? a.mean[row] : 0.f;
            const uint32_t sh = a.seeds ? splitmix32((uint32_t)a.seeds[row]) : 0u;
            const bool mute = a.silent && a.silent[c];
            float yv[PER];
            const bool staged = consume<float, true>(
                yv, ring, full, a.ns, slot, a.y + row * a.stride + t0, min((long long)TILE, n - t0));
            // planar codes: element e at stg + e * ES, bytes [h0, h1) of the
            // tile's output by one bulk store, the rest by the threads
            unsigned char* out_row = (unsigned char*)a.out + (row * a.keep + t0) * ES;
            const int r = (int)(reinterpret_cast<uintptr_t>(out_row) & 15);
            const int h0 = (16 - r) & 15;
            const int h1 = max(((r + span * ES) & ~15) - r, h0);
            unsigned char* stg = staging + (long long)(sidx & 1) * a.buf_bytes + r;
            float m = 0.f;
            // every element valid, written and (planar codes) staged: no
            // checks per element (block-uniform)
            const bool whole = t0 + TILE <= n && span == TILE
                               && (MODE >= 2 || (h0 == 0 && h1 == TILE * ES));
            auto tile_codes = [&](auto whole_tile) {
                constexpr bool WHOLE = decltype(whole_tile)::value;
#pragma unroll
                for (int k = 0; k < PER; ++k) {
                    const int e = tid + THREADS * k;
                    const long long t = t0 + e;
                    float z = 0.f;
                    if (WHOLE || t < n) {
                        float v = yv[k];
                        if (a.mean) v = __fsub_rn(v, mu);
                        z = __fmul_rn(v, g);
                    }
                    yv[k] = z;            // z from here on
                    m = fmax_nan(m, fabsf(z));
                    if (!WHOLE && e >= span) continue;
                    int q = 0;
                    if ((WHOLE || t < n) && !mute) {
                        float v = __fmul_rn(z, a.scale);
                        if (a.seeds) {
                            const uint32_t h = splitmix32((uint32_t)(a.pos0 + t) ^ sh);
                            const float u1 =
                                __fmul_rn(u16_to_float(h & 0xFFFFu), 1.0f / 65536.0f);
                            const float u2 = __fmul_rn(u16_to_float(h >> 16), 1.0f / 65536.0f);
                            v = __fadd_rn(v, __fsub_rn(u1, u2));
                        }
                        q = round_clip(v, a.lo, a.hi);
                    }
                    if constexpr (MODE <= 1) {
                        const int off = e * ES;
                        const bool bulk = WHOLE || (off >= h0 && off < h1);
                        if constexpr (MODE == 0) {
                            if (bulk) *(int*)(stg + off) = q;
                            else __stcs((int*)(out_row + off), q);
                        } else {
                            if (bulk) *(short*)(stg + off) = (short)q;
                            else __stcs((short*)(out_row + off), (short)q);
                        }
                    } else {
                        unsigned char* b = pay ? pay + ((long long)e * C + c) * NB
                                               : dst + ((long long)e * C + c) * NB;
                        store_le<NB>(b, (uint32_t)q);
                    }
                }
            };
            if (whole) tile_codes(Bool<true>());
            else tile_codes(Bool<false>());
            release(empty, a.ns, slot, staged);          // every yv is used
            // the codes in shared memory before any bulk store reads them;
            // the buffer the next tile writes is the one the previous store
            // read: its read is waited for before the barrier
            if constexpr (MODE <= 1) {
                fence_proxy_async_smem();
                if (tid == 0) bulk_wait_read_all();
            }
            // block-uniform: a tile past the end sums to 0; the tree's one
            // barrier also orders the codes before the store
            const bool tree = a.stats && t0 < n;
            if (tree) {
                red[par][tid] = thread_sumsq(yv);
                redf[par][tid] = m;
            }
            if (tree || MODE <= 1) consumer_sync();
            if constexpr (MODE <= 1) {
                if (tid == 0 && h1 > h0) {
                    bulk_s2g_hint(out_row + h0, stg + h0, (uint32_t)(h1 - h0), drop_l2);
                    bulk_commit();
                }
                ++sidx;
            }
            if (a.stats && tid < 32) {
                const double s = tree ? warp0_tree(red[par]) : 0.0;
                const float mx = tree ? warp0_max(redf[par]) : 0.f;
                if (tid == 0) {
                    a.sq_tiles[row * a.n_tiles + tile] = s;
                    a.pk_tiles[row * a.n_tiles + tile] = mx;
                }
            }
            par ^= tree;
        }

        if constexpr (MODE >= 2) {
            if (a.nbuf) {                        // the unit's bytes, staged
                const int nbytes = span * C * NB;
                const int r = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
                const int h0 = min((16 - r) & 15, nbytes);
                const int h1 = max(((r + nbytes) & ~15) - r, h0);
                fence_proxy_async_smem();
                if (a.nbuf == 2 && tid == 0) bulk_wait_read_all();
                consumer_sync();
                for (int p = tid; p < h0; p += THREADS) dst[p] = pay[p];
                for (int p = h1 + tid; p < nbytes; p += THREADS) dst[p] = pay[p];
                if (tid == 0 && h1 > h0) {
                    bulk_s2g_hint(dst + h0, pay + h0, (uint32_t)(h1 - h0), drop_l2);
                    bulk_commit();
                }
                ++sidx;
            }
        }
    }
    if (!a.stats) {
        if (tid == 0) bulk_wait_all();           // the stores are done
        return;
    }
    // the files' tickets, one per unit walked, all after the walk.  The
    // files this block completed are folded here: a thread per (file,
    // channel) folds the channel's tiles and takes their peak, staged in
    // the block's shared memory (its stores have read it), then thread 0
    // adds the channels of each file in ascending order
    if (tid == 0) bulk_wait_read_all();
    const int smem_bytes = a.ns * STAGE_BYTES + a.nbuf * a.buf_bytes;
    for (long long base = blockIdx.x; base < a.units; base += (long long)THREADS * gridDim.x) {
        const int n_done = take_tickets(a.tickets, a.n_tiles, base, a.units, true, done, n_last);
        double acc = 0.0;                        // thread 0's, of the current file
        float mx = 0.f;
        for (long long k0 = 0; k0 < (long long)n_done * C; k0 += THREADS) {
            const int nk = (int)min((long long)THREADS, (long long)n_done * C - k0);
            auto row_of = [&](int i) {
                const long long k = k0 + i;
                const int f = done[k / C];
                const long long row = (long long)f * C + k % C;
                const long long n =
                    a.out_frames ? min((long long)a.out_frames[f], a.keep) : a.keep;
                return FoldRow{a.sq_tiles + row * a.n_tiles, (int)((n + TILE - 1) / TILE)};
            };
            fold_rows(nk, row_of, a.n_tiles, rows, smem, smem_bytes, red[0]);
            // the rows' peaks (any order: max is exact), a warp per row
            for (int j = tid >> 5; j < nk; j += WARPS) {
                const FoldRow r = rows[j];
                const float* pk = a.pk_tiles + (r.d - a.sq_tiles);
                float m = 0.f;
                for (int i0 = 0; i0 < r.cnt; i0 += 32 * 8) {
                    float v[8];                  // the loads first, then the maxima
#pragma unroll
                    for (int u = 0; u < 8; ++u) {
                        const int i = i0 + 32 * u + (tid & 31);
                        v[u] = i < r.cnt ? __ldcg(pk + i) : 0.f;
                    }
#pragma unroll
                    for (int u = 0; u < 8; ++u) m = fmax_nan(m, v[u]);
                }
#pragma unroll
                for (int off = 16; off >= 1; off >>= 1)
                    m = fmax_nan(m, __shfl_down_sync(0xffffffffu, m, off));
                if ((tid & 31) == 0) redf[0][j] = m;
            }
            consumer_sync();
            if (tid == 0) {
                for (int j = 0; j < nk; ++j) {
                    acc = __dadd_rn(acc, red[0][j]);
                    mx = fmax_nan(mx, redf[0][j]);
                    const long long kk = k0 + j;
                    if (kk % C == C - 1) {               // the file's last channel
                        const int f = done[kk / C];
                        a.sumsq[f] = acc;
                        a.peak[f] = mx;
                        acc = 0.0;
                        mx = 0.f;
                    }
                }
            }
            consumer_sync();
        }
    }
    if (tid == 0) bulk_wait_all();               // the stores are done
}

// What a device offers the pair, read once per device; the kernels'
// dynamic shared memory attribute is raised to all a block may have.
struct DevInfo {
    int sms;
    int l2_bytes;
    int dyn_max;                  // dynamic shared memory a block may ask for
};

std::mutex info_mutex;
bool info_ready[MAX_DEVICES];
DevInfo infos[MAX_DEVICES];

template <typename K>
cudaError_t raise_smem(K kernel, int optin, int* dyn_max)
{
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    const int dyn = optin - (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    *dyn_max = min(*dyn_max, dyn);
    return e;
}

cudaError_t device_info(DevInfo* out)
{
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(info_mutex);
    if (!info_ready[dev]) {
        DevInfo d;
        int optin = 0;
        if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev)) ||
            (e = cudaDeviceGetAttribute(&d.l2_bytes, cudaDevAttrL2CacheSize, dev)) ||
            (e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
            return e;
        d.dyn_max = optin;
        if ((e = raise_smem(dc_pass, optin, &d.dyn_max)) ||
            (e = raise_smem(finish_pass<0>, optin, &d.dyn_max)) ||
            (e = raise_smem(finish_pass<1>, optin, &d.dyn_max)) ||
            (e = raise_smem(finish_pass<2>, optin, &d.dyn_max)) ||
            (e = raise_smem(finish_pass<3>, optin, &d.dyn_max)))
            return e;
        infos[dev] = d;
        info_ready[dev] = true;
    }
    *out = infos[dev];
    return cudaSuccess;
}

// k blocks per SM times the SMs, at most one block per unit
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int sms, int units, int* grid)
{
    int k = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, BLOCK, smem);
    if (e != cudaSuccess) return e;
    if (k < 1) return cudaErrorInvalidConfiguration;
    *grid = (int)min((long long)k * sms, (long long)units);
    return cudaSuccess;
}

template <int MODE>
cudaError_t launch_finish(FinishArgs a, int sms, int dyn_max, cudaStream_t s)
{
    // the ring and the staging: the most stages in flight on an SM (blocks
    // per SM x stages), two staging buffers before one on a tie; a payload
    // unit that fits with no ring of 2 is stored in place
    constexpr int NB = MODE == 3 ? 3 : 2;
    constexpr int ES = MODE == 0 ? 4 : 2;
    const long long unit_bytes = MODE <= 1 ? (long long)TILE * ES : (long long)TILE * a.C * NB;
    a.buf_bytes = (int)min((unit_bytes + 16 + 15) & ~15LL, 0x7FFFFFF0LL);
    int best = 0, grid = 0;
    size_t best_smem = 0;
    for (int nbuf = 2; nbuf >= (MODE <= 1 ? 2 : 1); --nbuf) {   // planar codes: two
        for (int ns = NS_MAX; ns >= 2; --ns) {
            const long long smem = (long long)ns * STAGE_BYTES + (long long)nbuf * a.buf_bytes;
            if (smem > dyn_max) continue;
            int k = 0;
            const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &k, finish_pass<MODE>, BLOCK, (size_t)smem);
            if (e != cudaSuccess) return e;
            if (k * ns > best) {
                best = k * ns;
                a.ns = ns;
                a.nbuf = nbuf;
                best_smem = (size_t)smem;
            }
        }
    }
    if (!best) {
        if (MODE <= 1) return cudaErrorInvalidConfiguration;
        a.ns = NS_MAX;
        a.nbuf = 0;
        best_smem = (size_t)NS_MAX * STAGE_BYTES;
    }
    const cudaError_t e = persistent_grid(finish_pass<MODE>, best_smem, sms, a.units, &grid);
    if (e != cudaSuccess) return e;
    finish_pass<MODE><<<grid, BLOCK, best_smem, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the pair on `stream`; returns a CUDA error code (0 = launched).
// y: (files, C, stride) float32 of which positions [0, keep) are read;
// out_frames (files,) int32 or null; seeds (files * C,) int64 holding uint32
// or null; gain_lin (files,) or null; out: codes or payload by `mode` (0
// int32, 1 int16, 2 16-bit payload, 3 24-bit payload); sumsq, peak (files,)
// and the partials when `stats`; mean (files * C,) and dc_tiles when
// `remove_dc`; tickets: files * C + files zeroed ints.  scale = 2^(bits-1),
// clip_hi the largest code as a float, gain the float32 static gain, silent
// (C,) bytes, nonzero for a channel written as zeros, or null; pos0 the
// noise position of sample 0.
int f9_epilogue(const float* y, const int* out_frames, const long long* seeds,
                const float* gain_lin, const unsigned char* silent, void* out, double* sumsq,
                float* peak, float* mean, double* dc_tiles, double* sq_tiles, float* pk_tiles,
                unsigned int* tickets, int files, int C, long long stride, long long keep,
                int n_tiles, float scale, float clip_hi, float gain, long long pos0, int mode,
                int remove_dc, int stats, void* stream)
{
    cudaStream_t s = (cudaStream_t)stream;
    const long long rows = (long long)files * C;
    if (rows * n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (mode < 0 || mode > 3) return (int)cudaErrorInvalidValue;
    DevInfo d;
    cudaError_t e = device_info(&d);
    if (e != cudaSuccess) return (int)e;
    if (remove_dc) {
        DcArgs p;
        p.y = y;
        p.out_frames = out_frames;
        p.tiles = dc_tiles;
        p.mean = mean;
        p.tickets = tickets;
        p.C = C;
        p.stride = stride;
        p.keep = keep;
        p.n_tiles = n_tiles;
        p.units = (int)(rows * n_tiles);
        // the units read last, about half the L2, stay for pass 2
        p.hot_from = max(0, p.units - d.l2_bytes / 2 / (TILE * 4));
        p.ns = NS_MAX;
        const size_t smem = (size_t)NS_MAX * STAGE_BYTES;
        int grid = 0;
        e = persistent_grid(dc_pass, smem, d.sms, p.units, &grid);
        if (e != cudaSuccess) return (int)e;
        dc_pass<<<grid, BLOCK, smem, s>>>(p);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    FinishArgs a;
    a.y = y;
    a.out_frames = out_frames;
    a.seeds = seeds;
    a.gain_lin = gain_lin;
    a.mean = remove_dc ? mean : nullptr;
    a.silent = silent;
    a.out = out;
    a.sq_tiles = sq_tiles;
    a.pk_tiles = pk_tiles;
    a.sumsq = sumsq;
    a.peak = peak;
    a.tickets = tickets + rows;
    a.C = C;
    a.stride = stride;
    a.keep = keep;
    a.n_tiles = n_tiles;
    a.units = files * n_tiles;
    a.scale = scale;
    a.lo = (int)-scale;           // -2^(bits-1), an int for every bits <= 32
    a.hi = (int)clip_hi;          // below 2^(bits-1), an int likewise
    a.gain = gain;
    a.pos0 = pos0;
    a.stats = stats;
    switch (mode) {
    case 0: e = launch_finish<0>(a, d.sms, d.dyn_max, s); break;
    case 1: e = launch_finish<1>(a, d.sms, d.dyn_max, s); break;
    case 2: e = launch_finish<2>(a, d.sms, d.dyn_max, s); break;
    default: e = launch_finish<3>(a, d.sms, d.dyn_max, s); break;
    }
    return (int)e;
}

}  // extern "C"
