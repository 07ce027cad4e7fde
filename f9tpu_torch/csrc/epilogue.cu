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
// What bounds it.  Per output sample it does ~30 integer and float
// operations (the SplitMix32 hash is five of them) against 8 bytes of
// traffic, so it is bound by memory.  The function must read y once and
// write the codes once: at bench.py's shape (32 rows x 1,141,440 outputs,
// 146.1 MB of float32) that is 292.2 MB = 0.087 ms at 3.35 TB/s with int32
// codes, 255.7 MB = 0.076 ms with the 24-bit payload.  The DC mean has to be
// known before the first code, and y (146 MB) does not fit in the 50 MB L2,
// so a DC-removing epilogue reads y twice: 0.131 ms (int32) and 0.120 ms
// (payload) is this design's floor.
//
// Design.
//   * Pass 1 (only when the DC is removed): a block owns one tile of TILE =
//     4096 samples of one (file, channel) row, reads it once (positions at
//     or past the file's out_frames read as 0.0 and a tile wholly past them
//     is not read at all) and writes its float64 sum.  The last block of a
//     row to finish (an integer atomic ticket; no atomic ever adds a float)
//     folds the row's tile sums in ascending order and writes the float32
//     mean, __ddiv_rn then __double2float_rn, as the twin rounds it.
//   * Pass 2: a block owns TILE frames of one file across all C channels.
//     Per channel it reads y once, forms z in registers (mask, __fsub_rn,
//     __fmul_rn by the float32 gain), quantizes (z * 2^(bits-1) is exact,
//     plus the noise, rintf = half to even, clamp, truncate) and stores;
//     with statistics it also writes the tile's float64 sum of z^2 and
//     float32 max |z|, and the file's last block folds them: tiles in
//     ascending order, then channels in ascending order.
//   * The reductions' order is the twin's halving tree: thread t holds tile
//     elements t + 256k (loads strided by the block width, coalesced), halves
//     its 16 registers (k + 8, + 4, + 2, + 1), then shared memory over thread
//     index (128, 64, 32), then warp shuffles (16 ... 1).  So a row's mean,
//     sums and codes depend on its own samples only, not on the bucket
//     length, the row or the batch width.  Every float operation is an _rn
//     intrinsic, so no FMA contraction moves a rounding.
//   * The payload is written directly: a block stages its frames' bytes,
//     interleaved, in shared memory (4096 * C * 3 bytes, up to 192 KB) and
//     writes them out as contiguous 16-byte stores; past 192 KB it stores
//     each sample's bytes in place.
//   * Both grids are one-dimensional, block b owning tile b % n_tiles of
//     row (or file) b / n_tiles, so no count of files or channels meets the
//     65,535 limit of a grid's second axis.  Pass 2 walks the blocks in
//     reverse order of pass 1, so its first blocks read what pass 1 read
//     last, while it is still in L2.
//   * Routed-silent channels come as a (C,) byte mask on the card: any
//     channel of any bus may be silent.
//   * The stream's chunk finish is pass 2 with no mask, no statistics and
//     its absolute position as the noise's base (pos0).
// Why CUDA and not Triton: bitwise control of every rounding (the twin is
// the specification) and the ctypes build the SRC kernel already uses.

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int TILE = 4096;
constexpr int THREADS = 256;
constexpr int PER = TILE / THREADS;      // tile elements per thread
static_assert(PER == 16, "the register halving steps are written for 16");
constexpr int STAGE_MAX = 192 * 1024;    // payload bytes a block stages
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t splitmix32(uint32_t h)
{
    h ^= h >> 16;
    h *= 0x21F0AAADu;
    h ^= h >> 15;
    h *= 0x735A2D97u;
    h ^= h >> 15;
    return h;
}

// max that keeps a NaN, as torch.amax does
__device__ __forceinline__ float fmax_nan(float m, float x)
{
    return (x > m || x != x) ? x : m;
}

// The block's part of the halving tree: thread t holds the sum of tile
// elements t + 256k; shared memory over thread index (128, 64, then 32 by
// warp 0), then warp shuffles (16 ... 1).  The sum lands in thread 0.
// `red` holds THREADS doubles.
__device__ __forceinline__ double block_tree(double x, double* red)
{
    const int tid = threadIdx.x;
    red[tid] = x;
    __syncthreads();
    if (tid < 128) red[tid] = __dadd_rn(red[tid], red[tid + 128]);
    __syncthreads();
    if (tid < 64) red[tid] = __dadd_rn(red[tid], red[tid + 64]);
    __syncthreads();
    double s = 0.0;
    if (tid < 32) {
        s = __dadd_rn(red[tid], red[tid + 32]);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
            s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off));
    }
    __syncthreads();             // the caller writes `red` again
    return s;
}

// The halving tree of one tile whose element t + THREADS*k is thread t's
// v[k]: the thread halves its registers (k + 8, + 4, + 2, + 1), then
// `block_tree`.
__device__ __forceinline__ double tile_sum(const double (&v)[PER], double* red)
{
    double w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = __dadd_rn(v[k], v[k + 8]);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = __dadd_rn(w[k], w[k + 4]);
    w[0] = __dadd_rn(w[0], w[2]);
    w[1] = __dadd_rn(w[1], w[3]);
    return block_tree(__dadd_rn(w[0], w[1]), red);
}

// tile_sum of the squares of z[k] (each exact in float64), squared as the
// first halving step reads them.
__device__ __forceinline__ double tile_sumsq(const float (&z)[PER], double* red)
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
    return block_tree(__dadd_rn(w[0], w[1]), red);
}

// The block's largest value (any order: max is exact); lands in thread 0.
__device__ __forceinline__ float block_max(float m, float* red)
{
    const int tid = threadIdx.x;
    red[tid] = m;
    __syncthreads();
#pragma unroll
    for (int h = THREADS / 2; h >= 64; h >>= 1) {
        if (tid < h) red[tid] = fmax_nan(red[tid], red[tid + h]);
        __syncthreads();
    }
    if (tid < 32) {
        m = fmax_nan(red[tid], red[tid + 32]);
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1)
            m = fmax_nan(m, __shfl_down_sync(0xffffffffu, m, off));
    }
    __syncthreads();
    return m;
}

// ((0 + src[0]) + src[1]) + ... + src[n-1] in float64, by one warp: the
// lanes load 256 values at a time from L2 (one round trip), the adds run in
// order through shuffles.  Every lane returns the sum.
__device__ __forceinline__ double warp_fold(const double* src, long long n)
{
    const int lane = threadIdx.x & 31;
    double acc = 0.0;
    for (long long base = 0; base < n; base += 256) {
        double v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const long long i = base + 32 * j + lane;
            v[j] = i < n ? __ldcg(src + i) : 0.0;
        }
        const long long m = min(n - base, 256LL);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int l = 0; l < 32; ++l) {
                const double x = __shfl_sync(0xffffffffu, v[j], l);
                if (32 * j + l < m) acc = __dadd_rn(acc, x);
            }
        }
    }
    return acc;
}

// Pass 1: grid (rows * n_tiles,).  tiles: (rows, n_tiles) float64; mean:
// (rows,) float32; tickets: (rows,) zeroed.
__global__ void __launch_bounds__(THREADS)
dc_pass(const float* __restrict__ y, const int* __restrict__ out_frames,
        double* __restrict__ tiles, float* __restrict__ mean,
        unsigned int* __restrict__ tickets, int C, long long stride, long long keep,
        int n_tiles)
{
    __shared__ double red[THREADS];
    __shared__ bool last;
    const int row = blockIdx.x / n_tiles;
    const int tile = blockIdx.x - row * n_tiles;
    const int tid = threadIdx.x;
    const int frames = out_frames[row / C];
    const long long n = min((long long)frames, keep);
    const long long t0 = (long long)tile * TILE;
    if (t0 < n) {
        const float* yr = y + (long long)row * stride;
        double v[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const long long t = t0 + tid + THREADS * k;
            v[k] = t < n ? (double)__ldg(yr + t) : 0.0;
        }
        const double s = tile_sum(v, red);
        if (tid == 0) tiles[(long long)row * n_tiles + tile] = s;
    }
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(tickets + row, 1u) == (unsigned int)(n_tiles - 1);
    }
    __syncthreads();
    if (last && tid < 32) {
        __threadfence();
        // later tiles add +0.0
        const double acc = warp_fold(tiles + (long long)row * n_tiles, (n + TILE - 1) / TILE);
        if (tid == 0) mean[row] = __double2float_rn(__ddiv_rn(acc, (double)max(frames, 1)));
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
    float scale;
    float clip_hi;
    float gain;
    long long pos0;
    int stats;
    int stage;
};

// Pass 2: grid (files * n_tiles,), walked from the last tile of the last file.
// MODE 0: int32 codes (files, C, keep); 1: int16 codes; 2 and 3: the 16- and
// 24-bit interleaved payload (files, keep * C * nb).
template <int MODE>
__global__ void __launch_bounds__(THREADS, 3)
finish_pass(const FinishArgs a)
{
    constexpr int NB = MODE == 3 ? 3 : 2;
    extern __shared__ __align__(16) unsigned char staged[];
    __shared__ double red[THREADS];
    __shared__ float redf[THREADS];
    __shared__ bool last;
    const int b = gridDim.x - 1 - blockIdx.x;
    const int f = b / a.n_tiles;
    const int tile = b - f * a.n_tiles;
    const int tid = threadIdx.x;
    const int C = a.C;
    const long long t0 = (long long)tile * TILE;
    const long long n = a.out_frames ? min((long long)a.out_frames[f], a.keep) : a.keep;
    const float g = a.gain_lin ? __fmul_rn(a.gain, a.gain_lin[f]) : a.gain;
    const long long row_bytes = a.keep * C * NB;
    unsigned char* payload = (unsigned char*)a.out + (long long)f * row_bytes;

    for (int c = 0; c < C; ++c) {
        const long long row = (long long)f * C + c;
        const float* yr = a.y + row * a.stride;
        const float mu = a.mean ? a.mean[row] : 0.f;
        const uint32_t sh = a.seeds ? splitmix32((uint32_t)a.seeds[row]) : 0u;
        const bool mute = a.silent && a.silent[c];
        // every load first: the stores below may alias y as far as the
        // compiler knows, and would otherwise hold each load back
        float yv[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const long long t = t0 + tid + THREADS * k;
            yv[k] = t < n ? __ldcs(yr + t) : 0.f;
        }
        float m = 0.f;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const long long t = t0 + tid + THREADS * k;
            float z = 0.f;
            if (t < n) {
                float v = yv[k];
                if (a.mean) v = __fsub_rn(v, mu);
                z = __fmul_rn(v, g);
            }
            yv[k] = z;                // z from here on
            m = fmax_nan(m, fabsf(z));
            if (t >= a.keep) continue;
            int q = 0;
            if (t < n && !mute) {
                float v = __fmul_rn(z, a.scale);
                if (a.seeds) {
                    const uint32_t h = splitmix32((uint32_t)(a.pos0 + t) ^ sh);
                    const float u1 = __fmul_rn(__uint2float_rn(h & 0xFFFFu), 1.0f / 65536.0f);
                    const float u2 = __fmul_rn(__uint2float_rn(h >> 16), 1.0f / 65536.0f);
                    v = __fadd_rn(v, __fsub_rn(u1, u2));
                }
                v = fminf(fmaxf(rintf(v), -a.scale), a.clip_hi);
                q = __float2int_rz(v);
            }
            if constexpr (MODE == 0) {
                ((int*)a.out)[row * a.keep + t] = q;
            } else if constexpr (MODE == 1) {
                ((short*)a.out)[row * a.keep + t] = (short)q;
            } else {
                unsigned char* dst = a.stage
                    ? staged + ((t - t0) * C + c) * NB
                    : payload + (t * C + c) * NB;
#pragma unroll
                for (int j = 0; j < NB; ++j) dst[j] = (unsigned char)((unsigned)q >> (8 * j));
            }
        }
        if (a.stats) {
            double s = 0.0;
            float mx = 0.f;
            if (t0 < n) {             // block-uniform: a tile past the end sums to 0
                s = tile_sumsq(yv, red);
                mx = block_max(m, redf);
            }
            if (tid == 0) {
                a.sq_tiles[row * a.n_tiles + tile] = s;
                a.pk_tiles[row * a.n_tiles + tile] = mx;
            }
        }
    }

    if (MODE >= 2 && a.stage) {       // block-uniform
        __syncthreads();
        const long long span = min((long long)TILE, a.keep - t0);
        const long long nbytes = span * C * NB;
        unsigned char* dst = payload + t0 * C * NB;
        if ((((uintptr_t)dst) & 15) == 0 && (nbytes & 15) == 0) {
            const uint4* s4 = (const uint4*)staged;
            uint4* d4 = (uint4*)dst;
            for (long long i = tid; i < nbytes / 16; i += THREADS) d4[i] = s4[i];
        } else {
            for (long long i = tid; i < nbytes; i += THREADS) dst[i] = staged[i];
        }
    }

    if (!a.stats) return;
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(a.tickets + f, 1u) == (unsigned int)(a.n_tiles - 1);
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    const long long nvt = (n + TILE - 1) / TILE;
    const int warp = tid >> 5;
    double acc = 0.0;                 // thread 0's: channels in ascending order
    for (int c0 = 0; c0 < C; c0 += THREADS / 32) {
        const int c = c0 + warp;      // a warp folds a channel's tiles
        if (c < C) {
            const double s = warp_fold(a.sq_tiles + ((long long)f * C + c) * a.n_tiles, nvt);
            if ((tid & 31) == 0) red[warp] = s;
        }
        __syncthreads();
        if (tid == 0) {
            const int nc = min(THREADS / 32, C - c0);
            for (int i = 0; i < nc; ++i) acc = __dadd_rn(acc, red[i]);
        }
        __syncthreads();
    }
    float mx = 0.f;
    for (long long i = tid; i < (long long)C * nvt; i += THREADS) {
        const long long c = i / nvt, j = i - c * nvt;
        mx = fmax_nan(mx, __ldcg(a.pk_tiles + ((long long)f * C + c) * a.n_tiles + j));
    }
    mx = block_max(mx, redf);
    if (tid == 0) {
        a.sumsq[f] = acc;
        a.peak[f] = mx;
    }
}

std::mutex smem_mutex;
bool smem_raised[2][MAX_DEVICES];

// Allow the payload kernels STAGE_MAX bytes of dynamic shared memory on the
// current device, once (the attribute is only ever raised).
cudaError_t raise_smem(int mode)
{
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> lock(smem_mutex);
    if (smem_raised[mode - 2][dev]) return cudaSuccess;
    e = mode == 2
        ? cudaFuncSetAttribute(finish_pass<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_MAX)
        : cudaFuncSetAttribute(finish_pass<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               STAGE_MAX);
    if (e == cudaSuccess) smem_raised[mode - 2][dev] = true;
    return e;
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
    const int rows = files * C;
    if ((long long)rows * n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (remove_dc) {
        dc_pass<<<rows * n_tiles, THREADS, 0, s>>>(y, out_frames, dc_tiles, mean, tickets, C,
                                                    stride, keep, n_tiles);
        const cudaError_t e = cudaGetLastError();
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
    a.scale = scale;
    a.clip_hi = clip_hi;
    a.gain = gain;
    a.pos0 = pos0;
    a.stats = stats;
    const int nb = mode == 3 ? 3 : 2;
    a.stage = mode >= 2 && (long long)TILE * C * nb <= STAGE_MAX;
    const size_t smem = a.stage ? (size_t)TILE * C * nb : 0;
    if (a.stage) {               // with the static arrays, past 48 KB from C = 4 on
        const cudaError_t e = raise_smem(mode);
        if (e != cudaSuccess) return (int)e;
    }
    const int grid = files * n_tiles;
    switch (mode) {
    case 0: finish_pass<0><<<grid, THREADS, smem, s>>>(a); break;
    case 1: finish_pass<1><<<grid, THREADS, smem, s>>>(a); break;
    case 2: finish_pass<2><<<grid, THREADS, smem, s>>>(a); break;
    case 3: finish_pass<3><<<grid, THREADS, smem, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
