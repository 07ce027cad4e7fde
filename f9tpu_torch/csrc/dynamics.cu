// The insert chain's dynamics stages on Hopper (sm_90a): the release
// envelope (a slanted running maximum) and the windowed maximum.
//
// f9_slanted_cummax replaces what XLA compiles from
// f9tpu/ops/chain.py:733 Compressor._slanted_cummax_stream (and :703
// _slanted_cummax): env[n] = max_{k<=n}(level[k] - c*(n-k)), kept on the
// absolute grid of B-frame blocks (Compressor._ENV_BLOCK, 2^17) so that
// every float32 rounding is the same wherever a chunk starts.  Within a
// block, with j the frame's index in it and r = fl(j * fl(c)):
//
//   s[n]   = max(seed, fl(level[k] + r[k]) for the block's k <= n)
//   env[n] = max(fl(s[n] - r[n]), fl(carry - fl(fl(c) * (j + 1))))
//
// seed = the carried m in the chunk's first block, -1e9 in every later one;
// carry = the envelope at the previous block's last frame (the carried
// env_carry for the first).  Its plain twin is f9tpu_torch/ops/chain.py:
// Compressor._slanted_cummax_stream_reference, which walks the chunk in
// pieces that end on the grid with torch.cummax and torch.maximum.  Every
// rounding here is an _rn intrinsic (nvcc would contract level + j*c into
// one FMA, which rounds once where the twin rounds twice), and the
// maximum is torch's on the card (a NaN wins; else fmaxf).  Max is exact,
// so any association gives the twin's bits: no -0.0 can reach it (level +
// r, with r >= +0.0, turns -0.0 into +0.0, and x - x is +0.0), so equal
// values are equal bits, and a NaN spreads forward as torch.cummax's does.
//
// That freedom makes a row parallel.  Three launches:
//   (a) env_tile_max: each tile's max of level + r, 2048 frames a block of
//       256 threads, tiles on the absolute grid (min(2048, B) frames, never
//       straddling a block);
//   (b) env_walk: a block per row; a thread per envelope block walks its
//       tiles in order for each tile's exclusive prefix (the seed first) and
//       the block's maximum S_b, then one thread walks the blocks'
//       carries, carry_{b+1} = max(fl(S_b - r_last), fl(carry_b - fl(c*B))),
//       and writes the state out: m' (-1e9 if the chunk ends on the grid,
//       else the last block's S) and env_carry';
//   (c) env_write: each tile again, its frames staged in shared memory, 8
//       consecutive a thread, an exclusive scan of the threads' maxima
//       seeded with the tile's prefix, then env.
// What bounds it: the bytes, level read once and env written once (the
// insert loop's linked row, 8 x 1 x 3,117,515 frames, 0.060 ms at 3.35
// TB/s); this design reads level twice (0.089 ms), and (b) adds a few
// microseconds of latency.  A one-pass scan with decoupled look-back
// would reach the one-read bound.
//
// f9_window_max replaces what XLA fuses from f9tpu/ops/chain.py:902
// _window_max_past: out[m] = max a[m-W+1..m], positions before the row's
// start read as +0.0 (so an output near the start is at least +0.0,
// whatever a negative input says).  Its twin,
// f9tpu_torch/ops/chain.py:_window_max_past_reference, takes log2 W shifted
// maxima by doubling (f = max(f, f shifted by s), s = 1, 2, 4, ... while 2s
// <= W, then once by W - s); this kernel computes the same tree in the
// same argument order, so even ties between +0.0 and -0.0 and NaNs resolve
// as the twin's do whatever the hardware's fmaxf does with them.  A block
// stages its 2048 outputs and the W - 1 samples before them in shared
// memory and runs each level from one buffer into the other, each thread
// about 8 elements a level.  It is bytes-bound (the limiter's 8 x 1 x (T +
// 72) frames, read once and written once, 0.06 ms); its 7 levels of shared
// memory traffic take about as long again.  A window whose two buffers pass
// a block's 227 KB (W > WMAX_STAGED_MAX_W) runs each level as a launch over
// device memory, through the caller's scratch row.

#include <cuda_runtime.h>

#include <math.h>
#include <mutex>

namespace {

#include "smem_limit.cuh"

constexpr int ENV_THREADS = 256;
constexpr int ENV_R = 8;                          // consecutive frames a thread in (c)
constexpr int ENV_TILE = ENV_THREADS * ENV_R;     // the widest tile
constexpr int ENV_MAX_BLOCK = 1 << 24;            // j stays exact in float32
constexpr float ENV_FLOOR = -1e9f;                // a block's seed past the first
static_assert(ENV_R == 8, "(c) reads a thread's frames as two float4");

constexpr int WMAX_THREADS = 256;
constexpr int WMAX_TILE = WMAX_THREADS * 8;       // outputs a block
constexpr int SMEM_STATIC_MAX = 48 * 1024;
constexpr int SMEM_BLOCK_MAX = 227 * 1024;
// the widest window whose two staged buffers fit a block (chain_kernels.py
// WMAX_STAGED_MAX_W)
constexpr int WMAX_STAGED_MAX_W = SMEM_BLOCK_MAX / 8 - WMAX_TILE + 1;

// torch.maximum on the card: a NaN operand wins (the first if both), else
// fmaxf
__device__ __forceinline__ float mx(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct EnvGeom {
    long long T;          // frames of the chunk a row
    long long ntiles;     // tiles a row
    long long nblocks;    // envelope blocks a row (the first may start mid-block)
    int p0;               // the chunk's first frame's index in its block
    int B;                // the block length, a power of two
    int tile;             // min(ENV_TILE, B)
    float cf;             // fl(c)
};

// the chunk frames [a, b) of tile k
__device__ __forceinline__ void tile_span(const EnvGeom& g, long long k, long long& a,
                                          long long& b)
{
    const long long t = g.p0 / g.tile + k;
    a = t * g.tile - g.p0;
    b = a + g.tile;
    if (a < 0) a = 0;
    if (b > g.T) b = g.T;
}

// j of chunk frame i, as the twin's float32 arange holds it
__device__ __forceinline__ float env_j(const EnvGeom& g, long long i)
{
    return (float)((g.p0 + i) & (long long)(g.B - 1));
}

__device__ __forceinline__ float warp_max(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = mx(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// (a) tmax[row, k] = max over tile k of fl(level + fl(j * c))
__global__ void __launch_bounds__(ENV_THREADS)
env_tile_max(const float* __restrict__ level, float* __restrict__ tmax, EnvGeom g)
{
    __shared__ float part[ENV_THREADS / 32];
    const long long row = blockIdx.x / g.ntiles, k = blockIdx.x - row * g.ntiles;
    long long a, b;
    tile_span(g, k, a, b);
    const float* lr = level + row * g.T;
    float best = -INFINITY;
    for (long long i = a + threadIdx.x; i < b; i += ENV_THREADS)
        best = mx(best, __fadd_rn(lr[i], __fmul_rn(env_j(g, i), g.cf)));
    best = warp_max(best);
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
        float v = part[0];
#pragma unroll
        for (int w = 1; w < ENV_THREADS / 32; ++w) v = mx(v, part[w]);
        tmax[row * g.ntiles + k] = v;
    }
}

// (b) one block a row: tpre[row, k] = the seed and the tiles before k in
// k's envelope block; sb[row, b] = block b's maximum; cin[row, b] = the
// carry entering block b; the state out.
__global__ void __launch_bounds__(ENV_THREADS)
env_walk(const float* __restrict__ tmax, float* __restrict__ tpre, float* __restrict__ sb,
         float* __restrict__ cin, const float* __restrict__ m_in, const float* __restrict__ c_in,
         float* __restrict__ m_out, float* __restrict__ c_out, EnvGeom g)
{
    const long long row = blockIdx.x;
    const long long t0 = g.p0 / g.tile, tpb = g.B / g.tile;
    const float* tm = tmax + row * g.ntiles;
    float* tp = tpre + row * g.ntiles;
    float* sr = sb + row * g.nblocks;
    float* cr = cin + row * g.nblocks;
    for (long long b = threadIdx.x; b < g.nblocks; b += ENV_THREADS) {
        long long k0 = b * tpb - t0, k1 = (b + 1) * tpb - t0;
        if (k0 < 0) k0 = 0;
        if (k1 > g.ntiles) k1 = g.ntiles;
        float s = b == 0 ? m_in[row] : ENV_FLOOR;
        for (long long k = k0; k < k1; ++k) {
            tp[k] = s;
            s = mx(s, tm[k]);
        }
        sr[b] = s;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    const float r_last = __fmul_rn((float)(g.B - 1), g.cf);
    const float decay_b = __fmul_rn(g.cf, (float)g.B);        // fl(c) * (j + 1), j = B - 1
    const bool ends = ((g.p0 + g.T) & (long long)(g.B - 1)) == 0;
    float c = c_in[row];
    for (long long b = 0; b < g.nblocks; ++b) {
        cr[b] = c;
        if (b + 1 < g.nblocks || ends)            // block b's last frame is in the chunk
            c = mx(__fsub_rn(sr[b], r_last), __fsub_rn(c, decay_b));
    }
    c_out[row] = ends ? c : cr[g.nblocks - 1];
    m_out[row] = ends ? ENV_FLOOR : sr[g.nblocks - 1];
}

// (c) env over tile k: thread t takes the tile's frames 8t .. 8t + 7
__global__ void __launch_bounds__(ENV_THREADS)
env_write(const float* __restrict__ level, const float* __restrict__ tpre,
          const float* __restrict__ cin, float* __restrict__ env, EnvGeom g)
{
    __shared__ float4 sv4[ENV_TILE / 4];
    __shared__ float part[ENV_THREADS / 32];
    float* sv = reinterpret_cast<float*>(sv4);
    const long long row = blockIdx.x / g.ntiles, k = blockIdx.x - row * g.ntiles;
    long long a, b;
    tile_span(g, k, a, b);
    const int n = (int)(b - a);
    const float* lr = level + row * g.T + a;
    for (int i = threadIdx.x; i < n; i += ENV_THREADS) sv[i] = lr[i];
    __syncthreads();
    const int i0 = ENV_R * threadIdx.x;
    float v[ENV_R], rr[ENV_R];
    {
        const float4 p = sv4[2 * threadIdx.x], q = sv4[2 * threadIdx.x + 1];
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
        v[4] = q.x; v[5] = q.y; v[6] = q.z; v[7] = q.w;
    }
    float run = -INFINITY;
#pragma unroll
    for (int u = 0; u < ENV_R; ++u) {
        rr[u] = __fmul_rn(env_j(g, a + i0 + u), g.cf);
        v[u] = __fadd_rn(v[u], rr[u]);
        if (i0 + u < n) run = mx(run, v[u]);
    }
    // the threads before this one: a warp's inclusive scan, shifted by one
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    float inc = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc = mx(y, inc);
    }
    float ex = __shfl_up_sync(0xffffffffu, inc, 1);
    if (lane == 31) part[warp] = inc;
    __syncthreads();
    float s = tpre[row * g.ntiles + k];
    for (int w = 0; w < warp; ++w) s = mx(s, part[w]);
    if (lane > 0) s = mx(s, ex);
    const long long blk = (g.p0 / g.tile + k) / (g.B / g.tile);
    const float carry = cin[row * g.nblocks + blk];
    float e[ENV_R];
#pragma unroll
    for (int u = 0; u < ENV_R; ++u) {
        s = mx(s, v[u]);
        const float j1 = __fadd_rn(env_j(g, a + i0 + u), 1.0f);
        e[u] = mx(__fsub_rn(s, rr[u]), __fsub_rn(carry, __fmul_rn(g.cf, j1)));
    }
    sv4[2 * threadIdx.x] = make_float4(e[0], e[1], e[2], e[3]);
    sv4[2 * threadIdx.x + 1] = make_float4(e[4], e[5], e[6], e[7]);
    __syncthreads();
    float* er = env + row * g.T + a;
    for (int i = threadIdx.x; i < n; i += ENV_THREADS) er[i] = sv[i];
}

// 4 bytes global -> shared without passing through registers; +0.0 when
// `ok` is false (the source is then not read)
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src, bool ok)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// Block b: row b / tiles, outputs [n0, n0 + WMAX_TILE).  The span (the
// outputs and the W - 1 positions before them, +0.0 before the row) goes
// through the twin's levels from one shared buffer into the other; a
// position below a level's shift is not needed by any output and keeps its
// value.  A tile inside the row stages and stores without a bounds check
// a sample.
__global__ void __launch_bounds__(WMAX_THREADS)
wmax_tile(const float* __restrict__ x, float* __restrict__ y, long long T, long long tiles, int W)
{
    extern __shared__ float4 wm_sm4[];
    const int span = WMAX_TILE + W - 1;
    float* f = reinterpret_cast<float*>(wm_sm4);
    float* h = f + span;
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * WMAX_TILE;
    const float* xr = x + row * T;
    if (n0 - (W - 1) >= 0 && n0 + WMAX_TILE <= T) {
        const float* src = xr + (n0 - (W - 1));
        for (int i = threadIdx.x; i < span; i += WMAX_THREADS)
            cp_async4_or_zero(f + i, src + i, true);
    } else {
        for (int i = threadIdx.x; i < span; i += WMAX_THREADS) {
            const long long n = n0 - (W - 1) + i;
            const bool ok = n >= 0 && n < T;
            cp_async4_or_zero(f + i, xr + (ok ? n : 0), ok);
        }
    }
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    int s = 1;
    for (bool doubling = true;;) {
        int sh;
        if (doubling && 2 * s <= W) {
            sh = s;
            s *= 2;
        } else {
            doubling = false;
            sh = W - s;
            if (sh == 0) break;
            s = W;
        }
        for (int i = threadIdx.x; i < span; i += WMAX_THREADS)
            h[i] = i >= sh ? mx(f[i], f[i - sh]) : f[i];
        __syncthreads();
        float* t = f;
        f = h;
        h = t;
    }
    float* yr = y + row * T + n0;
    const float* fo = f + (W - 1);
    if (n0 + WMAX_TILE <= T) {
#pragma unroll
        for (int k = 0; k < WMAX_TILE / WMAX_THREADS; ++k)
            yr[k * WMAX_THREADS + threadIdx.x] = fo[k * WMAX_THREADS + threadIdx.x];
    } else {
        for (int i = threadIdx.x; i < WMAX_TILE; i += WMAX_THREADS)
            if (n0 + i < T) yr[i] = fo[i];
    }
}

// One of the twin's levels over device memory, row-wise: g[p] = max(f[p],
// f[p - sh]), f[p - sh] +0.0 before the row's start.
__global__ void __launch_bounds__(WMAX_THREADS)
wmax_level(const float* __restrict__ f, float* __restrict__ g, long long T, long long total,
           int sh)
{
    for (long long i = blockIdx.x * (long long)WMAX_THREADS + threadIdx.x; i < total;
         i += (long long)gridDim.x * WMAX_THREADS) {
        const long long p = i % T;
        g[i] = mx(f[i], p >= sh ? f[i - sh] : 0.0f);
    }
}

}  // namespace

extern "C" {

// The release envelope of level (rows, T) float32 for a chunk whose first
// frame has index p0 in its B-frame block (B a power of two <= 2^24), from
// the state (m_in, c_in) (rows,), with cf = fl(c): env (rows, T) and the
// state after the chunk (m_out, c_out).  `scratch` holds scratch_len >=
// rows * 2 * (ntiles + nblocks) floats (ntiles = ceil((p0 + T) / tile) -
// p0 / tile, tile = min(2048, B); nblocks = ceil((p0 + T) / B)).  Three
// launches on `stream`; returns a CUDA error code.
int f9_slanted_cummax(const float* level, const float* m_in, const float* c_in, float* env,
                      float* m_out, float* c_out, float* scratch, long long scratch_len,
                      long long rows, long long T, int p0, int B, float cf, void* stream)
{
    if (B < 1 || (B & (B - 1)) != 0 || B > ENV_MAX_BLOCK || p0 < 0 || p0 >= B || T < 1
        || rows < 1)
        return (int)cudaErrorInvalidValue;
    EnvGeom g;
    g.T = T;
    g.p0 = p0;
    g.B = B;
    g.tile = B < ENV_TILE ? B : ENV_TILE;
    g.cf = cf;
    g.ntiles = (p0 + T + g.tile - 1) / g.tile - p0 / g.tile;
    g.nblocks = (p0 + T + B - 1) / B;
    const long long grid = rows * g.ntiles;
    if (grid > 0x7FFFFFFFLL || rows > 0x7FFFFFFFLL
        || scratch_len < rows * 2 * (g.ntiles + g.nblocks))
        return (int)cudaErrorInvalidValue;
    float* tmax = scratch;
    float* tpre = tmax + rows * g.ntiles;
    float* sb = tpre + rows * g.ntiles;
    float* cin = sb + rows * g.nblocks;
    cudaStream_t st = (cudaStream_t)stream;
    env_tile_max<<<(unsigned)grid, ENV_THREADS, 0, st>>>(level, tmax, g);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    env_walk<<<(unsigned)rows, ENV_THREADS, 0, st>>>(tmax, tpre, sb, cin, m_in, c_in, m_out,
                                                     c_out, g);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    env_write<<<(unsigned)grid, ENV_THREADS, 0, st>>>(level, tpre, cin, env, g);
    return (int)cudaGetLastError();
}

// y (rows, T) = the causal windowed maximum of x (rows, T) over W >= 2
// positions, +0.0 read before the start, in `_window_max_past_reference`'s
// order.  W > WMAX_STAGED_MAX_W needs `scratch`, (rows, T) floats.
// Launches on `stream`; returns a CUDA error code.
int f9_window_max(const float* x, float* y, float* scratch, long long rows, long long T, int W,
                  void* stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    if (W < 2 || rows < 1 || T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (W <= WMAX_STAGED_MAX_W) {
        const long long tiles = (T + WMAX_TILE - 1) / WMAX_TILE;
        if (rows * tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        const int smem = 2 * (WMAX_TILE + W - 1) * (int)sizeof(float);
        if (smem > SMEM_STATIC_MAX) {
            const cudaError_t e = allow_smem((const void*)wmax_tile, allowed, smem);
            if (e != cudaSuccess) return (int)e;
        }
        wmax_tile<<<(unsigned)(rows * tiles), WMAX_THREADS, (size_t)smem, st>>>(x, y, T, tiles, W);
        return (int)cudaGetLastError();
    }
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    int shifts[64], n = 0, s = 1;
    while (2 * s <= W) {
        shifts[n++] = s;
        s *= 2;
    }
    if (W - s) shifts[n++] = W - s;
    const long long total = rows * T;
    long long blocks = (total + WMAX_THREADS - 1) / WMAX_THREADS;
    if (blocks > 65536) blocks = 65536;
    const float* src = x;
    for (int l = 0; l < n; ++l) {
        float* dst = (n - 1 - l) % 2 == 0 ? y : scratch;   // the last level lands in y
        wmax_level<<<(unsigned)blocks, WMAX_THREADS, 0, st>>>(src, dst, T, total, shifts[l]);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        src = dst;
    }
    return (int)cudaSuccess;
}

}  // extern "C"
