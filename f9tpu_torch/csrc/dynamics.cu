// The insert chain's dynamics stages on Hopper (sm_90a): the release
// envelope (a slanted running maximum) and the windowed maximum.  Each
// kernel gives its plain twin's bits for every input.
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
// env_carry for the first), carry_{b+1} = max(fl(S_b - r_last), fl(carry_b
// - fl(c * B))) with S_b block b's s at its last frame.  Its plain twin is
// f9tpu_torch/ops/chain.py: Compressor._slanted_cummax_stream_reference,
// which walks the chunk in pieces that end on the grid with torch.cummax
// and torch.maximum.  Every rounding here is an _rn intrinsic (nvcc would
// contract level + j*c into one FMA, which rounds once where the twin
// rounds twice), and the maximum is torch's on the card (a NaN wins; else
// fmaxf).  Max is exact, so any association gives the twin's bits: no -0.0
// can reach it (level + r, with r >= +0.0, turns -0.0 into +0.0, and x - x
// is +0.0), so equal values are equal bits, and a NaN spreads forward as
// torch.cummax's does.
//
// What bounds it: the bytes, level read once and env written once (the
// insert loop's linked row, 8 x 1 x 2,903,040 frames, 185.8 MB, 0.0555 ms
// at 3.35 TB/s).  The design, one launch (env_scan) after one memset of its
// flags and ticket, level read once:
//   - a tile on the absolute grid (never straddling an envelope block) is
//     one block of 256 threads: 16,384 frames (ENV_Q_WIDE quads a thread)
//     where the call has many of them (the insert loop's 1,424), else 2,048
//     (ENV_Q_NARROW: a 20 s chunk's row, 470 blocks, not 59), min(tile, B)
//     at a short B; the caller picks (chain_kernels.py `env_tile_frames`).  One
//     bulk copy (TMA) stages the tile's whole 16-byte quads in shared memory
//     (the row's edges and a tile off the 16-byte grid load their partial
//     quads directly); a thread takes quads t + 256h into registers as v =
//     fl(level + r) (thread 0 also the spill quad past the last) and keeps
//     them until it writes env;
//   - tiles are claimed in row-major order from an atomic ticket, so a tile
//     only ever waits on tiles that are already running;
//   - decoupled look-back, confined to the tile's envelope block: a tile
//     publishes its maximum (an aggregate), then its inclusive prefix, each
//     one 64-bit (status, value) word; warp 0 reads 32 predecessors at once
//     and stops at the first inclusive prefix, at the latest the block's
//     first tile in the chunk, which starts from the seed;
//   - the carry without a serial hop: the tile that ends block b publishes
//     S_b as its inclusive prefix, and warp 1 of every tile of block b
//     folds carry_b itself from the state's carry and S_0 .. S_{b-1} in
//     order, spinning on each until it is published (about 23 words at 2.9 M
//     frames a row, from L2), while warp 0 looks back.  Only after the
//     tile's own inclusive prefix is out: a carry folded first (while the
//     tile lands) made each block wait for the one before and took 0.42 ms;
//   - a warp whose values hold no NaN scans with fmaxf alone, and so does
//     pass 2 where neither the tile, its prefix nor the carry is a NaN (the
//     same bits: mx is fmaxf when no operand is a NaN); one int-to-float
//     conversion a quad (j + u is exact);
//   - the row's last tile writes the state out (m' = -1e9 if the chunk ends
//     on the grid, else its S; env_carry'), as device values.
// The flags and the ticket are zeroed by one cudaMemsetAsync on the launch's
// stream inside f9_slanted_cummax, so a call holds no host value that
// changes from call to call (a CUDA graph can replay it).  What holds it at
// ~0.10 ms (NVIDIA H100 80GB HBM3, 700 W; tools/chain_kernel_ablation.py):
// the one-block-a-tile streaming itself (a copy without look-back and
// carry takes as long; 3 blocks an SM at a 64 KB stage), not the
// look-back; tiles of 2,048 everywhere took 0.18 ms, one look-back each.
//
// f9_window_max replaces what XLA fuses from f9tpu/ops/chain.py:902
// _window_max_past: out[m] = max a[m-W+1..m], positions before the row's
// start read as +0.0 (so an output near the start is at least +0.0,
// whatever a negative input says).  Its twin,
// f9tpu_torch/ops/chain.py:_window_max_past_reference, takes log2 W shifted
// maxima by doubling (f = max(f, f shifted by s), s = 1, 2, 4, ... while 2s
// <= W, then once by W - s); the kernels compute the same tree in the same
// argument order, so even ties between +0.0 and -0.0 and NaNs resolve as
// the twin's do whatever the hardware's fmaxf does with them.  It is
// bytes-bound (the limiter's 8 x 1 x (T + 72) frames, read once and written
// once, 0.0555 ms).  Up to WMAX_REG_MAX_W (512, every shift at most one
// step) the tree runs in registers (wmax_reg): a warp streams a segment of
// a row in steps of 256 positions, 8 consecutive a lane, on the row's
// 16-byte grid; a shift of 8a + b is a shuffle by a or a + 1 lanes with the
// 8 - b or b positions it moves (the remainder b a template argument, so no
// register array is indexed at run time), and each level keeps its input of
// the step before, from which the shifts read back.  A segment starts
// ceil((W - 1) / 256) steps early to warm its levels; at the row's start
// every level's carried values are +0.0, the twin's F.pad.  Each sample is
// read once in 16-byte loads and written once in 16-byte stores (masked
// at the row's edges); no shared memory, no barrier.  Wider windows stage a
// tile of 2048 outputs and the W - 1 samples before them in shared memory
// and run each level from one buffer into the other (wmax_tile); a window
// whose two buffers pass a block's 227 KB (W > WMAX_STAGED_MAX_W) runs each
// level as a launch over device memory, through the caller's scratch row.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <mutex>

namespace {

#include "smem_limit.cuh"
#include "tma.cuh"

constexpr int ENV_THREADS = 256;
constexpr int ENV_WARPS = ENV_THREADS / 32;
// 16-byte quads a thread (its quad rows): a tile of 1024 ENV_Q frames, the
// wide one or the narrow one (chain_kernels.py `env_tile_frames`)
constexpr int ENV_Q_WIDE = 16;                    // 16,384 frames
constexpr int ENV_Q_NARROW = 2;                   // 2,048 frames
constexpr int ENV_MAX_BLOCK = 1 << 24;            // j stays exact in float32
constexpr float ENV_FLOOR = -1e9f;                // a block's seed past the first
constexpr unsigned ENV_AGGREGATE = 1u, ENV_INCLUSIVE = 2u;   // a flag's status

constexpr int WREG_THREADS = 128;                 // 4 warps a block, a segment each
constexpr int WREG_STEP = 256;                    // positions a warp step, 8 a lane
constexpr int WMAX_REG_MAX_W = 2 * WREG_STEP;     // every shift within one step
constexpr int WREG_MAX_DOUBLINGS = 9;             // shifts 1 .. 256

constexpr int WMAX_THREADS = 256;
constexpr int WMAX_TILE = WMAX_THREADS * 8;       // outputs a block of the staged form
constexpr int SMEM_STATIC_MAX = 48 * 1024;
constexpr int SMEM_BLOCK_MAX = 227 * 1024;
// the widest window whose two staged buffers fit a block (chain_kernels.py
// WMAX_STAGED_MAX_W)
constexpr int WMAX_STAGED_MAX_W = SMEM_BLOCK_MAX / 8 - WMAX_TILE + 1;
constexpr unsigned FULL = 0xffffffffu;

// torch.maximum on the card: a NaN operand wins (the first if both), else
// fmaxf
__device__ __forceinline__ float mx(float a, float b)
{
    return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ float warp_max(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = mx(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

// a float's offset, in floats, inside its 16-byte quad
__device__ __forceinline__ int quad_offset(const float* p)
{
    return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// A tile's flag is one 64-bit (status, value) word, read and written whole
// at the device's scope (single-copy atomic, from L2): nothing else passes
// between the tiles, so no write needs ordering before it and no read after
// it.  Release and acquire forms cost a MEMBAR.ALL.GPU before each store (it
// waits for the thread's loads and stores in flight) and a CCTL.IVALL after
// each load (it empties the SM's L1), and are slower
// (chain_kernel_ablation.py's `release_acquire`).
__device__ __forceinline__ unsigned long long ld_flag(const unsigned long long* p)
{
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void st_flag(unsigned long long* p, unsigned status, float v)
{
    const unsigned long long w = ((unsigned long long)status << 32) | __float_as_uint(v);
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" :: "l"(p), "l"(w) : "memory");
}

struct EnvGeom {
    long long T;          // frames of the chunk a row
    long long ntiles;     // tiles a row
    long long total;      // tiles in all, rows * ntiles
    int p0;               // the chunk's first frame's index in its block
    int B;                // the block length, a power of two
    int tile;             // the caller's: min(1024 ENV_Q, B)
    float cf;             // fl(c)
    bool ends;            // the chunk ends on the grid
};

// where tile `id` (row-major) lies
struct EnvTile {
    long long row, k;     // its row and its index in the row
    long long blk, k0;    // its envelope block and that block's first tile in the chunk
    const float* lp;      // level at its first frame
    float* ep;            // env at its first frame
    int n;                // frames
    int s;                // lp's offset in its 16-byte quad
    int j0;               // j of its first frame
    int q0, q1;           // its whole quads, [q0, q1): the bulk copy's
    bool vec_out;         // ep has lp's offset: quads store as float4
};

__device__ __forceinline__ EnvTile env_tile(const EnvGeom& g, const float* level, float* env,
                                            long long id)
{
    EnvTile c;
    c.row = id / g.ntiles;
    c.k = id - c.row * g.ntiles;
    const long long t0 = g.p0 / g.tile, tpb = g.B / g.tile;
    const long long t = t0 + c.k;
    long long a = t * g.tile - g.p0, b = a + g.tile;
    if (a < 0) a = 0;
    if (b > g.T) b = g.T;
    c.n = (int)(b - a);
    c.lp = level + c.row * g.T + a;
    c.ep = env + c.row * g.T + a;
    c.s = quad_offset(c.lp);
    c.vec_out = quad_offset(c.ep) == c.s;
    c.j0 = (int)((g.p0 + a) & (long long)(g.B - 1));
    c.blk = t / tpb;
    c.k0 = c.blk * tpb - t0 > 0 ? c.blk * tpb - t0 : 0;
    c.q0 = c.s > 0 ? 1 : 0;
    c.q1 = (c.n + c.s) >> 2;
    if (c.q1 < c.q0) c.q1 = c.q0;
    return c;
}

// quad q of a tile (elements 4q - s .. 4q - s + 3): a whole quad from the
// stage, the others from memory, +0.0 past the tile
__device__ __forceinline__ void env_quad(const EnvTile& c, const float* stage, int q,
                                         float (&v)[4])
{
    if (q >= c.q0 && q < c.q1) {
        const float4 w = reinterpret_cast<const float4*>(stage)[q];
        v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
        const int e0 = 4 * q - c.s;
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = e0 + u >= 0 && e0 + u < c.n ? __ldg(c.lp + e0 + u) : 0.0f;
    }
}

__device__ __forceinline__ void env_store_quad(const EnvTile& c, int q, bool vec,
                                               const float (&v)[4])
{
    const int e0 = 4 * q - c.s;
    if (vec && e0 >= 0 && e0 + 4 <= c.n) {
        *reinterpret_cast<float4*>(c.ep + e0) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (e0 + u >= 0 && e0 + u < c.n) c.ep[e0 + u] = v[u];
    }
}

// the maximum of a pass: torch's rule (mx) where an operand may be a NaN,
// else fmaxf alone, the same bits when neither is
template <bool EXACT>
__device__ __forceinline__ float mxe(float a, float b)
{
    return EXACT ? mx(a, b) : fmaxf(a, b);
}

// fl(level + fl(j * c)) of quad q (its level in v), -inf (the maximum's
// neutral) past the tile; returns their maximum.  One conversion a quad: j
// + u is exact in float32 (|j| < 2^24).
template <bool EXACT>
__device__ __forceinline__ float env_v(const EnvGeom& g, const EnvTile& c, int q, float (&v)[4])
{
    const int e0 = 4 * q - c.s;
    const float jq = (float)(c.j0 + e0);
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const float j = __fadd_rn(jq, (float)u);
        v[u] = e0 + u >= 0 && e0 + u < c.n ? __fadd_rn(v[u], __fmul_rn(j, g.cf)) : -INFINITY;
        m = mxe<EXACT>(m, v[u]);
    }
    return m;
}

// env of quad q from sp, the prefix entering it
template <bool EXACT>
__device__ __forceinline__ void env_write(const EnvGeom& g, const EnvTile& c, int q, float sp,
                                          float carry, const float (&v)[4], bool vec)
{
    const float jq = (float)(c.j0 + 4 * q - c.s);
    float e[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const float j = __fadd_rn(jq, (float)u);
        sp = mxe<EXACT>(sp, v[u]);
        e[u] = mxe<EXACT>(__fsub_rn(sp, __fmul_rn(j, g.cf)),
                          __fsub_rn(carry, __fmul_rn(g.cf, __fadd_rn(j, 1.0f))));
    }
    env_store_quad(c, q, vec, e);
}

// pass 1 of a tile for one thread: v of its quads (their level in v), each
// quad row's warp scan (ex: the lanes before this one) and the warps'
// maxima in s_part; the spill quad's maximum in xmax
template <int ENV_Q, bool EXACT>
__device__ __forceinline__ void env_pass1(const EnvGeom& g, const EnvTile& c, float (&v)[ENV_Q][4],
                                          float (&ex)[ENV_Q], float (&vx)[4], bool extra,
                                          float& xmax, float* s_part)
{
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
    for (int h = 0; h < ENV_Q; ++h) {
        float inc = env_v<EXACT>(g, c, t + ENV_THREADS * h, v[h]);
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc = mxe<EXACT>(y, inc);
        }
        ex[h] = __shfl_up_sync(FULL, inc, 1);
        if (lane == 31) s_part[h * ENV_WARPS + warp] = inc;
    }
    if (extra) xmax = env_v<EXACT>(g, c, ENV_THREADS * ENV_Q, vx);
}

// pass 2: env of the thread's quads from each one's prefix and v, kept in
// registers since pass 1 (forming v again from the stage was slower)
template <int ENV_Q, bool EXACT>
__device__ __forceinline__ void env_pass2(const EnvGeom& g, const EnvTile& c,
                                          const float (&v)[ENV_Q][4], const float (&ex)[ENV_Q],
                                          const float (&vx)[4], bool extra, const float* s_pre,
                                          float extra_pre, float carry)
{
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#pragma unroll
    for (int h = 0; h < ENV_Q; ++h) {
        float sp = s_pre[h * ENV_WARPS + warp];
        if (lane > 0) sp = mxe<EXACT>(sp, ex[h]);
        env_write<EXACT>(g, c, t + ENV_THREADS * h, sp, carry, v[h], c.vec_out);
    }
    if (extra) env_write<EXACT>(g, c, ENV_THREADS * ENV_Q, extra_pre, carry, vx, false);
}

// The envelope, one tile a block (see the header): the tile from a ticket,
// staged in shared memory by one bulk copy of its whole quads; pass 1 the
// quad rows' warp scans and maxima, warp 0 their scan, the aggregate, the
// look-back and the inclusive prefix while warp 1 folds the carry; pass 2
// env from v.
template <int ENV_Q>
__global__ void __launch_bounds__(ENV_THREADS)
env_scan(const float* __restrict__ level, const float* __restrict__ m_in,
         const float* __restrict__ c_in, float* __restrict__ env, float* __restrict__ m_out,
         float* __restrict__ c_out, unsigned long long* __restrict__ flags,
         unsigned* __restrict__ ticket, EnvGeom g)
{
    constexpr int ENV_PARTS = ENV_Q * ENV_WARPS;      // a (quad row, warp)'s maximum each
    constexpr int ENV_PER_LANE = (ENV_PARTS + 31) / 32;   // warp 0's scan of them
    extern __shared__ float4 env_stage4[];
    float* stage = reinterpret_cast<float*>(env_stage4);
    __shared__ uint64_t bar;
    __shared__ long long s_id;
    __shared__ float s_part[ENV_PER_LANE * 32], s_pre[ENV_PER_LANE * 32];
    __shared__ float s_P, s_extra_pre, s_incl, s_carry;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int qx = ENV_THREADS * ENV_Q;           // the spill quad
    if (t == 0) {
        mbar_init(&bar, 1);
        fence_mbarrier_init();
        const long long id = atomicAdd(ticket, 1u);
        s_id = id;
        const EnvTile c = env_tile(g, level, env, id);
        const uint32_t bytes = 16u * (uint32_t)(c.q1 - c.q0);
        mbar_arrive_expect_tx(&bar, bytes);
        if (bytes) bulk_g2s(stage + 4 * c.q0, c.lp - c.s + 4 * c.q0, bytes, &bar);
    }
    __syncthreads();
    const EnvTile c = env_tile(g, level, env, s_id);
    const long long t0 = g.p0 / g.tile, tpb = g.B / g.tile;
    unsigned long long* fr = flags + c.row * g.ntiles;
    mbar_wait(&bar, 0);

    // pass 1, with fmaxf alone in a warp whose values hold no NaN
    float v[ENV_Q][4], vx[4], ex[ENV_Q], xmax = -INFINITY;
    bool nan = false;
#pragma unroll
    for (int h = 0; h < ENV_Q; ++h) {
        env_quad(c, stage, t + ENV_THREADS * h, v[h]);
#pragma unroll
        for (int u = 0; u < 4; ++u) nan |= v[h][u] != v[h][u];
    }
    const bool extra = t == 0 && 4 * qx - c.s < c.n;
    if (extra) {
        env_quad(c, stage, qx, vx);
#pragma unroll
        for (int u = 0; u < 4; ++u) nan |= vx[u] != vx[u];
    }
    if (__any_sync(FULL, nan))
        env_pass1<ENV_Q, true>(g, c, v, ex, vx, extra, xmax, s_part);
    else
        env_pass1<ENV_Q, false>(g, c, v, ex, vx, extra, xmax, s_part);
    const bool tile_nan = __syncthreads_or(nan) != 0;

    if (warp == 0) {
        // the parts' scan in (quad row, warp) order, ENV_PER_LANE a lane:
        // the tile's maximum and each part's exclusive prefix; publish, look
        // back
        float pv[ENV_PER_LANE], run = -INFINITY;
#pragma unroll
        for (int i = 0; i < ENV_PER_LANE; ++i) {
            pv[i] = run;
            if (ENV_PER_LANE * lane + i < ENV_PARTS) run = mx(run, s_part[ENV_PER_LANE * lane + i]);
        }
        float inc = run;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const float y = __shfl_up_sync(FULL, inc, o);
            if (lane >= o) inc = mx(y, inc);
        }
        float exc = __shfl_up_sync(FULL, inc, 1);
        if (lane == 0) exc = -INFINITY;
        const float main = __shfl_sync(FULL, inc, 31);
        const float agg = mx(main, __shfl_sync(FULL, xmax, 0));
        float P;
        if (c.k == c.k0) {
            P = c.blk == 0 ? m_in[c.row] : ENV_FLOOR;
        } else {
            if (lane == 0) st_flag(fr + c.k, ENV_AGGREGATE, agg);
            P = -INFINITY;
            for (long long hi = c.k - 1;; hi -= 32) {
                const long long i = hi - lane;
                const bool valid = i >= c.k0;
                unsigned long long w = 0;
                if (valid) {
                    do {
                        w = ld_flag(fr + i);
                    } while ((unsigned)(w >> 32) == 0u);
                }
                const unsigned incs =
                    __ballot_sync(FULL, valid && (unsigned)(w >> 32) == ENV_INCLUSIVE);
                float val = valid ? __uint_as_float((unsigned)w) : -INFINITY;
                if (incs != 0u && lane > __ffs(incs) - 1) val = -INFINITY;
                P = mx(P, warp_max(val));
                if (incs != 0u) break;               // the block's first tile is inclusive
            }
        }
        const float incl = mx(P, agg);
        if (lane == 0) {
            st_flag(fr + c.k, ENV_INCLUSIVE, incl);
            s_P = P;
            s_extra_pre = mx(P, main);
            s_incl = incl;
        }
        // the prefix entering each part: P, the lanes before, this lane's
        // parts before
#pragma unroll
        for (int i = 0; i < ENV_PER_LANE; ++i)
            if (ENV_PER_LANE * lane + i < ENV_PARTS)
                s_pre[ENV_PER_LANE * lane + i] = mx(mx(P, exc), pv[i]);
    } else if (warp == 1) {
        // the carry entering the tile's block, folded from the blocks'
        // maxima S_b (each the inclusive prefix of its block's last tile) in
        // order
        const float r_last = __fmul_rn((float)(g.B - 1), g.cf);
        const float decay_b = __fmul_rn(g.cf, (float)g.B);  // fl(c) * (j + 1), j = B - 1
        float cr = c_in[c.row];
        for (long long b0 = 0; b0 < c.blk; b0 += 32) {
            const long long bb = b0 + lane;
            float S = 0.0f;
            if (bb < c.blk) {
                long long kl = (bb + 1) * tpb - t0;
                if (kl > g.ntiles) kl = g.ntiles;
                unsigned long long w;
                do {
                    w = ld_flag(fr + kl - 1);
                } while ((unsigned)(w >> 32) != ENV_INCLUSIVE);
                S = __uint_as_float((unsigned)w);
            }
            const int cnt = c.blk - b0 < 32 ? (int)(c.blk - b0) : 32;
#pragma unroll
            for (int i = 0; i < 32; ++i) {
                const float Si = __shfl_sync(FULL, S, i);
                if (i < cnt) cr = mx(__fsub_rn(Si, r_last), __fsub_rn(cr, decay_b));
            }
        }
        if (lane == 0) s_carry = cr;
    }
    __syncthreads();

    // pass 2, with fmaxf alone where no value it meets can be a NaN
    const float carry = s_carry;
    if (tile_nan || s_P != s_P || carry != carry)
        env_pass2<ENV_Q, true>(g, c, v, ex, vx, extra, s_pre, s_extra_pre, carry);
    else
        env_pass2<ENV_Q, false>(g, c, v, ex, vx, extra, s_pre, s_extra_pre, carry);
    if (t == 0 && c.k == g.ntiles - 1) {
        const float incl = s_incl;
        const float r_last = __fmul_rn((float)(g.B - 1), g.cf);
        const float decay_b = __fmul_rn(g.cf, (float)g.B);
        c_out[c.row] = g.ends ? mx(__fsub_rn(incl, r_last), __fsub_rn(carry, decay_b)) : carry;
        m_out[c.row] = g.ends ? ENV_FLOOR : incl;
    }
}

// ---------------------------------------------------------------- window max

// One level of the tree, shift 8a + Bm, on a lane's 8 positions f (the
// level's input this step) with pv the same lane's input of the step
// before: f[u] = mx(f[u], the input Bm positions back in this lane (u >=
// Bm) or 8 - Bm on in the lane before, a lanes further back; a lane that
// lies before lane 0 is read from the step before).  pv becomes this step's
// input.
template <int Bm, bool EXACT>
__device__ __forceinline__ void wlevel(float (&f)[8], float (&pv)[8], int a, int lane)
{
    float g[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        const int j = u >= Bm ? u - Bm : u - Bm + 8;
        const int r = u >= Bm ? a : a + 1;
        float src;
        if (r == 0) {
            src = f[j];
        } else {
            const float send = lane + r < 32 ? f[j] : pv[j];
            src = __shfl_sync(FULL, send, (lane - r) & 31);
        }
        g[u] = EXACT ? mx(f[u], src) : fmaxf(f[u], src);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
        pv[u] = f[u];
        f[u] = g[u];
    }
}

// the doubling levels L .. ND - 1: shift 2^L
template <int ND, bool EXACT, int L = 0>
__device__ __forceinline__ void wdoublings(float (&f)[8], float (&pv)[WREG_MAX_DOUBLINGS + 1][8],
                                           int lane)
{
    if constexpr (L < ND) {
        wlevel<(1 << L) & 7, EXACT>(f, pv[L], (1 << L) >> 3, lane);
        wdoublings<ND, EXACT, L + 1>(f, pv, lane);
    }
}

// the remainder level, shift W - 2^ND, its low three bits by template
template <bool EXACT>
__device__ __forceinline__ void wremainder(float (&f)[8], float (&pv)[8], int sh, int lane)
{
    const int a = sh >> 3;
    switch (sh & 7) {
    case 0: wlevel<0, EXACT>(f, pv, a, lane); break;
    case 1: wlevel<1, EXACT>(f, pv, a, lane); break;
    case 2: wlevel<2, EXACT>(f, pv, a, lane); break;
    case 3: wlevel<3, EXACT>(f, pv, a, lane); break;
    case 4: wlevel<4, EXACT>(f, pv, a, lane); break;
    case 5: wlevel<5, EXACT>(f, pv, a, lane); break;
    case 6: wlevel<6, EXACT>(f, pv, a, lane); break;
    default: wlevel<7, EXACT>(f, pv, a, lane); break;
    }
}

// one step's levels; EXACT takes torch's NaN rule (mx), else fmaxf alone,
// the same bits where no operand is a NaN
template <int ND, bool REM, bool EXACT>
__device__ __forceinline__ void wstep(float (&f)[8], float (&pv)[WREG_MAX_DOUBLINGS + 1][8],
                                      int rem, int lane)
{
    wdoublings<ND, EXACT>(f, pv, lane);
    if constexpr (REM) wremainder<EXACT>(f, pv[ND], rem, lane);
}

// a lane's 8 positions p .. p + 7 of a row (p + off a multiple of 4):
// +0.0 outside [0, T)
__device__ __forceinline__ void wload8(const float* xr, long long p, long long T, float (&f)[8])
{
    if (p >= 0 && p + 8 <= T) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(xr + p));
        const float4 b = __ldg(reinterpret_cast<const float4*>(xr + p + 4));
        f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
        f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) f[u] = p + u >= 0 && p + u < T ? xr[p + u] : 0.0f;
    }
}

__device__ __forceinline__ void wstore8(float* yr, long long p, long long T, bool vec,
                                        const float (&f)[8])
{
    if (vec && p >= 0 && p + 8 <= T) {
        reinterpret_cast<float4*>(yr + p)[0] = make_float4(f[0], f[1], f[2], f[3]);
        reinterpret_cast<float4*>(yr + p)[1] = make_float4(f[4], f[5], f[6], f[7]);
    } else {
#pragma unroll
        for (int u = 0; u < 8; ++u)
            if (p + u >= 0 && p + u < T) yr[p + u] = f[u];
    }
}

struct WregGeom {
    long long T;          // positions a row
    long long steps;      // steps a row: ceil((T + 3) / 256)
    long long segs;       // segments a row
    long long warps;      // rows * segs
    int seg_steps;        // steps a segment
    int warm;             // steps a segment starts early: ceil((W - 1) / 256)
    int rem;              // the remainder level's shift (0: none)
};

// Warp w: row w / segs, steps [k0, k0 + seg_steps) of the row's grid (step
// k = positions 256k - off .. 256k - off + 255, off the row's first
// position's offset in its 16-byte quad), warmed from k0 - warm.  ND
// doubling levels, then the remainder if REM.  A step whose outputs' windows
// (this step and the `warm` before it) hold no NaN takes fmaxf alone: every
// value its levels meet lies in those windows, so no operand is a NaN.
template <int ND, bool REM>
__global__ void __launch_bounds__(WREG_THREADS)
wmax_reg(const float* __restrict__ x, float* __restrict__ y, WregGeom g)
{
    const long long w = (long long)blockIdx.x * (WREG_THREADS / 32) + (threadIdx.x >> 5);
    if (w >= g.warps) return;
    const int lane = threadIdx.x & 31;
    const long long row = w / g.segs, seg = w - row * g.segs;
    const float* xr = x + row * g.T;
    float* yr = y + row * g.T;
    const int off = quad_offset(xr);
    const bool vec_out = quad_offset(yr) == off;
    const long long k0 = seg * g.seg_steps;
    const long long k1 = k0 + g.seg_steps < g.steps ? k0 + g.seg_steps : g.steps;
    long long k = k0 - g.warm < 0 ? 0 : k0 - g.warm;
    float pv[WREG_MAX_DOUBLINGS + 1][8];
#pragma unroll
    for (int l = 0; l < ND + (REM ? 1 : 0); ++l)
#pragma unroll
        for (int u = 0; u < 8; ++u) pv[l][u] = 0.0f;   // the row's start: F.pad's +0.0
    float nx[8];
    long long p = WREG_STEP * k - off + 8 * lane;
    wload8(xr, p, g.T, nx);
    const unsigned window = (2u << g.warm) - 1u;     // this step and `warm` before it
    unsigned nans = 0u;                               // a bit a step, newest lowest
    for (; k < k1; ++k, p += WREG_STEP) {
        float f[8];
        bool nan = false;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            f[u] = nx[u];
            nan |= f[u] != f[u];
        }
        nans = (nans << 1) | (__any_sync(FULL, nan) ? 1u : 0u);
        if (k + 1 < k1) wload8(xr, p + WREG_STEP, g.T, nx);
        if (nans & window)
            wstep<ND, REM, true>(f, pv, g.rem, lane);
        else
            wstep<ND, REM, false>(f, pv, g.rem, lane);
        if (k >= k0) wstore8(yr, p, g.T, vec_out, f);
    }
}

using WregKernel = void (*)(const float*, float*, WregGeom);

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
// state after the chunk (m_out, c_out).  `tile` is min(16384, B) or
// min(2048, B).  `scratch` holds scratch_len >= 2 * (1 + rows * ntiles)
// floats, 8-byte aligned (ntiles = ceil((p0 + T) / tile) - p0 / tile): the
// ticket, then a flag a tile.  One memset and one launch on `stream`;
// returns a CUDA error code.
int f9_slanted_cummax(const float* level, const float* m_in, const float* c_in, float* env,
                      float* m_out, float* c_out, float* scratch, long long scratch_len,
                      long long rows, long long T, int p0, int B, int tile, float cf,
                      void* stream)
{
    static int env_allowed[SMEM_MAX_DEVICES] = {}, env_allowed_narrow[SMEM_MAX_DEVICES] = {};
    if (B < 1 || (B & (B - 1)) != 0 || B > ENV_MAX_BLOCK || p0 < 0 || p0 >= B || T < 1
        || rows < 1 || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0)
        return (int)cudaErrorInvalidValue;
    EnvGeom g;
    g.T = T;
    g.p0 = p0;
    g.B = B;
    const int q = tile > 1024 * ENV_Q_NARROW ? ENV_Q_WIDE : ENV_Q_NARROW;
    if (tile != (B < 1024 * q ? B : 1024 * q)) return (int)cudaErrorInvalidValue;
    g.tile = tile;
    g.cf = cf;
    g.ends = ((p0 + T) & (long long)(B - 1)) == 0;
    g.ntiles = (p0 + T + g.tile - 1) / g.tile - p0 / g.tile;
    g.total = rows * g.ntiles;
    if (g.total > 0x7FFFFFFFLL || scratch_len < 2 * (1 + g.total))
        return (int)cudaErrorInvalidValue;
    // the stage: a tile's quads and its spill quad
    const int smem = (1024 * q + 4) * (int)sizeof(float);
    const void* fn = q == ENV_Q_WIDE ? (const void*)env_scan<ENV_Q_WIDE>
                                     : (const void*)env_scan<ENV_Q_NARROW>;
    cudaError_t e = cudaSuccess;
    if (smem > SMEM_STATIC_MAX) {
        e = allow_smem(fn, q == ENV_Q_WIDE ? env_allowed : env_allowed_narrow, smem);
        if (e != cudaSuccess) return (int)e;
    }
    unsigned long long* words = reinterpret_cast<unsigned long long*>(scratch);
    cudaStream_t st = (cudaStream_t)stream;
    e = cudaMemsetAsync(words, 0, (size_t)(1 + g.total) * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return (int)e;
    if (q == ENV_Q_WIDE)
        env_scan<ENV_Q_WIDE><<<(unsigned)g.total, ENV_THREADS, (size_t)smem, st>>>(
            level, m_in, c_in, env, m_out, c_out, words + 1, reinterpret_cast<unsigned*>(words),
            g);
    else
        env_scan<ENV_Q_NARROW><<<(unsigned)g.total, ENV_THREADS, (size_t)smem, st>>>(
            level, m_in, c_in, env, m_out, c_out, words + 1, reinterpret_cast<unsigned*>(words),
            g);
    return (int)cudaGetLastError();
}

// y (rows, T) = the causal windowed maximum of x (rows, T) over W >= 2
// positions, +0.0 read before the start, in `_window_max_past_reference`'s
// order.  W <= WMAX_REG_MAX_W runs in registers, segments of seg_steps
// steps of 256 positions a warp (chain_kernels.py `wmax_segment_steps`);
// W > WMAX_STAGED_MAX_W needs `scratch`, (rows, T) floats.  Launches on
// `stream`; returns a CUDA error code.
int f9_window_max(const float* x, float* y, float* scratch, long long rows, long long T, int W,
                  int seg_steps, void* stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    if (W < 2 || rows < 1 || T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (W <= WMAX_REG_MAX_W) {
        if (seg_steps < 1) return (int)cudaErrorInvalidValue;
        // by the remainder level, then the doubling levels
        static const WregKernel kernels[2][WREG_MAX_DOUBLINGS] = {
            {wmax_reg<1, false>, wmax_reg<2, false>, wmax_reg<3, false>, wmax_reg<4, false>,
             wmax_reg<5, false>, wmax_reg<6, false>, wmax_reg<7, false>, wmax_reg<8, false>,
             wmax_reg<9, false>},
            {wmax_reg<1, true>, wmax_reg<2, true>, wmax_reg<3, true>, wmax_reg<4, true>,
             wmax_reg<5, true>, wmax_reg<6, true>, wmax_reg<7, true>, wmax_reg<8, true>,
             wmax_reg<9, true>}};
        int nd = 0, s = 1;
        while (2 * s <= W) {
            ++nd;
            s *= 2;
        }
        WregGeom g;
        g.T = T;
        g.steps = (T + 3 + WREG_STEP - 1) / WREG_STEP;
        g.seg_steps = seg_steps;
        g.segs = (g.steps + seg_steps - 1) / seg_steps;
        g.warps = rows * g.segs;
        g.warm = (W - 1 + WREG_STEP - 1) / WREG_STEP;
        g.rem = W - s;
        const long long blocks = (g.warps + WREG_THREADS / 32 - 1) / (WREG_THREADS / 32);
        if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
        kernels[g.rem != 0][nd - 1]<<<(unsigned)blocks, WREG_THREADS, 0, st>>>(x, y, g);
        return (int)cudaGetLastError();
    }
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
