// The insert chain's short FIR fold and causal moving average on Hopper
// (sm_90a).
//
// f9_fir_fold replaces what XLA fuses from f9tpu/ops/chain.py:85 _fir_fold
// (W shifted scalar products combined in a fixed pairwise tree; the EQ
// biquad's 351-tap IR, FIR inserts up to 1024 taps); f9_ma_past what it
// fuses from f9tpu/ops/chain.py:873 _uniform_ma_past (acc = x[n]; acc +=
// x[n-1]; ... acc += x[n-win+1]; acc * f32(1/win): the compressor's,
// expander's and limiter's windows).  Their plain twins are
// f9tpu_torch/ops/chain.py:_fir_fold_reference and
// _uniform_ma_past_reference, the eager forms, which both kernels match
// bit for bit: each output is computed with the eager form's float32
// operations in its order, every rounding an _rn intrinsic (nvcc would
// otherwise contract a product and a sum into one FMA).  Positions before a
// row's start are read as +0.0 and go through the same operations, as the
// eager form's zero padding does, so even a zero's sign matches.
//
// The fold's order.  The eager form walks taps k = 0..W-1 and keeps a stack
// of complete subtrees, merging two of equal size as soon as both exist;
// the leftover stack is merged from the smallest up.  Here the walk goes by
// eight taps, each eight a fixed tree ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7));
// two eights make a subtree of 16 (the stack's merge of eight j and eight
// j + 1, j even); the 16s enter a binary counter, whose level l holds a
// subtree of 16 * 2^l taps; the last eight (odd W / 8), the last W mod 8
// taps and the counter's levels are merged from the smallest up.  The
// counter is nested at compile time by level and ends by a branch that is
// the same for every thread, so no level is indexed at run time and a warp
// never diverges.  Its levels 0-2 are registers; levels 3-8, touched once
// per 128 taps or fewer, sit in the thread's own column of shared memory.
//
// What bounds it.  W products and W - 1 sums an output, each separately
// rounded, so none is half of an FMA: 46 M outputs x 701 = 32.6 G float32
// instructions for the insert loop's 351-tap EQ, 0.97 ms at the H100's
// 33.5 T float32 instructions a second (its 67 TFLOP/s counts an FMA as
// two), against 0.37 GB moved (0.11 ms).  The first design (a thread an
// output) made two shared-memory loads a tap, the sample and the tap, and
// the SM's shared memory serves one 32-bit warp load a clock while its
// float32 lanes take four warp instructions: 4.1 ms, bound by the loads.
// Now a thread owns FOLD_R = 8 consecutive outputs and slides their window
// of samples through registers: a step of eight taps loads the 8 samples
// new to the window and the 8 taps (four 16-byte loads, the taps the same
// address across the warp) for 64 products, so the float32 instructions,
// about 92 % of what a thread issues, set the pace, and occupancy decides
// how well the loads' latency hides: with all nine levels in registers a
// thread took 152 registers (12 warps an SM) and 1.54 ms; with the upper
// six in shared memory 79 registers and 1.40 ms (PERF.md, section 6).  A
// block stages its span of the row (1024 outputs and 8 * (W / 8) + 7
// samples before them) and the taps in shared memory once by 4-byte
// cp.async (a row's start has no alignment), and writes its outputs back
// through shared memory, a warp store of 128 contiguous bytes at a time.
// A span past 48 KB (W > 2,559 with the counter's columns) raises the
// kernel's shared-memory limit.
//
// The moving average does win - 1 sums an output, each separately rounded
// (the window is summed newest first from x[n], so a sliding sum, which
// would round differently, is out): at the compressor's attack window (240)
// 23.2 M outputs x 240 = 5.6 G float32 instructions, 0.17 ms at 33.5 T a
// second, against 0.19 GB moved (0.06 ms), so it is bound by its adds.  The
// first design (a thread an output) made a shared-memory load for every
// add, and the SM's one 32-bit warp load a clock took the time (0.71-0.76
// ms at win 240, 22 % of the bound).  Now, as in the fold, a thread owns
// MA_R = 8 consecutive outputs and slides their window through registers:
// the loop over k is unrolled by 8, so the rotation is static and a step of
// 8 k loads the 8 samples new to the window (two 16-byte loads) for 64
// adds.  A block stages its span (2048 outputs and the window's 8 * ((win -
// 1) / 8 + 1) samples before them) once by cp.async, a tile inside the row
// without a bounds check a sample (by count, the checked 64-bit index is
// about a dozen instructions a sample, as many as 12 of the adds); a span past
// 48 KB (win > ~10,000) raises the kernel's shared-memory limit, and only
// past the block's 227 KB does the kernel read the row from device memory.
// Outputs go back through shared memory, a warp's stores contiguous.

#include <cuda_runtime.h>

#include <mutex>

namespace {

#include "smem_limit.cuh"

constexpr int FOLD_R = 8;                       // consecutive outputs a thread
constexpr int FOLD_THREADS = 128;
constexpr int FOLD_TILE = FOLD_THREADS * FOLD_R;   // outputs a block
// the widest fold (chain_kernels.FOLD_MAX_W), and the counter's levels of
// 16-tap subtrees it needs: FOLD_MAX_W / 16 < 2^PAIR_LEVELS
constexpr int FOLD_MAX_W = 5632;
constexpr int PAIR_LEVELS = 9;
// the counter's levels kept in registers; the rest, each touched once per
// 16 * 2^l taps, live in shared memory
constexpr int REG_LEVELS = 3;
static_assert((FOLD_MAX_W >> 4) < (1 << PAIR_LEVELS), "the counter is too shallow");
static_assert(FOLD_R % 4 == 0 && FOLD_R <= 8, "a step keeps R - 1 samples of the last");

constexpr int MA_R = 8;                         // consecutive outputs a thread
constexpr int MA_THREADS = 256;
constexpr int MA_TILE = MA_THREADS * MA_R;      // outputs a block
static_assert(MA_R == 8, "a step loads its new samples as one load8");
// shared memory a block may use without raising its attribute, and at most
constexpr int SMEM_STATIC_MAX = 48 * 1024;
constexpr int SMEM_BLOCK_MAX = 227 * 1024;

// 4 bytes global -> shared without passing through registers; +0.0 when
// `ok` is false (the source is then not read)
__device__ __forceinline__ void cp_async4_or_zero(float* dst, const float* src, bool ok)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void load8(float (&v)[8], const float* p)   // p 16-byte aligned
{
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// One step of eight taps k = 8j + u for the thread's FOLD_R outputs: t[i] =
// the eight's fixed tree for output i.  The window sample x[n_i - k] is
// w[7 + i - u], w[0..7] = `now` (the samples new in this step) and w[8..14]
// = `last` (the previous step's new samples).
__device__ __forceinline__ void eight(float (&t)[FOLD_R], const float (&now)[8],
                                      const float (&last)[8], const float* tp8)
{
    float tk[8];
    load8(tk, tp8);
#pragma unroll
    for (int i = 0; i < FOLD_R; ++i) {
        float a[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
            const int m = 7 + i - u;
            a[u] = __fmul_rn(m < 8 ? now[m] : last[m - 8], tk[u]);
        }
        t[i] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), __fadd_rn(a[2], a[3])),
                         __fadd_rn(__fadd_rn(a[4], a[5]), __fadd_rn(a[6], a[7])));
    }
}

// The counter's level L for output i: a register below REG_LEVELS, else
// the thread's own column of shared memory (hs, stride FOLD_THREADS).
template <int L>
__device__ __forceinline__ float& level(float (&hr)[REG_LEVELS][FOLD_R], float* hs, int i)
{
    if constexpr (L < REG_LEVELS) return hr[L][i];
    else return hs[((L - REG_LEVELS) * FOLD_R + i) * FOLD_THREADS];
}

// The counter takes the 16-tap subtree t of pair ip: while bit L of ip is
// set, t = level L + t (the older subtree on the left); then t rests at
// level L.  Nested by L at compile time, so no level is indexed at run time.
template <int L>
__device__ __forceinline__ void carry(float (&hr)[REG_LEVELS][FOLD_R], float* hs,
                                      float (&t)[FOLD_R], int ip)
{
    if constexpr (L < PAIR_LEVELS) {
        if ((ip >> L) & 1) {
#pragma unroll
            for (int i = 0; i < FOLD_R; ++i) t[i] = __fadd_rn(level<L>(hr, hs, i), t[i]);
            carry<L + 1>(hr, hs, t, ip);
        } else {
#pragma unroll
            for (int i = 0; i < FOLD_R; ++i) level<L>(hr, hs, i) = t[i];
        }
    }
}

// The counter's levels that qp's bits name, from the lowest up, into acc:
// acc = level + acc, or the level itself if acc holds nothing yet.
template <int L>
__device__ __forceinline__ void merge(float (&hr)[REG_LEVELS][FOLD_R], float* hs, int qp, int i,
                                      float& acc, bool& have)
{
    if constexpr (L < PAIR_LEVELS) {
        if ((qp >> L) & 1) {
            acc = have ? __fadd_rn(level<L>(hr, hs, i), acc) : level<L>(hr, hs, i);
            have = true;
        }
        merge<L + 1>(hr, hs, qp, i, acc, have);
    }
}

// Block b: row b / tiles, outputs [n0, n0 + FOLD_TILE) of it; thread t
// outputs n0 + FOLD_R * t + i, i < FOLD_R.
__global__ void __launch_bounds__(FOLD_THREADS)
fir_fold_kernel(const float* __restrict__ x, const float* __restrict__ taps,
                float* __restrict__ y, long long T, long long tiles, int W)
{
    extern __shared__ float4 sm4[];
    float* sm = reinterpret_cast<float*>(sm4);
    const int q = W >> 3, r = W & 7, qp = q >> 1;
    const int n_tp = 8 * q + 8;              // taps, +0.0 past W
    const int pre = 8 * q + 7;               // samples before the tile
    const int n_xs = pre + FOLD_TILE + 1;
    float* tp = sm;
    float* xs = sm + n_tp;                   // 32-byte aligned: n_tp is a multiple of 8
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * FOLD_TILE;
    const float* xr = x + row * T;
    for (int i = threadIdx.x; i < n_tp; i += FOLD_THREADS)
        cp_async4_or_zero(tp + i, taps + (i < W ? i : 0), i < W);
    for (int i = threadIdx.x; i < n_xs; i += FOLD_THREADS) {
        const long long n = n0 - pre + i;
        const bool ok = n >= 0 && n < T;
        cp_async4_or_zero(xs + i, xr + (ok ? n : 0), ok);
    }
    cp_async_wait_all();
    __syncthreads();

    // xw[m - 8j] = x[n_0 - 8j - 7 + m]: step j's window (32-byte aligned)
    const float* xw = xs + 8 * q + FOLD_R * threadIdx.x;
    float A[8], C[8], hr[REG_LEVELS][FOLD_R], lone[FOLD_R];
    float* hs = xs + n_xs + threadIdx.x;     // the counter's upper levels, this thread's
    load8(C, xw + 8);                        // "step -1"'s new samples
#pragma unroll 1
    for (int ip = 0; ip < qp; ++ip) {
        const int j = 2 * ip;
        float te[FOLD_R], t[FOLD_R];
        load8(A, xw - 8 * j);
        eight(te, A, C, tp + 8 * j);
        load8(C, xw - 8 * (j + 1));
        eight(t, C, A, tp + 8 * (j + 1));
#pragma unroll
        for (int i = 0; i < FOLD_R; ++i) t[i] = __fadd_rn(te[i], t[i]);
        carry<0>(hr, hs, t, ip);
    }
    if (q & 1) {                             // the last eight, alone
        load8(A, xw - 8 * (q - 1));
        eight(lone, A, C, tp + 8 * (q - 1));
    }
    // the last r < 8 taps k = 8q + u, merged as the stack merges them
    float out[FOLD_R];
    {
        float w0[8], w1[8], tk[8];
        load8(tk, tp + 8 * q);
        load8(w0, xw - 8 * q);
        load8(w1, xw - 8 * q + 8);
#pragma unroll
        for (int i = 0; i < FOLD_R; ++i) {
            auto p = [&](int u) {
                const int m = 7 + i - u;
                return __fmul_rn(m < 8 ? w0[m] : w1[m - 8], tk[u]);
            };
            float s0 = 0.f, s1 = 0.f, s2 = 0.f;
            if (r > 0) s0 = p(0);
            if (r > 1) s1 = __fadd_rn(s0, p(1));
            if (r > 2) s0 = p(2);
            if (r > 3) s2 = __fadd_rn(s1, __fadd_rn(s0, p(3)));
            if (r > 4) s0 = p(4);
            if (r > 5) s1 = __fadd_rn(s0, p(5));
            if (r > 6) s0 = p(6);
            // the leftover stack, from the smallest subtree up: acc = larger + acc
            bool have = false;
            float acc = 0.f;
            if (r & 1) { acc = s0; have = true; }
            if (r & 2) { acc = have ? __fadd_rn(s1, acc) : s1; have = true; }
            if (r & 4) { acc = have ? __fadd_rn(s2, acc) : s2; have = true; }
            if (q & 1) { acc = have ? __fadd_rn(lone[i], acc) : lone[i]; have = true; }
            merge<0>(hr, hs, qp, i, acc, have);
            out[i] = acc;
        }
    }
    // through shared memory, so a warp's stores are contiguous
    __syncthreads();
#pragma unroll
    for (int i = 0; i < FOLD_R; i += 4)
        reinterpret_cast<float4*>(xs + FOLD_R * threadIdx.x + i)[0] =
            make_float4(out[i], out[i + 1], out[i + 2], out[i + 3]);
    __syncthreads();
    float* yr = y + row * T + n0;
#pragma unroll
    for (int k = 0; k < FOLD_R; ++k) {
        const int i = k * FOLD_THREADS + threadIdx.x;
        if (n0 + i < T) yr[i] = xs[i];
    }
}

// Samples staged before a tile of the moving average: every eight of steps
// its first thread walks back through, the last (partial) eight's 8 samples
// whole.
__host__ __device__ __forceinline__ int ma_pre(int win)
{
    return MA_R * ((win - 1) / MA_R + 1);
}

// Steps k = 1 + 8j + u, u < `steps`, of eight j for the thread's MA_R
// outputs: acc_i += x[nt + i - k], which is now[m] or last[m - 8], m = 7 + i
// - u.  Inlined with steps = MA_R in the loop, so every index is static.
__device__ __forceinline__ void ma_eight(float (&acc)[MA_R], const float (&now)[MA_R],
                                         const float (&last)[MA_R], int steps)
{
#pragma unroll
    for (int u = 0; u < MA_R; ++u) {
        if (u < steps) {
#pragma unroll
            for (int i = 0; i < MA_R; ++i) {
                const int m = MA_R - 1 + i - u;
                acc[i] = __fadd_rn(acc[i], m < MA_R ? now[m] : last[m - MA_R]);
            }
        }
    }
}

// A thread's MA_R outputs nt + i, i < MA_R: acc_i = x[nt + i], then step k =
// 1 .. win - 1 adds x[nt + i - k], times inv.  Steps go by eights: eight j
// (k = 1 + 8j + u, u < 8) reads x[nt - 8(j + 1) .. nt - 8j + 7], the 8
// samples `now` new in it and the 8 `last` of eight j - 1 (eight -1's are
// the k = 0 terms x[nt .. nt + 7]); two register windows take the roles in
// turns.  load(v, b) gives x[b .. b + 7].
template <typename Load>
__device__ __forceinline__ void ma_outputs(float (&out)[MA_R], const Load& load, long long nt,
                                           int q, int r, float inv)
{
    float acc[MA_R], A[MA_R], C[MA_R];
    load(C, nt);
#pragma unroll
    for (int i = 0; i < MA_R; ++i) acc[i] = C[i];
    int j = 0;
#pragma unroll 1
    for (; j + 1 < q; j += 2) {
        load(A, nt - MA_R * (j + 1));
        ma_eight(acc, A, C, MA_R);
        load(C, nt - MA_R * (j + 2));
        ma_eight(acc, C, A, MA_R);
    }
    if (j < q) {                              // an odd eight left: its window becomes C
        load(A, nt - MA_R * (j + 1));
        ma_eight(acc, A, C, MA_R);
#pragma unroll
        for (int i = 0; i < MA_R; ++i) C[i] = A[i];
    }
    if (r) {                                  // the same for every thread
        load(A, nt - MA_R * (q + 1));
        ma_eight(acc, A, C, r);
    }
#pragma unroll
    for (int i = 0; i < MA_R; ++i) out[i] = __fmul_rn(acc[i], inv);
}

// The staged form: block b is row b / tiles, outputs [n0, n0 + MA_TILE) of
// it, thread t outputs n0 + 8t + i.  The block stages its span once by
// cp.async; a tile inside the row (the common case) does so, and stores its
// outputs, without a bounds check a sample.  The outputs go back through
// the span's buffer, a warp's stores contiguous.
__global__ void __launch_bounds__(MA_THREADS)
ma_past_tiles(const float* __restrict__ x, float* __restrict__ y, long long T, long long tiles,
              int win, float inv)
{
    extern __shared__ float4 ma_sm4[];
    float* xs = reinterpret_cast<float*>(ma_sm4);
    const int pre = ma_pre(win), span = pre + MA_TILE;
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * MA_TILE;
    const float* xr = x + row * T;
    const bool inside = n0 - pre >= 0 && n0 + MA_TILE <= T;
    if (inside) {
        const float* src = xr + (n0 - pre);
        for (int i = threadIdx.x; i < span; i += MA_THREADS)
            cp_async4_or_zero(xs + i, src + i, true);
    } else {
        for (int i = threadIdx.x; i < span; i += MA_THREADS) {
            const long long n = n0 - pre + i;
            const bool ok = n >= 0 && n < T;
            cp_async4_or_zero(xs + i, xr + (ok ? n : 0), ok);
        }
    }
    cp_async_wait_all();
    __syncthreads();
    // xs + (b - (n0 - pre)) is 32-byte aligned for every b a thread loads
    auto load = [&](float (&v)[MA_R], long long b) { load8(v, xs + (b - (n0 - pre))); };
    float out[MA_R];
    ma_outputs(out, load, n0 + MA_R * threadIdx.x, (win - 1) / MA_R, (win - 1) % MA_R, inv);
    __syncthreads();
    reinterpret_cast<float4*>(xs + MA_R * threadIdx.x)[0] =
        make_float4(out[0], out[1], out[2], out[3]);
    reinterpret_cast<float4*>(xs + MA_R * threadIdx.x)[1] =
        make_float4(out[4], out[5], out[6], out[7]);
    __syncthreads();
    float* yr = y + row * T + n0;
    if (n0 + MA_TILE <= T) {
#pragma unroll
        for (int k = 0; k < MA_R; ++k) {
            const int i = k * MA_THREADS + threadIdx.x;
            yr[i] = xs[i];
        }
    } else {
#pragma unroll
        for (int k = 0; k < MA_R; ++k) {
            const int i = k * MA_THREADS + threadIdx.x;
            if (n0 + i < T) yr[i] = xs[i];
        }
    }
}

// The unstaged form, for windows whose span passes a block's 227 KB:
// block b is row b / tiles, outputs [n0, n0 + MA_TILE); the samples come
// from the row (+0.0 outside it).
__global__ void __launch_bounds__(MA_THREADS)
ma_past_rows(const float* __restrict__ x, float* __restrict__ y, long long T, long long tiles,
             int win, float inv)
{
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * MA_TILE;
    const float* xr = x + row * T;
    const long long nt = n0 + MA_R * threadIdx.x;
    auto load = [&](float (&v)[MA_R], long long b) {
#pragma unroll
        for (int u = 0; u < MA_R; ++u) v[u] = (b + u >= 0 && b + u < T) ? xr[b + u] : 0.0f;
    };
    float out[MA_R];
    ma_outputs(out, load, nt, (win - 1) / MA_R, (win - 1) % MA_R, inv);
#pragma unroll
    for (int i = 0; i < MA_R; ++i)
        if (nt + i < T) y[row * T + nt + i] = out[i];
}

int grid_of(long long rows, long long T, long long* tiles)
{
    *tiles = (T + MA_TILE - 1) / MA_TILE;
    const long long blocks = rows * *tiles;
    return (blocks < 1 || blocks > 0x7FFFFFFFLL) ? -1 : (int)blocks;
}

}  // namespace

extern "C" {

// y (rows, T) = the causal FIR of x (rows, T) with taps (W,), all float32 on
// the device, 2 <= W <= FOLD_MAX_W.  Launches on `stream`; returns a CUDA
// error code (0 = launched).
int f9_fir_fold(const float* x, const float* taps, float* y, long long rows, long long T, int W,
                void* stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    const long long tiles = (T + FOLD_TILE - 1) / FOLD_TILE;
    const long long blocks = rows * tiles;
    if (W < 2 || W > FOLD_MAX_W || blocks < 1 || blocks > 0x7FFFFFFFLL)
        return (int)cudaErrorInvalidValue;
    const int q = W >> 3;
    const int smem = (int)sizeof(float) * ((8 * q + 8) + (8 * q + 8 + FOLD_TILE)
                                           + (PAIR_LEVELS - REG_LEVELS) * FOLD_R * FOLD_THREADS);
    cudaError_t e = allow_smem((const void*)fir_fold_kernel, allowed, smem);
    if (e != cudaSuccess) return (int)e;
    fir_fold_kernel<<<(unsigned)blocks, FOLD_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        x, taps, y, T, tiles, W);
    return (int)cudaGetLastError();
}

// y (rows, T) = the causal moving average of x (rows, T) over win >= 2
// samples, each window summed newest first and times inv = f32(1 / win).
// A span past 48 KB raises the staged form's shared-memory limit; past a
// block's 227 KB the unstaged form reads the row from device memory.
// Launches on `stream`; returns a CUDA error code.
int f9_ma_past(const float* x, float* y, long long rows, long long T, int win, float inv,
               void* stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    long long tiles;
    const int blocks = grid_of(rows, T, &tiles);
    if (win < 2 || blocks < 0) return (int)cudaErrorInvalidValue;
    const long long smem = (long long)(ma_pre(win) + MA_TILE) * (long long)sizeof(float);
    if (smem > SMEM_BLOCK_MAX) {
        ma_past_rows<<<blocks, MA_THREADS, 0, (cudaStream_t)stream>>>(x, y, T, tiles, win, inv);
        return (int)cudaGetLastError();
    }
    if (smem > SMEM_STATIC_MAX) {
        const cudaError_t e = allow_smem((const void*)ma_past_tiles, allowed, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    ma_past_tiles<<<blocks, MA_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        x, y, T, tiles, win, inv);
    return (int)cudaGetLastError();
}

}  // extern "C"
