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
// bit for bit: each output is computed by one thread with the eager form's
// float32 operations in its order, every rounding an _rn intrinsic (nvcc
// would otherwise contract a product and a sum into one FMA).  Positions
// before a row's start are read as +0.0 and go through the same
// operations, as the eager form's zero padding does, so even a zero's sign
// matches.
//
// The fold's order.  The eager form walks taps k = 0..W-1 and keeps a stack
// of complete subtrees, merging two of equal size as soon as both exist;
// the leftover stack is merged from the smallest up.  Here the stack's
// three lowest levels live in registers (s0, s1, s2) and the walk is
// unrolled by eight taps, so those merges are fixed by the tap's place in
// its eight; a complete subtree of eight taps then enters a binary counter
// over the levels above (hi[], one access per eight taps).  The control
// flow depends on k alone, so a warp never diverges.
//
// What bounds them.  The fold does W products and W - 1 sums an output,
// each separately rounded, so none is half of an FMA: 46 M outputs x 702
// = 32.6 G float32 instructions for the insert loop's 351-tap EQ, 0.97 ms
// at the H100's 33.5 T float32 instructions a second (its 67 TFLOP/s
// counts an FMA as two), against 0.37 GB moved (0.11 ms).  The moving
// average does win - 1 sums an output; at the compressor's windows it is
// bound by its adds, not its bytes.  A block stages its span of the row
// (outputs + W - 1 samples) and the taps in shared memory once, so device
// memory is read about once; what is left is the thread's instruction
// stream.

#include <cuda_runtime.h>

namespace {

constexpr int FOLD_THREADS = 256;
constexpr int FOLD_PER_THREAD = 4;
constexpr int FOLD_TILE = FOLD_THREADS * FOLD_PER_THREAD;   // outputs a block
// levels of the counter above the eight-tap subtrees: W < 8 * 2^HI_LEVELS
constexpr int HI_LEVELS = 20;
// shared memory a block may use without raising its attribute
constexpr int SMEM_STATIC_MAX = 48 * 1024;

// One output of the fold: xe[-k] is x[n-k], tp[k] the taps.
__device__ __forceinline__ float fold_one(const float* xe, const float* tp, int W)
{
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    float hi[HI_LEVELS];
    const int q = W >> 3, r = W & 7;
    for (int j = 0; j < q; ++j) {
        const int k = j << 3;
        const float a0 = __fmul_rn(xe[-k], tp[k]);
        const float a1 = __fmul_rn(xe[-k - 1], tp[k + 1]);
        const float a2 = __fmul_rn(xe[-k - 2], tp[k + 2]);
        const float a3 = __fmul_rn(xe[-k - 3], tp[k + 3]);
        const float a4 = __fmul_rn(xe[-k - 4], tp[k + 4]);
        const float a5 = __fmul_rn(xe[-k - 5], tp[k + 5]);
        const float a6 = __fmul_rn(xe[-k - 6], tp[k + 6]);
        const float a7 = __fmul_rn(xe[-k - 7], tp[k + 7]);
        float t = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), __fadd_rn(a2, a3)),
                            __fadd_rn(__fadd_rn(a4, a5), __fadd_rn(a6, a7)));
        int l = 0;
        while ((j >> l) & 1) {
            t = __fadd_rn(hi[l], t);
            ++l;
        }
        hi[l] = t;
    }
    // the last r < 8 taps: levels 0-2 only, as the stack merges them
    const int k = q << 3;
    if (r > 0) s0 = __fmul_rn(xe[-k], tp[k]);
    if (r > 1) s1 = __fadd_rn(s0, __fmul_rn(xe[-k - 1], tp[k + 1]));
    if (r > 2) s0 = __fmul_rn(xe[-k - 2], tp[k + 2]);
    if (r > 3) s2 = __fadd_rn(s1, __fadd_rn(s0, __fmul_rn(xe[-k - 3], tp[k + 3])));
    if (r > 4) s0 = __fmul_rn(xe[-k - 4], tp[k + 4]);
    if (r > 5) s1 = __fadd_rn(s0, __fmul_rn(xe[-k - 5], tp[k + 5]));
    if (r > 6) s0 = __fmul_rn(xe[-k - 6], tp[k + 6]);
    // the leftover stack, from the smallest subtree up: acc = larger + acc
    bool have = false;
    float acc = 0.f;
    if (r & 1) { acc = s0; have = true; }
    if (r & 2) { acc = have ? __fadd_rn(s1, acc) : s1; have = true; }
    if (r & 4) { acc = have ? __fadd_rn(s2, acc) : s2; have = true; }
    for (int l = 0; (q >> l) != 0; ++l) {
        if ((q >> l) & 1) {
            acc = have ? __fadd_rn(hi[l], acc) : hi[l];
            have = true;
        }
    }
    return acc;
}

// Stage [n0 - span_pre, n0 + FOLD_TILE) of row `xr` (length T) in `xs`,
// +0.0 outside the row.
__device__ __forceinline__ void stage_span(float* xs, const float* xr, long long T,
                                           long long n0, int span_pre)
{
    const int span = FOLD_TILE + span_pre;
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const long long n = n0 - span_pre + i;
        xs[i] = (n >= 0 && n < T) ? xr[n] : 0.0f;
    }
}

// Block b: row b / tiles, outputs [n0, n0 + FOLD_TILE) of it.
__global__ void __launch_bounds__(FOLD_THREADS)
fir_fold_kernel(const float* x, const float* taps, float* y, long long T, long long tiles, int W)
{
    extern __shared__ float sm[];
    float* tp = sm;
    float* xs = sm + W;
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * FOLD_TILE;
    for (int i = threadIdx.x; i < W; i += blockDim.x) tp[i] = taps[i];
    stage_span(xs, x + row * T, T, n0, W - 1);
    __syncthreads();
#pragma unroll 1
    for (int j = 0; j < FOLD_PER_THREAD; ++j) {
        const int t = j * FOLD_THREADS + threadIdx.x;
        const float v = fold_one(xs + t + W - 1, tp, W);
        if (n0 + t < T) y[row * T + n0 + t] = v;
    }
}

// One output of the moving average, from the window's newest sample xe[0]
// back; `xr` the row and n the position when the window is not staged.
template <bool STAGED>
__device__ __forceinline__ float ma_one(const float* xe, const float* xr, long long n, int win,
                                        float inv)
{
    float acc = xe[0];
    for (int k = 1; k < win; ++k) {
        float v;
        if (STAGED) v = xe[-k];
        else v = (n - k >= 0) ? xr[n - k] : 0.0f;
        acc = __fadd_rn(acc, v);
    }
    return __fmul_rn(acc, inv);
}

template <bool STAGED>
__global__ void __launch_bounds__(FOLD_THREADS)
ma_past_kernel(const float* x, float* y, long long T, long long tiles, int win, float inv)
{
    extern __shared__ float xs[];
    const long long row = blockIdx.x / tiles;
    const long long n0 = (blockIdx.x - row * tiles) * FOLD_TILE;
    const float* xr = x + row * T;
    if (STAGED) {
        stage_span(xs, xr, T, n0, win - 1);
        __syncthreads();
    }
#pragma unroll 1
    for (int j = 0; j < FOLD_PER_THREAD; ++j) {
        const int t = j * FOLD_THREADS + threadIdx.x;
        const long long n = n0 + t;
        if (!STAGED && n >= T) break;
        const float v = STAGED ? ma_one<true>(xs + t + win - 1, xr, n, win, inv)
                               : ma_one<false>(xr + n, xr, n, win, inv);
        if (n < T) y[row * T + n] = v;
    }
}

int grid_of(long long rows, long long T, long long* tiles)
{
    *tiles = (T + FOLD_TILE - 1) / FOLD_TILE;
    const long long blocks = rows * *tiles;
    return (blocks < 1 || blocks > 0x7FFFFFFFLL) ? -1 : (int)blocks;
}

}  // namespace

extern "C" {

// y (rows, T) = the causal FIR of x (rows, T) with taps (W,), all float32 on
// the device, 2 <= W and the span and taps within a block's static shared
// memory.  Launches on `stream`; returns a CUDA error code (0 = launched).
int f9_fir_fold(const float* x, const float* taps, float* y, long long rows, long long T, int W,
                void* stream)
{
    long long tiles;
    const int blocks = grid_of(rows, T, &tiles);
    const long long smem = (long long)(2 * W - 1 + FOLD_TILE) * sizeof(float);
    if (W < 2 || W >= (8 << HI_LEVELS) || blocks < 0 || smem > SMEM_STATIC_MAX)
        return (int)cudaErrorInvalidValue;
    fir_fold_kernel<<<blocks, FOLD_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
        x, taps, y, T, tiles, W);
    return (int)cudaGetLastError();
}

// y (rows, T) = the causal moving average of x (rows, T) over win >= 2
// samples, each window summed newest first and times inv = f32(1 / win).
// A window whose span does not fit a block's static shared memory reads
// the row from device memory.  Launches on `stream`; returns a CUDA error
// code.
int f9_ma_past(const float* x, float* y, long long rows, long long T, int win, float inv,
               void* stream)
{
    long long tiles;
    const int blocks = grid_of(rows, T, &tiles);
    if (win < 2 || blocks < 0) return (int)cudaErrorInvalidValue;
    const long long smem = (long long)(win - 1 + FOLD_TILE) * sizeof(float);
    if (smem <= SMEM_STATIC_MAX)
        ma_past_kernel<true><<<blocks, FOLD_THREADS, (size_t)smem, (cudaStream_t)stream>>>(
            x, y, T, tiles, win, inv);
    else
        ma_past_kernel<false><<<blocks, FOLD_THREADS, 0, (cudaStream_t)stream>>>(
            x, y, T, tiles, win, inv);
    return (int)cudaGetLastError();
}

}  // extern "C"
