// The cycle SRC of a dense bank with L < 8 phases as a float64 fold on
// Hopper (sm_90a), and the same fold fused with the absolute maximum of its
// output (the 4x true-peak oversampler's peak).
//
// What it replaces.  The JAX package computes the streamed SRC of a dense
// bank as an XLA convolution at HIGHEST precision
// (f9tpu/ops/resample.py:307 resample_presliced) and the true peak of a
// metering chunk as the maximum of its absolute value
// (f9tpu/ops/loudness.py:363 _tp_step); its Pallas kernel
// (f9tpu/ops/pallas_src.py) takes neither, since it needs L >= 8 and M >= 16,
// and neither does the port's cycle_src (L >= 8).  Their plain twins are
// f9tpu_torch/ops/src_plain.py:_presliced_fold (one float64 pass per non-zero
// row of G) and torch.max(torch.abs(_presliced_fold(...))).
//
// Three launch forms share the kernel.  The presliced one (f9_cycle_fold, y
// or peak) reads a chunk that carries its own halos: cycle q reads samples
// q * M .. q * M + W - 1 of its row.  The flat one (f9_cycle_fold_flat, the
// batch SRC) reads the unpadded signal: cycle q
// reads q * M + w - pad_front, as +0.0 outside [0, keep), which is what the
// twin reads from F.pad(x[..., :keep], (pad_front, pad_back)).  Both forms
// stage a block's span by the same loop; the presliced form is the flat one
// with pad_front = 0 and keep = T.  A padded zero's product is +-0.0 and
// every sum starts from +0.0, so the pads leave every bit as the twin's.
//
// Bit for bit the twin.  The twin forms y[q, l] = sum_w x[q*M + w] * G[w, l]
// in float64 over the rows w of its table (`_fold_rows`: the rows of G with a
// non-zero entry, each with the range [lo, hi) of its non-zero columns), w
// ascending, each output's sum started at +0.0, and rounds to float32 once.
// A float32 sample times a float32 tap is exact in float64 (48 significant
// bits in 53, no exponent overflow or underflow), so fma(x, g, acc) rounds
// once where the twin's product and sum round once: the same bits, whether
// nvcc contracts or not.  The kernel keeps one accumulator per output, walks
// the same table in the same order, adds the entries that are zero inside
// [lo, hi) (inf * 0 is a NaN in the twin too) and skips the columns outside
// it, and rounds by __double2float_rn once.  The peak is max |float32(y)|
// taken on the bit pattern: for non-negative floats the bits order as the
// values do, a NaN with its sign cleared sorts above +inf (so a NaN anywhere
// gives a NaN, as torch.max does), -0.0 becomes +0.0 and silence gives +0.0.
// Each block reduces its outputs' patterns in registers and shared memory and
// makes one atomicMax into a word the entry zeroes by cudaMemsetAsync.
//
// What bounds it.  rows x cycles x sum(hi - lo) float64 FMAs (for the 4x
// true-peak bank, L = 4, M = 1, W = 128: 512 a cycle; a 20 s meter chunk at
// 44.1 kHz, 2 x 882,000 cycles, 0.90 G, 0.054 ms at 16.75 T FMAs/s) against
// the chunk read once and y written once (0.002 ms): the FMAs bound it, and
// beside each FMA the operands' loads and the sample's conversion to float64.
// The design: a block of `threads` (128, or 64 / 32 where a wide bank's
// span would not fit) takes FOLD_C * threads consecutive cycles of one row
// and stages its span of the row ((cycles - 1) * M + W samples, as float32),
// the bank's non-zero rows of G (float64) and the row table in shared memory
// once.  The span is stored split by phase (sample n at (n % M) * P + n / M),
// so that lanes on consecutive cycles read consecutive words whatever M is:
// no bank conflict.  Thread t takes the cycles t + threads * i, i < FOLD_C,
// and for each row of the table loads its FOLD_C samples (one conversion to
// float64 each) and the row's L taps (the same address across the warp), so
// one tap serves FOLD_C FMAs and one sample L.  The FOLD_C x L accumulators
// are registers: the loops over i and l are unrolled at compile time (L is a
// template parameter) and a column outside [lo, hi) is a predicate, never a
// runtime index; a row whose range is every column (all but a few rows of a
// sinc bank) takes a branch without predicates, the same for the whole
// block.  Per row a warp issues FOLD_C x L FMAs beside FOLD_C sample loads
// and conversions (the conversion to float64 runs at a quarter of the FMA's
// rate), L tap loads and one table load: 8 cycles a thread rather than 4
// halve the table's and the taps' share (tools/chain_kernel_ablation.py
// --kernels cycle_fold times both, and the predicated rows).

#include <cuda_runtime.h>

#include <mutex>

namespace {

#include "smem_limit.cuh"

constexpr int FOLD_C = 8;               // cycles a thread
constexpr int FOLD_MAX_L = 7;
constexpr int FOLD_MAX_THREADS = 128;
constexpr int SMEM_BLOCK_MAX = 227 * 1024;

// A table entry: the row's word in the staged span << 6 | lo << 3 | hi.
// In device memory the word is w itself; the generic form's block turns it
// into the span's phase-split offset (w % M) * P + w / M.
__device__ __forceinline__ int entry_off(int e) { return e >> 6; }
__device__ __forceinline__ int entry_lo(int e) { return (e >> 3) & 7; }
__device__ __forceinline__ int entry_hi(int e) { return e & 7; }

// The slid form takes M = MS in {1, 2, 4} where every row of G is non-zero
// and its window and accumulators fit FOLD_SLIDE_DOUBLES registers' worth.
constexpr int FOLD_SLIDE_DOUBLES = 64;
__host__ __device__ constexpr bool slide_ok(int L, int MS)
{
    return (MS == 1 || MS == 2 || MS == 4) && FOLD_C * (MS + L) <= FOLD_SLIDE_DOUBLES;
}

// acc[i][l] += xv(i) * G[r][l] over the row's columns: every column with no
// predicate where the row takes them all (lo == 0, hi == L: all but a few
// rows of a sinc bank, the same branch for the whole block, and every row of
// a bank with L = 1, whose entry is then never read), else the columns in
// [lo, hi), each a predicate on a compile-time l.
template <int L, typename XV>
__device__ __forceinline__ void fold_row(double (&acc)[FOLD_C][L], const double* gr, int e,
                                         const XV& xv)
{
    if (L == 1 || (e & 63) == L) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const double gl = gr[l];
#pragma unroll
            for (int i = 0; i < FOLD_C; ++i) acc[i][l] = fma(xv(i), gl, acc[i][l]);
        }
    } else {
        const int lo = entry_lo(e), hi = entry_hi(e);
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const double gl = gr[l];
            if (l >= lo && l < hi) {
#pragma unroll
                for (int i = 0; i < FOLD_C; ++i) acc[i][l] = fma(xv(i), gl, acc[i][l]);
            }
        }
    }
}

// Block b: row b / tiles, cycles [q0, q0 + FOLD_C * threads) of it.  x's row
// r starts at x + r * ld; the span's sample n is the row's sample
// q0 * M + n - pad_front, read as +0.0 outside [0, keep); y is (rows, Q * L).
// PEAK: no y; the block's max |y| pattern goes to *peak.  A block whose span
// is silent (every sample +-0.0) folds nothing: each of its sums is +0.0,
// as the twin's is (+0.0 plus +-0.0 products stays +0.0).
//
// MS == 0, the generic form: the span split by M phases (sample n at
// (n % M) * P + n / M); thread t takes the cycles t + threads * i and loads
// its FOLD_C samples for every row of the table.
//
// MS == M, the slid form (every row present, w = 0 .. W - 1): the span split
// by S = FOLD_C * M phases (sample n at (n % S) * P + n / S); thread t takes
// the FOLD_C consecutive cycles FOLD_C * t + i.  Row w = k * M + r reads
// s_r(k + i), s_r(j) = x[(FOLD_C * t + j) * M + r]: row w + M needs the
// samples row w did, one cycle on, and one more.  So each residue r keeps a
// ring of FOLD_C samples in registers, already in float64, and a row loads
// and converts one sample: s_r(k + FOLD_C - 1) into slot (k - 1) % FOLD_C.
// s_r(j) lies at ((j % FOLD_C) * M + r) * P + j / FOLD_C + t, so a warp's
// loads are consecutive words, and the loop over k is unrolled by FOLD_C so
// that every slot is a compile-time index.
//
// Without PEAK the block writes its outputs through shared memory, a warp's
// stores consecutive words; with PEAK it reduces their patterns.
template <int L, int MS, bool PEAK>
__global__ void __launch_bounds__(FOLD_MAX_THREADS)
cycle_fold_kernel(const float* __restrict__ x, const double* __restrict__ g,
                  const int* __restrict__ rows, float* __restrict__ y,
                  unsigned* __restrict__ peak, long long ld, long long keep,
                  long long pad_front, long long Q, int M, int W, int n_rows, long long tiles)
{
    extern __shared__ double fold_sm[];
    __shared__ unsigned warp_max[FOLD_MAX_THREADS / 32];
    const int nt = blockDim.x;
    const int tq = FOLD_C * nt;
    const int span = (tq - 1) * M + W;
    const int S = MS ? FOLD_C * MS : M;
    const int P = (span + S - 1) / S;
    double* gs = fold_sm;                                        // n_rows x L
    int* tab = reinterpret_cast<int*>(gs + n_rows * L);           // n_rows
    float* xs = reinterpret_cast<float*>(tab + n_rows);           // S x P
    const long long row = blockIdx.x / tiles;
    const long long q0 = (blockIdx.x - row * tiles) * tq;
    const float* xr = x + row * ld;
    const long long s0 = q0 * M - pad_front;       // the row's sample at span word 0
    for (int i = threadIdx.x; i < n_rows * L; i += nt) gs[i] = g[i];
    for (int r = threadIdx.x; r < n_rows; r += nt) {
        const int e = rows[r];
        const int w = e >> 6;
        tab[r] = MS ? e : ((((w % M) * P + w / M) << 6) | (e & 63));
    }
    unsigned heard = 0u;
    for (int n = threadIdx.x; n < span; n += nt) {
        const long long src = s0 + n;
        const float v = src >= 0 && src < keep ? xr[src] : 0.0f;
        heard |= __float_as_uint(v) & 0x7fffffffu;
        xs[(n % S) * P + n / S] = v;
    }
    const bool silent = !__syncthreads_or(heard != 0u);

    const int t = threadIdx.x;
    double acc[FOLD_C][L];
#pragma unroll
    for (int i = 0; i < FOLD_C; ++i)
#pragma unroll
        for (int l = 0; l < L; ++l) acc[i][l] = 0.0;
    if (silent) {
        // every output +0.0, left in acc
    } else if constexpr (MS == 0) {
#pragma unroll 2
        for (int r = 0; r < n_rows; ++r) {
            const int e = tab[r];
            const float* xp = xs + entry_off(e) + t;
            double xv[FOLD_C];
#pragma unroll
            for (int i = 0; i < FOLD_C; ++i) xv[i] = static_cast<double>(xp[nt * i]);
            fold_row<L>(acc, gs + r * L, e, [&](int i) { return xv[i]; });
        }
    } else {
        // the rings, s_r(j) in slot j % FOLD_C: s_r(0 .. FOLD_C - 2) first;
        // s_r(j) for j = FOLD_C * jd + jm lies at (jm * MS + r) * P + jd + t
        double ring[MS][FOLD_C];
        const float* xt = xs + t;
#pragma unroll
        for (int r = 0; r < MS; ++r)
#pragma unroll
            for (int j = 0; j < FOLD_C - 1; ++j)
                ring[r][j] = static_cast<double>(xt[(j * MS + r) * P]);
        // rows w = k * MS + r for k = FOLD_C * kd + kk: the new sample is
        // s_r(k + FOLD_C - 1), jm = (kk + FOLD_C - 1) % FOLD_C, jd = kd + (kk > 0)
#pragma unroll 1
        for (int kd = 0; kd * FOLD_C * MS < W; ++kd) {
#pragma unroll
            for (int kk = 0; kk < FOLD_C; ++kk) {
#pragma unroll
                for (int r = 0; r < MS; ++r) {
                    const int w = (kd * FOLD_C + kk) * MS + r;
                    if (w < W) {          // the same for the whole block
                        const int jm = (kk + FOLD_C - 1) % FOLD_C;   // static once unrolled
                        ring[r][jm] = static_cast<double>(
                            xt[(jm * MS + r) * P + kd + (kk > 0 ? 1 : 0)]);
                        fold_row<L>(acc, gs + w * L, tab[w],
                                    [&](int i) { return ring[r][(kk + i) % FOLD_C]; });
                    }
                }
            }
        }
    }

    if constexpr (!PEAK) {
        // the block's outputs through shared memory, so that a warp's stores
        // are consecutive words (a slid thread's own are FOLD_C * L apart);
        // output j at ys[j + j / 32], which spreads a warp's words over the banks
        __syncthreads();
        float* ys = reinterpret_cast<float*>(fold_sm);
#pragma unroll
        for (int i = 0; i < FOLD_C; ++i) {
            const int c = MS ? FOLD_C * t + i : t + nt * i;
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const int j = c * L + l;
                ys[j + (j >> 5)] = __double2float_rn(acc[i][l]);
            }
        }
        __syncthreads();
        const long long left = (Q - q0) * L;
        const int n_out = left < (long long)tq * L ? (int)left : tq * L;
        float* yb = y + (row * Q + q0) * L;
        for (int j = t; j < n_out; j += nt) yb[j] = ys[j + (j >> 5)];
    } else {
        unsigned m = 0u;
#pragma unroll
        for (int i = 0; i < FOLD_C; ++i) {
            const long long q = q0 + (MS ? FOLD_C * t + i : t + nt * i);
            if (q < Q) {
#pragma unroll
                for (int l = 0; l < L; ++l)
                    m = max(m, __float_as_uint(__double2float_rn(acc[i][l])) & 0x7fffffffu);
            }
        }
        m = __reduce_max_sync(0xffffffffu, m);
        if ((t & 31) == 0) warp_max[t >> 5] = m;
        __syncthreads();
        if (t == 0) {
            for (int k = 1; k < nt / 32; ++k) m = max(m, warp_max[k]);
            atomicMax(peak, m);
        }
    }
}

// Shared memory of a block of `threads` in form ms: the bank's rows
// (float64), the table and the phase-split span, or the block's outputs if
// more (ops/cycle_fold.py fold_smem computes the same).
long long fold_smem(int L, int M, int W, int n_rows, int threads, int ms)
{
    const long long span = (long long)(FOLD_C * threads - 1) * M + W;
    const long long S = ms ? (long long)FOLD_C * ms : M;
    const long long P = (span + S - 1) / S;
    const long long outs = (long long)FOLD_C * threads * L;
    const long long folded = 8LL * n_rows * L + 4LL * n_rows + 4LL * S * P;
    const long long staged = 4LL * (outs + outs / 32);
    return folded > staged ? folded : staged;
}

template <int L, int MS, bool PEAK>
cudaError_t launch(const float* x, const double* g, const int* rows, float* y,
                   unsigned* peak, long long n_sig, long long ld, long long keep,
                   long long pad_front, long long Q, int M, int W, int n_rows, int threads,
                   int smem, cudaStream_t stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    const long long tiles = (Q + (long long)FOLD_C * threads - 1) / ((long long)FOLD_C * threads);
    const long long blocks = n_sig * tiles;
    if (blocks < 1 || blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    cudaError_t e = allow_smem((const void*)cycle_fold_kernel<L, MS, PEAK>, allowed, smem);
    if (e != cudaSuccess) return e;
    cycle_fold_kernel<L, MS, PEAK><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        x, g, rows, y, peak, ld, keep, pad_front, Q, M, W, n_rows, tiles);
    return cudaGetLastError();
}

// The instance of (L, ms): the slid form only where slide_ok, so that no
// instance is compiled that no bank can take.
template <int L, bool PEAK>
cudaError_t launch_ms(int ms, const float* x, const double* g, const int* rows, float* y,
                      unsigned* peak, long long n_sig, long long ld, long long keep,
                      long long pad_front, long long Q, int M, int W, int n_rows, int threads,
                      int smem, cudaStream_t s)
{
#define F9_FOLD_ARGS x, g, rows, y, peak, n_sig, ld, keep, pad_front, Q, M, W, n_rows, threads, \
                     smem, s
    switch (ms) {
    case 0: return launch<L, 0, PEAK>(F9_FOLD_ARGS);
    case 1: if constexpr (slide_ok(L, 1)) return launch<L, 1, PEAK>(F9_FOLD_ARGS); break;
    case 2: if constexpr (slide_ok(L, 2)) return launch<L, 2, PEAK>(F9_FOLD_ARGS); break;
    case 4: if constexpr (slide_ok(L, 4)) return launch<L, 4, PEAK>(F9_FOLD_ARGS); break;
    default: break;
    }
#undef F9_FOLD_ARGS
    return cudaErrorInvalidValue;
}

template <bool PEAK>
cudaError_t launch_l(int L, int ms, const float* x, const double* g, const int* rows, float* y,
                     unsigned* peak, long long n_sig, long long ld, long long keep,
                     long long pad_front, long long Q, int M, int W, int n_rows, int threads,
                     int smem, cudaStream_t s)
{
#define F9_FOLD_ARGS ms, x, g, rows, y, peak, n_sig, ld, keep, pad_front, Q, M, W, n_rows, \
                     threads, smem, s
    switch (L) {
    case 1: return launch_ms<1, PEAK>(F9_FOLD_ARGS);
    case 2: return launch_ms<2, PEAK>(F9_FOLD_ARGS);
    case 3: return launch_ms<3, PEAK>(F9_FOLD_ARGS);
    case 4: return launch_ms<4, PEAK>(F9_FOLD_ARGS);
    case 5: return launch_ms<5, PEAK>(F9_FOLD_ARGS);
    case 6: return launch_ms<6, PEAK>(F9_FOLD_ARGS);
    case 7: return launch_ms<7, PEAK>(F9_FOLD_ARGS);
    default: return cudaErrorInvalidValue;
    }
#undef F9_FOLD_ARGS
}

// The checks both entries share: the bank's geometry, the block and the
// form (`threads` 128, 64 or 32 and `ms` 0, generic, or M, slid: every row
// present, slide_ok, as ops/cycle_fold.py fold_threads and fold_form pick
// them), and the block's shared memory; 0 where they fail.
long long checked_smem(long long n_sig, long long Q, int L, int M, int W, int n_rows,
                       int threads, int ms)
{
    if (L < 1 || L > FOLD_MAX_L || M < 1 || W < 1 || W >= (1 << 25) || n_rows < 1
        || n_rows > W || (threads != 32 && threads != 64 && threads != 128) || Q < 1
        || n_sig < 1 || (ms != 0 && (ms != M || n_rows != W || !slide_ok(L, ms))))
        return 0;
    const long long smem = fold_smem(L, M, W, n_rows, threads, ms);
    return smem > SMEM_BLOCK_MAX ? 0 : smem;
}

}  // namespace

extern "C" {

// The cycles a thread takes, which ops/cycle_fold.py FOLD_CYCLES must equal.
int f9_cycle_fold_cycles() { return FOLD_C; }

// The presliced form: the fold of n_sig rows of x (row r at x + r * ld, T
// samples) by a dense bank of L < 8 phases and stride M, given as its n_rows
// non-zero rows of G (g, (n_rows, L) float64) and their table (rows,
// (n_rows,) int32: w << 6 | lo << 3 | hi, w ascending): Q cycles a row,
// T >= (Q - 1) * M + W.  With peak == NULL it writes y (n_sig, Q * L)
// float32; otherwise it writes no y and leaves in *peak the largest pattern
// of |y| (a float32's bits), after zeroing it on the stream.  Launches on
// `stream`; returns a CUDA error code (0 = launched).
int f9_cycle_fold(const float* x, const double* g, const int* rows, float* y, unsigned* peak,
                  long long n_sig, long long ld, long long T, long long Q, int L, int M, int W,
                  int n_rows, int threads, int ms, void* stream)
{
    const int form = ms;
    const long long smem = checked_smem(n_sig, Q, L, M, W, n_rows, threads, form);
    if (smem == 0 || T < (Q - 1) * M + W || ld < T) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (peak != nullptr) {
        cudaError_t e = cudaMemsetAsync(peak, 0, sizeof(unsigned), s);
        if (e != cudaSuccess) return (int)e;
        return (int)launch_l<true>(L, form, x, g, rows, nullptr, peak, n_sig, ld, T, 0, Q, M, W,
                                   n_rows, threads, (int)smem, s);
    }
    return (int)launch_l<false>(L, form, x, g, rows, y, nullptr, n_sig, ld, T, 0, Q, M, W,
                                n_rows, threads, (int)smem, s);
}

// The flat form: the same fold of n_sig unpadded rows of x (row r at x + r *
// ld, its first `keep` samples read, ld >= keep), the signal behind
// `pad_front` zeros and followed by zeros to the span of Q cycles: y
// (n_sig, Q * L) float32, each output bit for bit the presliced form's on
// F.pad(x[..., :keep], (pad_front, (Q - 1) * M + W - pad_front - keep)).
// Launches on `stream`; returns a CUDA error code (0 = launched).
int f9_cycle_fold_flat(const float* x, const double* g, const int* rows, float* y,
                       long long n_sig, long long ld, long long keep, long long pad_front,
                       long long Q, int L, int M, int W, int n_rows, int threads, int ms,
                       void* stream)
{
    const int form = ms;
    const long long smem = checked_smem(n_sig, Q, L, M, W, n_rows, threads, form);
    if (smem == 0 || keep < 0 || pad_front < 0 || pad_front + keep > (Q - 1) * M + W
        || (n_sig > 1 && ld < keep))
        return (int)cudaErrorInvalidValue;
    return (int)launch_l<false>(L, form, x, g, rows, y, nullptr, n_sig, ld, keep, pad_front, Q,
                                M, W, n_rows, threads, (int)smem, (cudaStream_t)stream);
}

}  // extern "C"
