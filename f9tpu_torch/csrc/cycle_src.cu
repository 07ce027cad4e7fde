// Polyphase cycle-matrix sample-rate conversion on Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of f9tpu/ops/pallas_src.py:
//   _kernel_roll (l.189)  the R = 1 tile: x @ G[0:M] + roll(x @ G[M:2M], -1 row)
//   _kernel      (l.141)  the R > 1 tile: sum_r span[r:r+tq] @ G[rM:(r+1)M]
// with one kernel for every overlap R.  Both compute, for each signal b,
// cycle q and output phase l,
//
//     y[b, q*L + l] = sum_{w < W} xpad[b, q*M + w] * G[w, l]
//
// where xpad is the signal behind pad_front zeros and G is the bank's (W, L)
// float32 cycle matrix, W <= (R+1)*M (the Pallas form's extra zero rows
// contribute nothing and are not read).  That is a GEMM whose A operand is the
// overlapping strided view A[q, w] = xpad[q*M + w]: the TPU retiles the flat
// signal into (rows, M) in HBM and adds R shifted products; here each block
// reads the flat signal straight from device memory with offsets computed
// from blockIdx, and masks the zero padding and the ragged edges itself.
//
// What bounds it on the card: per output sample it does 2*W flops (548 for
// the default 44.1k->48k high bank, 2*(R+1)*M = 588 in the Pallas form)
// against 8 bytes of signal traffic (one float in, one out), so it is bound
// by fp32 instruction issue, not by memory.  Everything runs on the CUDA
// cores in fp32: TF32 tensor cores keep ~10 mantissa bits and would miss the
// -120 dB gate against the float64 oracle.  Three design points:
//   * G is a staircase band: column l is non-zero only on K rows starting at
//     off[l].  The wrapper passes, per TILE_L-column tile, the row range
//     [w_lo, w_hi) outside which the tile's columns are all zero, and the
//     block contracts over that range only (156 of 274 rows on average for
//     the default bank, with 32-column tiles).
//   * Compensated accumulation.  A plain running fp32 sum of ~150 products
//     rounds at the output's magnitude every step: ~0.4 LSB RMS of error at
//     24 bits on a -12 dBFS signal, enough for two fp32 forms summing in
//     different orders to disagree by 4 codes over a few million samples.
//     Here each KAHAN_W-row slice is summed by FFMA into a fresh partial,
//     and partials join the total by Kahan summation (4 FADDs per partial),
//     which leaves ~0.1 LSB RMS: the kernel then agrees with the float64
//     plain twin to within an output rounding or two.
//   * A register micro-tile of MICRO_Q x MICRO_L outputs per thread: each
//     shared-memory value read feeds 4 or 8 FFMAs.
// Shared memory per block is ~10.5 KB whatever the bank (the contraction is
// chunked by TILE_W rows), so banks whose G exceeds the 227 KB a block may
// hold (282 KB for 44.1k->48k ultra) need no special path.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_Q = 128;   // cycles (output rows) per block
constexpr int TILE_L = 32;    // output phases (columns) per block
constexpr int TILE_W = 16;    // contraction rows staged per step
constexpr int KAHAN_W = 8;    // rows summed into one partial before a Kahan add
constexpr int MICRO_Q = 8;    // rows per thread
constexpr int MICRO_L = 4;    // columns per thread
constexpr int THREADS = (TILE_Q / MICRO_Q) * (TILE_L / MICRO_L);   // 128
constexpr int XS_PITCH = TILE_Q + 4;   // keeps float4 rows 16-byte aligned
static_assert(TILE_W % KAHAN_W == 0, "partials must tile the staged rows");

__global__ void __launch_bounds__(THREADS)
cycle_src_kernel(const float* __restrict__ x, const float* __restrict__ g,
                 const int* __restrict__ band, float* __restrict__ y,
                 long long T, long long x_stride, int pad_front, int M, int L,
                 int Q, long long out_len, long long out_stride)
{
    __shared__ __align__(16) float xs[TILE_W][XS_PITCH];   // xs[w][q]
    __shared__ __align__(16) float gs[TILE_W][TILE_L];     // gs[w][l]

    const int q0 = blockIdx.x * TILE_Q;
    const int lt = blockIdx.y;
    const int l0 = lt * TILE_L;
    const int b = blockIdx.z;
    const int w_lo = band[2 * lt];
    const int w_hi = band[2 * lt + 1];
    const float* xb = x + (long long)b * x_stride;

    const int tid = threadIdx.x;
    const int tl = tid % (TILE_L / MICRO_L);
    const int tq = tid / (TILE_L / MICRO_L);

    float sum[MICRO_Q][MICRO_L];
    float comp[MICRO_Q][MICRO_L];   // Kahan compensation (negated lost bits)
#pragma unroll
    for (int i = 0; i < MICRO_Q; ++i)
#pragma unroll
        for (int j = 0; j < MICRO_L; ++j) sum[i][j] = comp[i][j] = 0.f;

    for (int w0 = w_lo; w0 < w_hi; w0 += TILE_W) {
        // x chunk: (q, w) <- xpad[(q0 + q)*M + w0 + w]; consecutive threads
        // read consecutive samples of one cycle row.
        for (int i = tid; i < TILE_Q * TILE_W; i += THREADS) {
            const int qq = i / TILE_W;
            const int ww = i % TILE_W;
            const long long t =
                (long long)(q0 + qq) * M + (w0 + ww) - pad_front;
            float v = 0.f;
            if (w0 + ww < w_hi && q0 + qq < Q && t >= 0 && t < T) v = xb[t];
            xs[ww][qq] = v;
        }
        for (int i = tid; i < TILE_W * TILE_L; i += THREADS) {
            const int ww = i / TILE_L;
            const int ll = i % TILE_L;
            const int w = w0 + ww;
            const int l = l0 + ll;
            gs[ww][ll] = (w < w_hi && l < L) ? g[(long long)w * L + l] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < TILE_W; h += KAHAN_W) {
            float part[MICRO_Q][MICRO_L];
#pragma unroll
            for (int i = 0; i < MICRO_Q; ++i)
#pragma unroll
                for (int j = 0; j < MICRO_L; ++j) part[i][j] = 0.f;
#pragma unroll
            for (int k = h; k < h + KAHAN_W; ++k) {
                float a[MICRO_Q];
                float c[MICRO_L];
                const float4 a0 = *reinterpret_cast<const float4*>(&xs[k][tq * MICRO_Q]);
                const float4 a1 = *reinterpret_cast<const float4*>(&xs[k][tq * MICRO_Q + 4]);
                const float4 c0 = *reinterpret_cast<const float4*>(&gs[k][tl * MICRO_L]);
                a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
                a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
                c[0] = c0.x; c[1] = c0.y; c[2] = c0.z; c[3] = c0.w;
#pragma unroll
                for (int i = 0; i < MICRO_Q; ++i)
#pragma unroll
                    for (int j = 0; j < MICRO_L; ++j)
                        part[i][j] = fmaf(a[i], c[j], part[i][j]);
            }
#pragma unroll
            for (int i = 0; i < MICRO_Q; ++i)
#pragma unroll
                for (int j = 0; j < MICRO_L; ++j) {
                    const float yk = part[i][j] - comp[i][j];
                    const float tk = sum[i][j] + yk;
                    comp[i][j] = (tk - sum[i][j]) - yk;
                    sum[i][j] = tk;
                }
        }
        __syncthreads();
    }

    float* yb = y + (long long)b * out_stride;
#pragma unroll
    for (int i = 0; i < MICRO_Q; ++i) {
        const int q = q0 + tq * MICRO_Q + i;
        if (q >= Q) break;
#pragma unroll
        for (int j = 0; j < MICRO_L; ++j) {
            const int l = l0 + tl * MICRO_L + j;
            const long long t = (long long)q * L + l;
            if (l < L && t < out_len) yb[t] = sum[i][j] - comp[i][j];
        }
    }
}

}  // namespace

extern "C" {

// Column-tile width the wrapper must size the band table with.
int f9_cycle_src_tile_l(void) { return TILE_L; }

// Launch on `stream`; returns cudaGetLastError() right after the launch
// (0 = launched).  x: (bc, x_stride) float32 with T valid samples per row;
// g: (W, L) float32; band: (ceil(L / TILE_L), 2) int32 row ranges;
// y: (bc, out_stride) float32, of which samples [0, out_len) are written.
int f9_cycle_src(const float* x, const float* g, const int* band, float* y,
                 int bc, long long T, long long x_stride, int pad_front,
                 int M, int L, int Q, long long out_len, long long out_stride,
                 void* stream)
{
    if (bc <= 0 || bc > 65535 || Q <= 0 || L <= 0 || M <= 0 || T < 0
        || out_len > (long long)Q * L || out_stride < out_len)
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((Q + TILE_Q - 1) / TILE_Q),
                    (unsigned)((L + TILE_L - 1) / TILE_L), (unsigned)bc);
    cycle_src_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, g, band, y, T, x_stride, pad_front, M, L, Q, out_len, out_stride);
    return (int)cudaGetLastError();
}

}  // extern "C"
