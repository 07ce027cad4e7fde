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
// float32 cycle matrix.  That is a GEMM whose A operand is the overlapping
// strided view A[q, w] = xpad[q*M + w]: the TPU retiles the flat signal into
// (rows, M) in HBM and adds R shifted products; here each block reads one
// contiguous span of the flat signal and addresses A inside it.
//
// What bounds it on this card.  Per output the function needs 2*K flops on
// the band's non-zero taps (256 for the default 44.1k->48k high bank) against
// 8 bytes of signal and output traffic.  On the CUDA cores that is bound by
// arithmetic (0.14 ms of fp32 FFMA for 32 x 2^20 frames at 67 TFLOP/s), and
// an FFMA kernel with compensated sums issues ~236 fp32 instructions per
// output and cannot come near it.  On the tensor cores even the three TF32
// passes below (0.057 ms at 495 TFLOP/s) take less than moving the bytes
// once (0.084 ms at 3.35 TB/s), so the floor is memory.  Plain TF32 keeps 11
// significant bits and misses the -120 dB gate by 60 dB.  Measured with
// parts cut out (f9tpu_torch/tools/cycle_src_ablation.py, PERF.md): one mma pass instead
// of three leaves 81 % of the time, no compensation 85 %, math without loads
// 86 %, loads without math 59 %; no single part frees more than a fifth.
// That instruction issue around mma.sync holds it (per warp and 8-row step:
// 15 mma, 60 FADDs of compensation, the A split and 9 shared loads) is a
// hypothesis: no stall profile has been taken (PERF.md, open questions).
// What the design does:
//   * Split TF32 ("3xTF32") on the tensor cores.  x and G are each split into
//     a TF32 high part and a TF32 low part, rounded to nearest, ties away, as
//     cvt.rna does (the wrapper splits G once per bank, the kernel splits x
//     as it builds each A fragment), and each 8-row step of the contraction
//     is one fresh mma.sync m16n8k8 fragment that takes xh*gl + xl*gh, then
//     xh*gh.  The dropped xl*gl term is ~2^-22 of a product.
//   * Compensated partials.  Each fresh k8 fragment starts from the bits
//     the running sum has lost so far (Kahan's negated compensation) and
//     joins the sum by Fast2Sum (3 FADDs per output per 8 rows, against ~12
//     FFMAs and FADDs on the CUDA cores), so rounding does not grow with the
//     ~150-600 rows summed: ~0.18 LSB RMS at 24 bits on a -12 dBFS signal
//     against the exact sum, within an output rounding or two of the float64
//     plain twin.
//   * One contiguous x span per block, loaded once.  A block owns 16*warps
//     cycles and 8*NT output phases; its span xpad[q0*M + w_lo, ...) serves
//     every row of the contraction.  It comes in by 16-byte cp.async from the
//     aligned superset (the signal's edges and the zero padding by scalar
//     stores).  A fragments are gathered from it by address arithmetic (M*4
//     bytes is rarely 16-byte aligned, so neither TMA nor wgmma's
//     shared-memory layouts can tile A); the wrapper picks a row order and a
//     skew (4 pad floats per 32) that keep those loads free of bank
//     conflicts.
//   * G streamed through a 4-stage cp.async ring of 16-row chunks, hi and lo
//     packed by the wrapper in fragment order (one 16-byte load per lane per
//     n-tile, conflict-free, hi and lo pairs in adjacent registers),
//     overlapped with the math.
//   * Band skip.  G is a staircase band: a column tile contracts only over
//     the rows [w_lo, w_lo + 8*nk) outside which its columns are zero.  The
//     wrapper picks the tile width (NT n-tiles of 8) so little of the last
//     tile idles (L = 40 is one tile of 40).
//   * The outputs leave through shared memory as row segments of
//     consecutive floats (whole sectors), not as fragment-scattered stores.
//   * Two blocks of 8 warps per SM for the usual banks (~95-113 KB of shared
//     memory each).

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int MAX_NT = 5;      // 8-column n-tiles per block, 1..MAX_NT
constexpr int KC8 = 2;         // k8 steps per ring stage (16 contraction rows)
constexpr int STAGES = 4;      // ring depth
constexpr int MAX_WARPS = 8;   // each warp owns one 16-cycle m-tile
constexpr int THREADS_MAX = MAX_WARPS * 32;

// v rounded to TF32 (10 stored mantissa bits), to nearest with ties away
// from zero, as cvt.rna.tf32.f32 rounds finite values, in two integer ops
__device__ __forceinline__ uint32_t tf32_rna(float v)
{
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d += a * b
__device__ __forceinline__ void mma_acc(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src)
{
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

// Block-local cycle (row) of fragment row h*8 + g in `warp`: rowmap 0 keeps
// a warp's 16 cycles in order; rowmap 1 interleaves the 32 cycles of a warp
// pair so the 8 cycles one load touches are 4 apart (conflict-free for odd M).
__device__ __forceinline__ int cycle_of(int rowmap, int warp, int h, int g)
{
    return rowmap ? (warp >> 1) * 32 + 4 * g + 2 * h + (warp & 1) : warp * 16 + h * 8 + g;
}

// tiles[3*c + {0,1,2}] = (w_lo, nk, offset of the tile's packed G in float4s)
// for column tile c; packed G: per k8 step s, per n-tile n, per lane (g, t)
// the float4 {hi of G[w, l], hi of G[w + 4, l], lo of G[w, l], lo of
// G[w + 4, l]}, w = w_lo + 8s + t, l = c*8*NT + 8n + g.  Dynamic shared
// memory: the span (skewed; at the end the output tile, pitch 8*NT + 1;
// ring_off floats), then the ring.
template <int NT>
__global__ void __launch_bounds__(THREADS_MAX, 2)
cycle_src_tc(const float* __restrict__ x, const float4* __restrict__ gp,
             const int* __restrict__ tiles, float* __restrict__ y,
             long long T, long long x_stride, int pad_front, int M, int L, int Q,
             long long out_len, long long out_stride, int skew, int rowmap,
             int ring_off)
{
    extern __shared__ __align__(16) float smem[];
    constexpr int STAGE_F4 = KC8 * NT * 32;
    float* span = smem;
    float4* ring = reinterpret_cast<float4*>(smem + ring_off);

    const int nthreads = blockDim.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int TQ = (nthreads >> 5) * 16;
    const int q0 = blockIdx.x * TQ;
    const int ct = blockIdx.y;
    const int b = blockIdx.z;
    const int w_lo = tiles[3 * ct];
    const int nk = tiles[3 * ct + 1];
    const float4* gt = gp + tiles[3 * ct + 2];
    const int l0 = ct * 8 * NT;
    const int nch = nk / KC8;

    // ---- the span xpad[q0*M + w_lo, q0*M + w_lo + span_len), as logical
    // floats j from the 16-byte-aligned signal index t_al = t_begin - shift;
    // cycle rho's contraction rows start at j = shift + rho*M
    const float* xb = x + (long long)b * x_stride;
    const int span_len = (TQ - 1) * M + nk * 8;
    const long long t_begin = (long long)q0 * M + w_lo - pad_front;
    const int shift = (int)((((uintptr_t)xb >> 2) + (uintptr_t)t_begin) & 3);
    const long long t_al = t_begin - shift;
    const int n4 = (shift + span_len + 3) >> 2;
    for (int k = tid; k < n4; k += nthreads) {
        const long long ts = t_al + 4LL * k;
        const int j = 4 * k;
        float* dst = span + j + skew * (j >> 5);
        if (ts >= 0 && ts + 4 <= T) {
            cp_async16(dst, xb + ts);
        } else {
            float4 v;
            v.x = (ts >= 0 && ts < T) ? xb[ts] : 0.f;
            v.y = (ts + 1 >= 0 && ts + 1 < T) ? xb[ts + 1] : 0.f;
            v.z = (ts + 2 >= 0 && ts + 2 < T) ? xb[ts + 2] : 0.f;
            v.w = (ts + 3 >= 0 && ts + 3 < T) ? xb[ts + 3] : 0.f;
            *reinterpret_cast<float4*>(dst) = v;
        }
    }

    auto load_stage = [&](int c) {
        const float4* src = gt + (long long)c * STAGE_F4;
        float4* dst = ring + (c % STAGES) * STAGE_F4;
        for (int i = tid; i < STAGE_F4; i += nthreads) cp_async16(dst + i, src + i);
    };
    // group 0 = the span + stage 0; groups 1..STAGES-2 = the next stages
#pragma unroll
    for (int c = 0; c < STAGES - 1; ++c) {
        if (c < nch) load_stage(c);
        cp_async_commit();
    }

    // logical span index of this thread's A elements at k8 step 0:
    // abase[h] -> (cycle of fragment row h*8 + g, contraction row t)
    int abase[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) abase[h] = shift + cycle_of(rowmap, warp, h, g) * M + t;

    // running sums and the bits each has lost (Kahan's negated compensation)
    float sum[NT][4], nc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) sum[n][r] = nc[n][r] = 0.f;

    for (int c = 0; c < nch; ++c) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();        // stage c (and the span) landed; stage c-1 is free
        if (c + STAGES - 1 < nch) load_stage(c + STAGES - 1);
        cp_async_commit();
        const float4* st = ring + (c % STAGES) * STAGE_F4;
#pragma unroll
        for (int kk = 0; kk < KC8; ++kk) {
            const int s8 = (c * KC8 + kk) * 8;
            // the A fragment, split: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
            uint32_t ah[4], al[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int j = abase[r & 1] + s8 + ((r >> 1) << 2);
                const float v = span[j + skew * (j >> 5)];
                const uint32_t hi = tf32_rna(v);
                ah[r] = hi;
                al[r] = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
            }
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                // B fragment {b0 hi, b1 hi, b0 lo, b1 lo}
                const float4 bv = st[(kk * NT + n) * 32 + lane];
                const uint32_t b0h = __float_as_uint(bv.x), b1h = __float_as_uint(bv.y);
                const uint32_t b0l = __float_as_uint(bv.z), b1l = __float_as_uint(bv.w);
                // a fresh fragment that starts from the negated compensation
                // (the bits the sum lost so far), accumulated in its place
                mma_acc(nc[n], ah, b0l, b1l);   // + xh * gl
                mma_acc(nc[n], al, b0h, b1h);   // + xl * gh
                mma_acc(nc[n], ah, b0h, b1h);   // + xh * gh
#pragma unroll
                for (int r = 0; r < 4; ++r) {   // Fast2Sum join: sum + d exactly
                    const float d = nc[n][r];
                    const float tk = __fadd_rn(sum[n][r], d);
                    nc[n][r] = __fsub_rn(d, __fsub_rn(tk, sum[n][r]));
                    sum[n][r] = tk;
                }
            }
        }
    }
    // ---- the block's (TQ, 8*NT) outputs through shared memory (the span is
    // read no more), then out in row segments of consecutive floats
    cp_async_wait<0>();
    __syncthreads();
    constexpr int OP = 8 * NT + 1;      // odd pitch: few bank conflicts
    float* ot = smem;
    // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int rho = cycle_of(rowmap, warp, r >> 1, g);
#pragma unroll
        for (int n = 0; n < NT; ++n)
            ot[rho * OP + n * 8 + 2 * t + (r & 1)] = __fadd_rn(sum[n][r], nc[n][r]);
    }
    __syncthreads();
    float* yb = y + (long long)b * out_stride;
    for (int i = tid; i < TQ * 8 * NT; i += nthreads) {
        const int rho = i / (8 * NT);
        const int cl = i - rho * (8 * NT);
        const int q = q0 + rho, l = l0 + cl;
        const long long ty = (long long)q * L + l;
        if (q < Q && l < L && ty < out_len) yb[ty] = ot[rho * OP + cl];
    }
}

constexpr int MAX_DEVICES = 64;

// Raise the kernel's dynamic shared-memory limit on the current device to
// `bytes` if it is lower (never lower it: an earlier, larger launch may
// still rely on it).  The attribute is per device; one lock per template
// keeps host threads from racing on what was raised.
template <int NT>
cudaError_t allow_smem(int bytes)
{
    static std::mutex mu;
    static int allowed[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    const std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
        e = cudaFuncSetAttribute(cycle_src_tc<NT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        allowed[dev] = bytes;
    }
    return cudaSuccess;
}

template <int NT>
int launch(const float* x, const float4* gp, const int* tiles, float* y, dim3 grid,
           int threads, int smem_bytes, cudaStream_t stream, long long T,
           long long x_stride, int pad_front, int M, int L, int Q, long long out_len,
           long long out_stride, int skew, int rowmap, int ring_off)
{
    const cudaError_t e = allow_smem<NT>(smem_bytes);
    if (e != cudaSuccess) return (int)e;
    cycle_src_tc<NT><<<grid, threads, smem_bytes, stream>>>(
        x, gp, tiles, y, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew,
        rowmap, ring_off);
    return (int)cudaGetLastError();
}

template <int NT>
cudaError_t occupancy(int* n, int warps, int smem_bytes)
{
    const cudaError_t e = allow_smem<NT>(smem_bytes);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, cycle_src_tc<NT>, 32 * warps,
                                                         smem_bytes);
}

}  // namespace

extern "C" {

// Resident blocks per SM for a launch of `warps` warps and `smem_bytes` of
// dynamic shared memory at n-tile count nt (after the attributes the launch
// sets), or a negative CUDA error code.
int f9_cycle_src_blocks_per_sm(int nt, int warps, int smem_bytes)
{
    int n = 0;
    cudaError_t e = cudaSuccess;
    switch (nt) {
    case 1: e = occupancy<1>(&n, warps, smem_bytes); break;
    case 2: e = occupancy<2>(&n, warps, smem_bytes); break;
    case 3: e = occupancy<3>(&n, warps, smem_bytes); break;
    case 4: e = occupancy<4>(&n, warps, smem_bytes); break;
    default: e = occupancy<5>(&n, warps, smem_bytes); break;
    }
    return e == cudaSuccess ? n : -(int)e;
}

// The compile-time geometry the wrapper packs G and sizes shared memory for:
// 10*KC8 + 100*STAGES + 1000*MAX_NT + 10000*MAX_WARPS.
int f9_cycle_src_geometry(void)
{
    return 10 * KC8 + 100 * STAGES + 1000 * MAX_NT + 10000 * MAX_WARPS;
}

// Launch on `stream`; returns a CUDA error code (0 = launched).
// x: (bc, x_stride) float32 with T valid samples per row; gp: the packed
// split bank; tiles: (n_tiles, 3) int32; y: (bc, out_stride) float32, of
// which samples [0, out_len) are written.  nt: n-tiles per column tile;
// warps: 1, 2, 4 or 8 (16 cycles each); skew, rowmap, ring_off: the span's
// layout; smem_bytes: ring_off*4 + the ring.
int f9_cycle_src(const float* x, const void* gp, const int* tiles, float* y,
                 int bc, long long T, long long x_stride, int pad_front, int M,
                 int L, int Q, long long out_len, long long out_stride, int nt,
                 int n_tiles, int warps, int skew, int rowmap, int ring_off,
                 int smem_bytes, void* stream)
{
    if (bc <= 0 || bc > 65535 || Q <= 0 || L <= 0 || M <= 0 || T < 0
        || out_len > (long long)Q * L || out_stride < out_len
        || nt < 1 || nt > MAX_NT || n_tiles != (L + 8 * nt - 1) / (8 * nt)
        || warps < 1 || warps > MAX_WARPS || (warps & (warps - 1)) || (rowmap && warps < 2)
        || skew < 0 || skew % 4
        || ring_off % 4 || smem_bytes > 232448 || (((uintptr_t)gp) & 15))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((Q + 16 * warps - 1) / (16 * warps)), (unsigned)n_tiles,
                    (unsigned)bc);
    const float4* g4 = static_cast<const float4*>(gp);
    cudaStream_t s = (cudaStream_t)stream;
    const int th = 32 * warps;
    switch (nt) {
    case 1: return launch<1>(x, g4, tiles, y, grid, th, smem_bytes, s, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew, rowmap, ring_off);
    case 2: return launch<2>(x, g4, tiles, y, grid, th, smem_bytes, s, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew, rowmap, ring_off);
    case 3: return launch<3>(x, g4, tiles, y, grid, th, smem_bytes, s, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew, rowmap, ring_off);
    case 4: return launch<4>(x, g4, tiles, y, grid, th, smem_bytes, s, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew, rowmap, ring_off);
    default: return launch<5>(x, g4, tiles, y, grid, th, smem_bytes, s, T, x_stride, pad_front, M, L, Q, out_len, out_stride, skew, rowmap, ring_off);
    }
}

}  // extern "C"
