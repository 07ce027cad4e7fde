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
//
// The windowed form (cycle_src_win) serves varispeed banks, which have no
// dense G: 44.1k -> 44056 reduces to L/M = 11014/11025, so 16 cycles of
// contiguous span would be 705 KB, while a column tile of 40 phases reads
// only a window of ~170-300 floats of each cycle.  The TPU gets this form
// from XLA as one matmul per 128-output segment (f9tpu/ops/resample.py:202).
// Rows are (signal, cycle) pairs of the whole launch, signal-major, so no
// block idles at a signal's end; the input is the flat signal, read at
// cycle stride M.  Its floor
// is memory as well (signal, output and the phase bank once: 0.082 ms for
// 32 x 2^20 frames of 44.1k -> 44056 high).  What held its first design
// (one window per row and tile, by 4-byte cp.async, then the math) at
// 0.73-0.79 ms was the staging: ~4.4 floats staged per signal float, 149 M
// copy instructions, and no math while a block staged.  What this design
// does:
//   * Tile groups.  A block owns `group` neighbouring column tiles and
//     stages each row's union window once; each tile reads its A fragments
//     at its band's offset inside it.  Each output keeps its own band, k8
//     steps, TF32 split and Fast2Sum join, so the bytes equal the first
//     form's (chip_smoke.py pins them).
//   * Bulk copies.  A producer warp brings each window in as its 16-byte-
//     aligned superset by one TMA 1-D bulk copy (completion counted in
//     bytes on an mbarrier); rows that meet an edge (before 0, past T, past
//     the launch's last row) are filled by the warp with plain loads and
//     zeros.  The per-row shift of 0-3 floats joins the A address.
//   * Conflict-free A loads with the shift: slot warp*16 + h*8 + g holds
//     row cycle_of(1, warp, h, g), so the 8 rows of one load are 4 cycles
//     apart, share their shift, and a pitch of 4 mod 32 floats puts them in
//     32 banks (counted by src_kernel._win_a_load_wavefronts).
//   * The band through the same 4-stage ring as the dense form, one
//     continuous stream over the block's tiles, started while the producer
//     stages; outputs leave straight from the C fragments, two adjacent
//     floats per 8-byte store.
//   * Sizes from a sweep on the card (PERF.md): 4 consumer warps and the
//     largest group whose windows leave room for two blocks per SM; blocks
//     per SM counted most.  A second window buffer (the producer filling
//     the next rows while the consumers compute), more rows per block (each
//     tile's band read once per 128-512 rows) or 8 warps all cost a block
//     per SM and were slower, so a block stages its rows once.  A launch of
//     few rows takes a smaller group (src_kernel._win_launch) so its grid
//     still fills the card; no output's order depends on the group.

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

__device__ __forceinline__ void cp_async4(void* smem_dst, const void* gmem_src)
{
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(gmem_src));
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
    {
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
    for (int h = 0; h < 2; ++h)
        abase[h] = shift + cycle_of(rowmap, warp, h, g) * M + t;

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

// ---- the windowed form ------------------------------------------------

// smem_u32, mbar_*, bulk_g2s
#include "tma.cuh"

// the consumer warps' barrier (named barrier 1; the producer warp never joins)
__device__ __forceinline__ void consumer_sync(int nthreads)
{
    asm volatile("bar.sync 1, %0;\n" :: "r"(nthreads) : "memory");
}

// Where row r's union window comes from: the 16-byte-aligned superset of
// xpad[q*stride + u_lo, + U) of signal r / Q, `shift` floats (0-3) ahead of
// the window, n4 float4s long; `bulk` when all of it lies inside [0, T) (a
// row past the launch's last, or one that meets an edge, is filled by plain
// loads and zeros).
struct RowSrc {
    const float* src;
    long long ts;       // signal index of the superset's first float
    int shift, n4;
    bool live, bulk;
};

__device__ __forceinline__ RowSrc row_src(const float* x, long long x_stride, long long T,
                                          int pad_front, int stride, int Q, int n_rows,
                                          int r, int u_lo, int U)
{
    RowSrc s;
    s.live = r < n_rows;
    if (!s.live) {
        s.src = x; s.ts = 0; s.shift = 0; s.n4 = (U + 3) >> 2; s.bulk = false;
        return s;
    }
    const int rb = r / Q, rq = r - rb * Q;
    s.src = x + (long long)rb * x_stride;
    const long long t0 = (long long)rq * stride + u_lo - pad_front;
    s.shift = (int)((((uintptr_t)s.src >> 2) + (uintptr_t)t0) & 3);
    s.ts = t0 - s.shift;
    s.n4 = (s.shift + U + 3) >> 2;
    s.bulk = s.ts >= 0 && s.ts + 4LL * s.n4 <= T;
    return s;
}

// The windowed form.  Grid (row blocks, tile groups); a block owns `group`
// neighbouring column tiles and 16*W rows (W consumer warps, one producer
// warp: blockDim = 32*(W + 1)).  Row r of the launch's n_rows = signals * Q
// is cycle r % Q of signal r / Q.  Dynamic shared memory: the barrier (16
// bytes), 16*W window slots of `pitch` floats, the ring.  Slot warp*16 +
// h*8 + g holds the union window of block-local row cycle_of(rowmap, warp,
// h, g): with rowmap 1 the 8 rows of one A load are 4 cycles apart and share
// their shift, so a pitch of 4 mod 32 keeps the load in 32 banks.
template <int NT>
__global__ void __launch_bounds__(THREADS_MAX + 32, 1)
cycle_src_win(const float* __restrict__ x, const float4* __restrict__ gp,
              const int* __restrict__ tiles, float* __restrict__ y,
              long long T, long long x_stride, int pad_front, int stride, int L, int Q,
              long long out_len, long long out_stride, int pitch, int n_rows,
              int n_tiles, int group, int rowmap)
{
    extern __shared__ __align__(16) float smem[];
    constexpr int STAGE_F4 = KC8 * NT * 32;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* win = smem + 4;
    const int W = (blockDim.x >> 5) - 1;
    const int ROWS = 16 * W;
    float4* ring = reinterpret_cast<float4*>(win + ROWS * pitch);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int ct0 = blockIdx.y * group;
    const int ng = min(group, n_tiles - ct0);
    const int row0 = blockIdx.x * ROWS;
    // the group's union window [u_lo, u_lo + U): off never falls, so the
    // first tile's band starts it
    const int u_lo = tiles[3 * ct0];
    int u_hi = 0;
    for (int c = 0; c < ng; ++c)
        u_hi = max(u_hi, tiles[3 * (ct0 + c)] + 8 * tiles[3 * (ct0 + c) + 1]);
    const int U = u_hi - u_lo;

    if (tid == 0) {
        mbar_init(full, 33);        // 32 producer lanes + the byte count
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == W) {
        // ---- producer: the block's windows (one bulk copy per row; rows
        // that meet an edge by plain loads, the warp across the row) while
        // the consumers start the band's ring
        // lane l takes slots l, l + 32, ... (at most 4)
        RowSrc rs[MAX_WARPS / 2];
        uint32_t mine = 0, edge = 0;
#pragma unroll
        for (int i = 0; i < MAX_WARPS / 2; ++i) {
            const int s = lane + 32 * i;
            if (s >= ROWS) break;
            rs[i] = row_src(x, x_stride, T, pad_front, stride, Q, n_rows,
                            row0 + cycle_of(rowmap, s >> 4, (s >> 3) & 1, s & 7), u_lo, U);
            if (rs[i].bulk) mine += 16u * rs[i].n4;
            else edge |= 1u << i;
        }
        const uint32_t total = __reduce_add_sync(0xffffffffu, mine);
        if (lane == 0) mbar_arrive_expect_tx(full, total);
        __syncwarp();
#pragma unroll
        for (int i = 0; i < MAX_WARPS / 2; ++i) {
            const int s = lane + 32 * i;
            if (s < ROWS && rs[i].bulk)
                bulk_g2s(win + s * pitch, rs[i].src + rs[i].ts, 16u * rs[i].n4, full);
        }
        for (int i = 0; i < MAX_WARPS / 2 && 32 * i < ROWS; ++i) {
            uint32_t todo = __ballot_sync(0xffffffffu, (edge >> i) & 1u);
            while (todo) {
                const int src_lane = __ffs(todo) - 1;
                todo &= todo - 1;
                const int s = src_lane + 32 * i;
                const RowSrc e = row_src(x, x_stride, T, pad_front, stride, Q, n_rows,
                                         row0 + cycle_of(rowmap, s >> 4, (s >> 3) & 1, s & 7),
                                         u_lo, U);
                float* dst = win + s * pitch;
                for (int j = lane; j < 4 * e.n4; j += 32) {
                    const long long ts = e.ts + j;
                    dst[j] = (e.live && ts >= 0 && ts < T) ? e.src[ts] : 0.f;
                }
            }
        }
        mbar_arrive(full);
        return;
    }

    // ---- consumers: per tile of the group, the tile's band through the
    // ring (one continuous stream over the group's tiles)
    const int nthreads = 32 * W;
    const int g = lane >> 2, t = lane & 3;
    int n_total = 0;
    for (int c = 0; c < ng; ++c) n_total += tiles[3 * (ct0 + c) + 1] / KC8;

    // the ring's load cursor: stages are loaded in the order they are used
    // (tile of the group, chunk of the tile's band)
    int lc = 0, lk = 0;
    const float4* lsrc = gp + tiles[3 * ct0 + 2];
    int lnch = tiles[3 * ct0 + 1] / KC8;
    auto load_stage = [&](int f) {
        float4* dst = ring + (f % STAGES) * STAGE_F4;
        const float4* src = lsrc + (long long)lk * STAGE_F4;
        for (int i = tid; i < STAGE_F4; i += nthreads) cp_async16(dst + i, src + i);
        if (++lk == lnch) {
            lk = 0;
            if (++lc < ng) {
                lsrc = gp + tiles[3 * (ct0 + lc) + 2];
                lnch = tiles[3 * (ct0 + lc) + 1] / KC8;
            }
        }
    };
#pragma unroll
    for (int f = 0; f < STAGES - 1; ++f) {
        if (f < n_total) load_stage(f);
        cp_async_commit();
    }

    // this thread's A rows: slot warp*16 + h*8 + g, shifted into its window
    int abase[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const RowSrc rs = row_src(x, x_stride, T, pad_front, stride, Q, n_rows,
                                  row0 + cycle_of(rowmap, warp, h, g), u_lo, U);
        abase[h] = (warp * 16 + h * 8 + g) * pitch + rs.shift + t;
    }
    mbar_wait(full, 0u);
    int f = 0;
    for (int c = 0; c < ng; ++c) {
        const int ct = ct0 + c;
        const int a_off = tiles[3 * ct] - u_lo;
        float sum[NT][4], nc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int r = 0; r < 4; ++r) sum[n][r] = nc[n][r] = 0.f;
        const int nch = tiles[3 * ct + 1] / KC8;
        for (int k = 0; k < nch; ++k, ++f) {
            cp_async_wait<STAGES - 2>();
            consumer_sync(nthreads);    // stage f landed; stage f-1 is free
            if (f + STAGES - 1 < n_total) load_stage(f + STAGES - 1);
            cp_async_commit();
            const float4* st = ring + (f % STAGES) * STAGE_F4;
            // ---- the stage's math
#pragma unroll
            for (int kk = 0; kk < KC8; ++kk) {
                const int s8 = a_off + (k * KC8 + kk) * 8;
                uint32_t ah[4], al[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float v = win[abase[r & 1] + s8 + ((r >> 1) << 2)];
                    const uint32_t hi = tf32_rna(v);
                    ah[r] = hi;
                    al[r] = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
                }
#pragma unroll
                for (int n = 0; n < NT; ++n) {
                    const float4 bv = st[(kk * NT + n) * 32 + lane];
                    const uint32_t b0h = __float_as_uint(bv.x), b1h = __float_as_uint(bv.y);
                    const uint32_t b0l = __float_as_uint(bv.z), b1l = __float_as_uint(bv.w);
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
            // ---- end of the stage's math
        }
        // the tile's outputs straight from the C fragments, c0 (g, 2t) and
        // c1 (g, 2t+1) as one 8-byte store where the pair is aligned; c2,
        // c3 likewise at row g + 8
        const int l0 = ct * 8 * NT;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = row0 + cycle_of(rowmap, warp, h, g);
            if (row >= n_rows) continue;
            const int rb = row / Q, rq = row - rb * Q;
            const long long y0 = (long long)rb * out_stride + (long long)rq * L;
            const long long room = out_len - (long long)rq * L;   // outputs left in the row
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const int l = l0 + n * 8 + 2 * t;
                const float v0 = __fadd_rn(sum[n][2 * h], nc[n][2 * h]);
                const float v1 = __fadd_rn(sum[n][2 * h + 1], nc[n][2 * h + 1]);
                float* dst = y + y0 + l;
                if (l + 1 < L && l + 1 < room && !(((uintptr_t)dst) & 7)) {
                    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
                } else {
                    if (l < L && l < room) dst[0] = v0;
                    if (l + 1 < L && l + 1 < room) dst[1] = v1;
                }
            }
        }
    }
    cp_async_wait<0>();
}

constexpr int MAX_DEVICES = 64;

template <int NT, bool WIN>
const void* kernel_fn()
{
    return WIN ? reinterpret_cast<const void*>(cycle_src_win<NT>)
               : reinterpret_cast<const void*>(cycle_src_tc<NT>);
}

// Raise the kernel's dynamic shared-memory limit on the current device to
// `bytes` if it is lower (never lower it: an earlier, larger launch may
// still rely on it).  The attribute is per device; one lock per template
// keeps host threads from racing on what was raised.
template <int NT, bool WIN>
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
        e = cudaFuncSetAttribute(kernel_fn<NT, WIN>(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        allowed[dev] = bytes;
    }
    return cudaSuccess;
}

struct Args {
    const float* x;
    const float4* gp;
    const int* tiles;
    float* y;
    long long T, x_stride;
    int pad_front, M, L, Q;
    long long out_len, out_stride;
    int skew, rowmap, ring_off;         // the span form
    int pitch, n_rows, n_tiles, group;  // the windowed form
};

template <int NT, bool WIN>
int launch(const Args& a, dim3 grid, int threads, int smem_bytes, cudaStream_t stream)
{
    const cudaError_t e = allow_smem<NT, WIN>(smem_bytes);
    if (e != cudaSuccess) return (int)e;
    if constexpr (WIN)
        cycle_src_win<NT><<<grid, threads, smem_bytes, stream>>>(
            a.x, a.gp, a.tiles, a.y, a.T, a.x_stride, a.pad_front, a.M, a.L, a.Q, a.out_len,
            a.out_stride, a.pitch, a.n_rows, a.n_tiles, a.group, a.rowmap);
    else
        cycle_src_tc<NT><<<grid, threads, smem_bytes, stream>>>(
            a.x, a.gp, a.tiles, a.y, a.T, a.x_stride, a.pad_front, a.M, a.L, a.Q, a.out_len,
            a.out_stride, a.skew, a.rowmap, a.ring_off);
    return (int)cudaGetLastError();
}

template <bool WIN>
int launch_nt(int nt, const Args& a, dim3 grid, int threads, int smem_bytes, cudaStream_t s)
{
    switch (nt) {
    case 1: return launch<1, WIN>(a, grid, threads, smem_bytes, s);
    case 2: return launch<2, WIN>(a, grid, threads, smem_bytes, s);
    case 3: return launch<3, WIN>(a, grid, threads, smem_bytes, s);
    case 4: return launch<4, WIN>(a, grid, threads, smem_bytes, s);
    default: return launch<5, WIN>(a, grid, threads, smem_bytes, s);
    }
}

template <int NT, bool WIN>
cudaError_t occupancy(int* n, int threads, int smem_bytes)
{
    const cudaError_t e = allow_smem<NT, WIN>(smem_bytes);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel_fn<NT, WIN>(), threads,
                                                         smem_bytes);
}

template <bool WIN>
int blocks_per_sm(int nt, int threads, int smem_bytes)
{
    int n = 0;
    cudaError_t e = cudaSuccess;
    switch (nt) {
    case 1: e = occupancy<1, WIN>(&n, threads, smem_bytes); break;
    case 2: e = occupancy<2, WIN>(&n, threads, smem_bytes); break;
    case 3: e = occupancy<3, WIN>(&n, threads, smem_bytes); break;
    case 4: e = occupancy<4, WIN>(&n, threads, smem_bytes); break;
    default: e = occupancy<5, WIN>(&n, threads, smem_bytes); break;
    }
    return e == cudaSuccess ? n : -(int)e;
}

// shared memory of a windowed launch: the barrier, the windows, the ring
int win_smem_bytes(int nt, int warps, int pitch)
{
    return 16 + 4 * 16 * warps * pitch + STAGES * KC8 * nt * 32 * 16;
}

}  // namespace

extern "C" {

// Resident blocks per SM for a launch of `warps` warps (the windowed form:
// consumer warps, plus its producer warp) and `smem_bytes` of dynamic shared
// memory at n-tile count nt (after the attributes the launch sets), or a
// negative CUDA error code.
int f9_cycle_src_blocks_per_sm(int nt, int warps, int smem_bytes)
{
    return blocks_per_sm<false>(nt, 32 * warps, smem_bytes);
}

int f9_cycle_src_win_blocks_per_sm(int nt, int warps, int smem_bytes)
{
    return blocks_per_sm<true>(nt, 32 * (warps + 1), smem_bytes);
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
    const Args a{x, static_cast<const float4*>(gp), tiles, y, T, x_stride, pad_front, M, L, Q,
                 out_len, out_stride, skew, rowmap, ring_off, 0, 0, 0, 0};
    return launch_nt<false>(nt, a, grid, 32 * warps, smem_bytes, (cudaStream_t)stream);
}

// The windowed form, for banks with no dense matrix.  As f9_cycle_src; a
// block owns `group` (1-4) neighbouring column
// tiles and 16*warps rows, with 16*warps window slots of `pitch` floats
// (pitch % 32 == 4, at least every group's union window plus a shift of 3,
// in float4s); rowmap 1 (warps even) orders the rows of a slot group 4
// cycles apart; smem_bytes must be what win_smem_bytes says.  bc * Q rows
// at most 2^31 - 256.
int f9_cycle_src_win(const float* x, const void* gp, const int* tiles, float* y,
                     int bc, long long T, long long x_stride, int pad_front, int M,
                     int L, int Q, long long out_len, long long out_stride, int nt,
                     int n_tiles, int warps, int pitch, int group, int rowmap,
                     int smem_bytes, void* stream)
{
    const long long n_rows = (long long)bc * Q;
    if (bc <= 0 || Q <= 0 || L <= 0 || M <= 0 || T < 0 || n_rows > 2147483647LL - 256
        || out_len > (long long)Q * L || out_stride < out_len
        || nt < 1 || nt > MAX_NT || n_tiles != (L + 8 * nt - 1) / (8 * nt)
        || group < 1 || group > 4 || (n_tiles + group - 1) / group > 65535
        || warps < 1 || warps > MAX_WARPS || (warps & (warps - 1)) || (rowmap && warps < 2)
        || pitch % 32 != 4
        || smem_bytes != win_smem_bytes(nt, warps, pitch) || smem_bytes > 232448
        || (((uintptr_t)gp) & 15) || (((uintptr_t)x) & 3))
        return (int)cudaErrorInvalidValue;
    const long long per_block = 16LL * warps;
    const dim3 grid((unsigned)((n_rows + per_block - 1) / per_block),
                    (unsigned)((n_tiles + group - 1) / group), 1u);
    const Args a{x, static_cast<const float4*>(gp), tiles, y, T, x_stride, pad_front, M, L, Q,
                 out_len, out_stride, 0, rowmap, 0, pitch, (int)n_rows, n_tiles, group};
    return launch_nt<true>(nt, a, grid, 32 * (warps + 1), smem_bytes, (cudaStream_t)stream);
}

}  // extern "C"
