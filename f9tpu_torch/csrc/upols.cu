// The UPOLS delay-line multiply-sum on Hopper (sm_90a): one launch per
// group of G blocks.
//
// Replaces the body of the lax.scan in f9tpu/ops/chain.py:128 _upols (the
// scan at l.156) and :160 _upols_stream (l.188): per block g, Y_g =
// sum_k X[g-k] * H[k] over the K-deep frequency-domain delay line.  The
// scan's only carried state is the delay line, and the spectra X depend on
// the input alone, so the port transforms a group's G windows in one
// batched rFFT, runs this kernel once for all G outputs, and transforms
// them back in one batched irFFT (f9tpu_torch/ops/chain.py _upols_core).
// The plain twin is f9tpu_torch/ops/chain_kernels.py:upols_mac_reference,
// which this kernel matches bit for bit.
//
// Arithmetic, the CPU path's: each product is formed in float64 from the
// float32 parts; the K products are added in float64 in the order of the
// halving tree of chain_kernels._delay_line_sum (while n rows remain, row i
// adds row i + ceil(n/2)); each component is rounded to float32 once.
// Every rounding is an _rn intrinsic.
//
// Why the product may use FMAs.  The product of two float32 numbers has at
// most 48 significant bits and lies between 2^-298 and 2^256, so it is
// exact in float64.  With bd = b*d exact, fma(a, c, -bd) rounds the exact
// ac - bd once, as dsub(dmul(a, c), dmul(b, d)) does, and since dmul(a, c)
// is exact too the two give the same bits, the sign of a zero included (a
// zero sum takes its sign from the same exact operands either way).  So a
// product is 2 multiplies and 2 FMAs, and a complex multiply-add 6 float64
// instructions with the tree's 2 adds.
//
// What bounds it.  6 float64 instructions a complex multiply-add: 62.9 M
// of them for the insert loop's group (K = 30, G = 32, 16 rows of 4097
// bins) take 0.0226 ms at the H100's 16.75 T float64 instructions a second
// (its 33.5 TFLOP/s counts an FMA as two); the spectra read and Y written
// once are 51 MB, 0.015 ms at 3.35 TB/s, so the arithmetic sets the bound.
// The first design read X and H from L2 as float32 for every product and
// converted four values to float64 each time (conversions run at a quarter
// of the float64 rate): 0.23-0.29 ms.
//
// The design for K <= 32 (upols_mac_reg<K>).  A block owns 32 bins (a
// warp's lanes), up to 32 outputs of the group and up to two signal rows
// that share one H row.  It stages the tile's K values of H and, for each
// row, its K - 1 + 32 spectra in shared memory, each converted to float64
// once (the rows are Nf = B + 1 complex64 long, an odd count, so a row's
// start is only 8-byte aligned: the staging is plain 8-byte loads, issued
// twelve at a time before they are converted and stored).  A warp then takes
// one (row, 2 consecutive outputs) item at a time; each lane walks the
// tree depth first with compile-time indices, so its partials live in
// registers (a stack of about log2 K double2 an output), and loads each
// H[k] once for its 2 outputs.  An empty asm statement with a memory
// clobber before each leaf keeps the compiler from hoisting the leaves'
// loads ahead of the walk: hoisted, they spilled 2-4 KB a thread at 4
// outputs a lane and 1-2 KB at 2 (0.73 and 0.62 ms at the insert loop's
// group, tools/chain_kernel_ablation.py); held in place, 2 outputs take
// 128 registers, no spill at K <= 30 (40 and 156 bytes at 31 and 32), and
// 4 outputs still spill (0.14 ms).  That is 1.5 double2 loads from shared
// memory a multiply-add: 6 clocks of the SM's 128-byte shared-memory pipe
// for a warp, against 3 clocks of float64 arithmetic, so the loads, not the
// arithmetic, set how close it comes to the bound: about 0.045 ms of loads
// at the insert loop's group, and 0.055 ms measured with the staging's
// latency on top (PERF.md, section 6).  Above 32 taps, up to MAC_MAX_K,
// upols_mac_col keeps the first design's per-thread column of ceil(K/2)
// partials in shared memory (a thread a bin, X and H read from L2), with
// the FMA product.

#include <cuda_runtime.h>

#include <array>
#include <mutex>
#include <utility>

namespace {

#include "smem_limit.cuh"

constexpr int MAC_MAX_K = 64;
constexpr int MAC_REG_MAX_K = 32;        // the register-tree kernel's deepest line
constexpr int MAC_TB = 32;               // bins a block: one warp's lanes
constexpr int MAC_GB = 32;               // outputs of the group a block
constexpr int MAC_GN = 2;                // outputs a lane
constexpr int MAC_RB = 2;                // signal rows a block, sharing one H row
constexpr int MAC_WARPS = 8;
constexpr int MAC_THREADS = MAC_WARPS * 32;
constexpr int MAC_STAGE_BATCH = 12;      // loads in flight a thread while staging
constexpr int COL_THREADS = 128;         // upols_mac_col: a thread a bin
constexpr int COL_SMEM_MAX = (MAC_MAX_K / 2) * COL_THREADS * 16;
static_assert(MAC_GB % MAC_GN == 0, "a block's outputs come in whole items");

struct MacArgs {
    const float2* buf;     // (K - 1 + G, rows, Nf): block g's spectrum at K - 1 + g
    const float2* H;       // (K, Hrows, Nf)
    float2* Y;             // (G, rows, Nf)
    long long rows;
    long long rows_per_h;  // signal rows that share one H row
    long long Hrows;
    long long tiles;       // bin tiles a row (set by the launcher)
    long long chunks;      // upols_mac_reg: row chunks an H row, ceil(rows_per_h / MAC_RB)
    int Nf;
    int K;
    int G;
};

__device__ __forceinline__ double2 add2(double2 a, double2 b)
{
    a.x = __dadd_rn(a.x, b.x);
    a.y = __dadd_rn(a.y, b.y);
    return a;
}

// x * h for float64 values that are float32 numbers: each component rounded
// once (see the note at the top)
__device__ __forceinline__ double2 mac_product(double2 x, double2 h)
{
    double2 p;
    p.x = __fma_rn(x.x, h.x, -__dmul_rn(x.y, h.y));
    p.y = __fma_rn(x.x, h.y, __dmul_rn(x.y, h.x));
    return p;
}

// n_L, the rows left after L levels of the halving tree over K products
template <int K, int L>
struct TreeWidth {
    static constexpr int n = (TreeWidth<K, L - 1>::n + 1) / 2;
};
template <int K>
struct TreeWidth<K, 0> {
    static constexpr int n = K;
};

// the tree's levels, ceil(log2 K)
template <int K>
struct TreeLevels {
    static constexpr int n = 1 + TreeLevels<(K + 1) / 2>::n;
};
template <>
struct TreeLevels<1> {
    static constexpr int n = 0;
};

// Row I after L levels, for the lane's MAC_GN outputs: row I of level L - 1
// plus row I + n_L of it while that exists.  xs[(j - k) * MAC_TB] is output
// j's spectrum for tap k, hs[k * MAC_TB] is H[k].  The empty asm keeps each
// leaf's loads where the walk reaches it (see the note at the top).
template <int K, int L, int I>
__device__ __forceinline__ void tree_node(double2 (&acc)[MAC_GN], const double2* xs,
                                          const double2* hs)
{
    if constexpr (L == 0) {
        asm volatile("" ::: "memory");
        const double2 h = hs[I * MAC_TB];
#pragma unroll
        for (int j = 0; j < MAC_GN; ++j) acc[j] = mac_product(xs[(j - I) * MAC_TB], h);
    } else {
        constexpr int n = TreeWidth<K, L>::n;
        tree_node<K, L - 1, I>(acc, xs, hs);
        if constexpr (I + n < TreeWidth<K, L - 1>::n) {
            double2 right[MAC_GN];
            tree_node<K, L - 1, I + n>(right, xs, hs);
#pragma unroll
            for (int j = 0; j < MAC_GN; ++j) acc[j] = add2(acc[j], right[j]);
        }
    }
}

template <int K>
constexpr int reg_smem_bytes()
{
    return (K + MAC_RB * (K - 1 + MAC_GB)) * MAC_TB * (int)sizeof(double2);
}

// Block b: bin tile t, row chunk c of H row hr, output block gb, with b = t +
// tiles * (c + chunks * (hr + Hrows * gb)).
template <int K>
__global__ void __launch_bounds__(MAC_THREADS, 2) upols_mac_reg(const MacArgs a)
{
    extern __shared__ double2 st[];      // H [K][MAC_TB], then X [MAC_RB][XR][MAC_TB]
    constexpr int XR = K - 1 + MAC_GB;   // staged spectra a row
    constexpr int NH = K * MAC_TB;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    long long b = blockIdx.x;
    const long long t = b % a.tiles;
    b /= a.tiles;
    const long long c = b % a.chunks;
    b /= a.chunks;
    const long long hr = b % a.Hrows;
    const long long gb = b / a.Hrows;
    const long long r0 = hr * a.rows_per_h + c * MAC_RB;
    const int rbv = (int)min((long long)MAC_RB, a.rows_per_h - c * MAC_RB);
    const long long g0 = gb * MAC_GB;
    const int gbv = (int)min((long long)MAC_GB, (long long)a.G - g0);
    const long long f0 = t * MAC_TB;
    const long long plane = a.rows * a.Nf;

    // stage H and the rows' spectra as float64, +0.0 past Nf and past the
    // outputs this block owns
    const int n_stage = NH + rbv * XR * MAC_TB;
    for (int e0 = threadIdx.x; e0 < n_stage; e0 += MAC_STAGE_BATCH * MAC_THREADS) {
        float2 v[MAC_STAGE_BATCH];
#pragma unroll
        for (int u = 0; u < MAC_STAGE_BATCH; ++u) {
            const int e = e0 + u * MAC_THREADS;
            const long long f = f0 + (e & (MAC_TB - 1));
            v[u] = make_float2(0.0f, 0.0f);
            if (e >= n_stage || f >= a.Nf) continue;
            if (e < NH) {
                v[u] = a.H[((e / MAC_TB) * a.Hrows + hr) * a.Nf + f];
            } else {
                const int rr = (e - NH) / (XR * MAC_TB);
                const int j = (e - NH) / MAC_TB - rr * XR;
                if (j < K - 1 + gbv) v[u] = a.buf[(g0 + j) * plane + (r0 + rr) * a.Nf + f];
            }
        }
#pragma unroll
        for (int u = 0; u < MAC_STAGE_BATCH; ++u) {
            const int e = e0 + u * MAC_THREADS;
            if (e < n_stage) st[e] = make_double2((double)v[u].x, (double)v[u].y);
        }
    }
    __syncthreads();

    const long long f = f0 + lane;
    const int per_row = (gbv + MAC_GN - 1) / MAC_GN;
    for (int it = warp; it < rbv * per_row; it += MAC_WARPS) {
        const int rr = it / per_row;
        const int g = (it - rr * per_row) * MAC_GN;    // the item's first output
        double2 acc[MAC_GN];
        tree_node<K, TreeLevels<K>::n, 0>(acc, st + NH + (rr * XR + K - 1 + g) * MAC_TB + lane,
                                        st + lane);
        if (f < a.Nf) {
            float2* y = a.Y + (g0 + g) * plane + (r0 + rr) * a.Nf + f;
#pragma unroll
            for (int j = 0; j < MAC_GN; ++j)
                if (g + j < gbv)
                    y[j * plane] = make_float2(__double2float_rn(acc[j].x),
                                               __double2float_rn(acc[j].y));
        }
    }
}

// Block b: bins [t * COL_THREADS, (t + 1) * COL_THREADS) of signal row r of
// block g of the group, b = t + tiles * (r + rows * g).  For K > 32.
__global__ void __launch_bounds__(COL_THREADS) upols_mac_col(const MacArgs a)
{
    extern __shared__ double2 partials[];           // [ceil(K/2)][COL_THREADS]
    const long long b = blockIdx.x;
    const long long rg = b / a.tiles;
    const long long g = rg / a.rows;
    const long long r = rg - g * a.rows;
    const long long f = (b - rg * a.tiles) * COL_THREADS + threadIdx.x;
    if (f >= a.Nf) return;
    const long long plane = a.rows * a.Nf;
    const long long hstep = a.Hrows * a.Nf;
    // the newest spectrum of block g, and H's row for signal row r
    const float2* x = a.buf + (a.K - 1 + g) * plane + r * a.Nf + f;
    const float2* h = a.H + (r / a.rows_per_h) * a.Nf + f;
    auto product = [&](int k) {
        const float2 xv = x[-(long long)k * plane];
        const float2 hv = h[(long long)k * hstep];
        return mac_product(make_double2(xv.x, xv.y), make_double2(hv.x, hv.y));
    };
    double2* p = partials + threadIdx.x;
    const int K = a.K;
    int n = (K + 1) / 2;
    // the first level: row i adds row i + ceil(K/2) while that exists
    for (int i = 0; i < n; ++i) {
        double2 v = product(i);
        if (i + n < K) v = add2(v, product(i + n));
        p[i * COL_THREADS] = v;
    }
    while (n > 1) {
        const int hh = (n + 1) / 2;
        for (int i = 0; i < n - hh; ++i)
            p[i * COL_THREADS] = add2(p[i * COL_THREADS], p[(i + hh) * COL_THREADS]);
        n = hh;
    }
    const double2 v = p[0];
    a.Y[g * plane + r * a.Nf + f] = make_float2(__double2float_rn(v.x), __double2float_rn(v.y));
}

using RegLaunch = cudaError_t (*)(MacArgs, cudaStream_t);

template <int K>
cudaError_t launch_reg(MacArgs a, cudaStream_t stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    a.tiles = (a.Nf + MAC_TB - 1) / MAC_TB;
    a.chunks = (a.rows_per_h + MAC_RB - 1) / MAC_RB;
    const long long blocks = a.tiles * a.chunks * a.Hrows * ((a.G + MAC_GB - 1) / MAC_GB);
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    cudaError_t e = allow_smem((const void*)upols_mac_reg<K>, allowed, reg_smem_bytes<K>());
    if (e != cudaSuccess) return e;
    upols_mac_reg<K><<<(unsigned)blocks, MAC_THREADS, reg_smem_bytes<K>(), stream>>>(a);
    return cudaGetLastError();
}

template <int... I>
constexpr std::array<RegLaunch, sizeof...(I)> reg_table(std::integer_sequence<int, I...>)
{
    return {{&launch_reg<I + 1>...}};
}

// launch_reg<K> at [K - 1]
constexpr auto REG_LAUNCH = reg_table(std::make_integer_sequence<int, MAC_REG_MAX_K>{});

cudaError_t launch_col(MacArgs a, cudaStream_t stream)
{
    static int allowed[SMEM_MAX_DEVICES] = {};
    a.tiles = (a.Nf + COL_THREADS - 1) / COL_THREADS;
    const long long blocks = a.tiles * a.rows * a.G;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    cudaError_t e = allow_smem((const void*)upols_mac_col, allowed, COL_SMEM_MAX);
    if (e != cudaSuccess) return e;
    const size_t smem = (size_t)((a.K + 1) / 2) * COL_THREADS * sizeof(double2);
    upols_mac_col<<<(unsigned)blocks, COL_THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// Y (G, rows, Nf) complex64 = for each g: sum_{k<K} buf[K-1+g-k] * H[k, hrow],
// buf (K-1+G, rows, Nf) and H (K, Hrows, Nf) complex64 as float pairs, hrow =
// row / rows_per_h.  Launches on `stream`; returns a CUDA error code (0 =
// launched).
int f9_upols_mac(const void* buf, const void* H, void* Y, long long rows,
                 long long rows_per_h, long long Hrows, int Nf, int K, int G, void* stream)
{
    if (K < 1 || K > MAC_MAX_K || G < 1 || Nf < 1 || rows < 1 || rows_per_h < 1
        || Hrows < 1 || Hrows * rows_per_h != rows)
        return (int)cudaErrorInvalidValue;
    MacArgs a{};
    a.buf = (const float2*)buf;
    a.H = (const float2*)H;
    a.Y = (float2*)Y;
    a.rows = rows;
    a.rows_per_h = rows_per_h;
    a.Hrows = Hrows;
    a.Nf = Nf;
    a.K = K;
    a.G = G;
    const cudaStream_t s = (cudaStream_t)stream;
    return (int)(K <= MAC_REG_MAX_K ? REG_LAUNCH[K - 1](a, s) : launch_col(a, s));
}

}  // extern "C"
