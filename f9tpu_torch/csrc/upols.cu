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
// float32 parts, where a*c and b*d are exact, so ac - bd and ad + bc are
// each rounded once (whether or not a compiler contracts them); the K
// products are added in float64 in the order of the halving tree of
// chain_kernels._delay_line_sum (while n rows remain, row i adds row
// i + ceil(n/2)); each component is rounded to float32 once.  Every
// rounding is an _rn intrinsic.  A thread owns one output bin: it forms
// the tree's first level as it forms the products (product i plus product
// i + ceil(K/2)), stages those ceil(K/2) partials in its own column of
// shared memory and runs the remaining levels there, so no barrier is
// needed and the control flow depends on K alone (a depth-first walk of
// the tree in registers spilled to local memory: PERF.md, section 6).
//
// What bounds it.  8 float64 instructions a complex multiply-add (4
// products, 2 rounded sums, 2 adds of the tree), each rounded on its own:
// 11.1 G for the insert loop's batch (16 rows x 4097 bins x 30 taps x ~704
// blocks), 0.66 ms at the H100's 16.75 T float64 instructions a second
// (its 33.5 TFLOP/s counts an FMA as two); the spectra read and Y written
// once are 0.74 GB, 0.22 ms at 3.35 TB/s, so the arithmetic sets the
// bound.  This design reads X and H for every
// product from L2 (a group's spectra, 32 MB at the insert loop's shape,
// and H, 2 MB, stay there): about 1 GB of L2 reads a launch of 32 blocks.
// Reusing H and X across a tile of outputs in shared memory is a later
// step.

#include <cuda_runtime.h>

namespace {

constexpr int MAC_THREADS = 128;
// K <= MAC_MAX_K: ceil(K/2) double2 partials a thread in shared memory
constexpr int MAC_MAX_K = 64;
constexpr int MAC_SMEM_MAX = (MAC_MAX_K / 2) * MAC_THREADS * 16;

struct MacArgs {
    const float2* buf;     // (K - 1 + G, rows, Nf): block g's spectrum at K - 1 + g
    const float2* H;       // (K, Hrows, Nf)
    float2* Y;             // (G, rows, Nf)
    long long rows;
    long long rows_per_h;  // signal rows that share one H row
    long long tiles;       // bin tiles a row: ceil(Nf / MAC_THREADS)
    int Nf;
    int K;
};

// X[g - k] * H[k] in float64: the products of float32 parts are exact, so
// each component is rounded once.
__device__ __forceinline__ double2 mac_product(const float2* x, const float2* h,
                                               long long xstep, long long hstep, int k)
{
    const float2 a = x[-(long long)k * xstep];
    const float2 c = h[(long long)k * hstep];
    const double ar = a.x, ai = a.y, cr = c.x, ci = c.y;
    double2 p;
    p.x = __dsub_rn(__dmul_rn(ar, cr), __dmul_rn(ai, ci));
    p.y = __dadd_rn(__dmul_rn(ar, ci), __dmul_rn(ai, cr));
    return p;
}

__device__ __forceinline__ double2 add2(double2 a, double2 b)
{
    a.x = __dadd_rn(a.x, b.x);
    a.y = __dadd_rn(a.y, b.y);
    return a;
}

// Block b: bins [t * MAC_THREADS, (t + 1) * MAC_THREADS) of signal row r of
// block g of the group, b = t + tiles * (r + rows * g).
__global__ void __launch_bounds__(MAC_THREADS) upols_mac_kernel(const MacArgs a)
{
    extern __shared__ double2 partials[];           // [ceil(K/2)][MAC_THREADS]
    const long long b = blockIdx.x;
    const long long rg = b / a.tiles;
    const long long g = rg / a.rows;
    const long long r = rg - g * a.rows;
    const long long f = (b - rg * a.tiles) * MAC_THREADS + threadIdx.x;
    if (f >= a.Nf) return;
    const long long plane = a.rows * a.Nf;
    const long long hstep = (a.rows / a.rows_per_h) * a.Nf;
    // the newest spectrum of block g, and H's row for signal row r
    const float2* x = a.buf + (a.K - 1 + g) * plane + r * a.Nf + f;
    const float2* h = a.H + (r / a.rows_per_h) * a.Nf + f;
    double2* p = partials + threadIdx.x;
    const int K = a.K;
    int n = (K + 1) / 2;
    // the first level: row i adds row i + ceil(K/2) while that exists
    for (int i = 0; i < n; ++i) {
        double2 v = mac_product(x, h, plane, hstep, i);
        if (i + n < K) v = add2(v, mac_product(x, h, plane, hstep, i + n));
        p[i * MAC_THREADS] = v;
    }
    while (n > 1) {
        const int hh = (n + 1) / 2;
        for (int i = 0; i < n - hh; ++i)
            p[i * MAC_THREADS] = add2(p[i * MAC_THREADS], p[(i + hh) * MAC_THREADS]);
        n = hh;
    }
    const double2 v = p[0];
    a.Y[g * plane + r * a.Nf + f] = make_float2(__double2float_rn(v.x), __double2float_rn(v.y));
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
    MacArgs a;
    a.buf = (const float2*)buf;
    a.H = (const float2*)H;
    a.Y = (float2*)Y;
    a.rows = rows;
    a.rows_per_h = rows_per_h;
    a.tiles = (Nf + MAC_THREADS - 1) / MAC_THREADS;
    a.Nf = Nf;
    a.K = K;
    const long long blocks = a.tiles * rows * G;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    // always the same (largest) value, so no launch ever lowers it
    cudaError_t e = cudaFuncSetAttribute(upols_mac_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MAC_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)((K + 1) / 2) * MAC_THREADS * sizeof(double2);
    upols_mac_kernel<<<(unsigned)blocks, MAC_THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
