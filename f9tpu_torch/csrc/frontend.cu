// The front end of the batch graph and of the stream as one pass on Hopper
// (sm_90a): interleaved integer PCM (or a float32 planar bucket) in, float32
// planar (files, C_out, frames) out, fanned out, routed and masked.
//
// What it replaces.  No Pallas kernel: the JAX package gets this from one XLA
// fusion of f9tpu/pipeline/graph.py:63 _front_end (f9tpu/ops/devcodec.py:32
// unpack_pcm_interleaved, the mono fan-out, f9tpu/ops/routing.py:37
// route_channels, f9tpu/ops/trim.py:195 mask_beyond) and, in the stream, of
// f9tpu/pipeline/stream.py:229 _raw_front.  The port ran them as a string of
// eager passes (an int32 (files, frames, C, bytes) intermediate, shifts, ORs,
// the sign extension, a float cast, a scale, a transposing copy, a gather, a
// where over the bucket); the plain twin, f9tpu_torch/ops/frontend.py
// front_end_reference, is that code.
//
// Bit for bit the twin.  The sample is the same integer (the bytes ORed in
// place, the sign extended by subtracting twice the sign bit), converted to
// float32 exactly (|v| < 2^24) and scaled by a power of two (exact): one
// __int2float_rn and one __fmul_rn.  A float32 input is copied by its bits.
// A silent output channel is +0.0, a frame at or past a file's valid length
// is +0.0 without being read.  In stream mode the twin's order is kept:
// route, fill the silent channels, then subtract (real ? mean[c] : +0.0) by
// __fsub_rn at every frame, also where the term is zero.
//
// What bounds it.  The valid wire bytes read once and the float32 output
// written once (8 files x 2 channels x 2^22 frames of 24-bit PCM: 201.3 MB +
// 268.4 MB, 0.140 ms at 3.35 TB/s; less with the files' true lengths).
// The design: one block of FE_THREADS per (file, tile of `tile` frames), on a
// 1-D grid (y and z stop at 65,535 blocks; 65,600 mono files are one block
// each).  The block stages the tile's valid wire bytes in shared memory with
// 16-byte loads from the 16-byte grid, byte loads for the unaligned head and
// tail (rows of mono 24-bit or odd frame counts start anywhere), nothing past
// the valid span.  Then each thread takes (output channel, quad) items: a
// quad is 4 frames on the 16-byte grid of the output row, decoded from shared
// memory and written by one 16-byte store; the at most 3 frames before a
// row's first quad and after its last are written one by one.  A tile's
// bytes stay under FE_STAGE_BYTES (the wrapper picks `tile`), so 8 blocks of
// 256 threads fit an SM.  All offsets are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#ifndef FE_THREADS  // a block's threads (tests/test_torch_frontend.py builds it with fewer)
#define FE_THREADS 256
#endif
// the most frames a tile takes, and the shared memory a block may stage
#define FE_MAX_TILE 4096
#define FE_SMEM_MAX 49152

namespace {

struct FeArgs {
    const unsigned char* wire;  // byte wire: file f's row at wire + f * row_stride
    const float* xs;            // float wire: (f, s, t) at xs[f * row_stride + s * chan_stride + t]
    const int* map;             // (c_out): the input channel of each output, -1 = silent
    const int* valid;           // (files) valid frames, or null: nothing masked
    const float* mean;          // (c_out) the stream's DC means, or null: nothing subtracted
    float* out;                 // (files, c_out, frames), contiguous
    long long frames, row_stride, chan_stride, tiles, lo, hi, idx_offset;
    int c_in, c_out, tile;
};

// One sample of the byte wire from its NB bytes: little-endian, or
// big-endian (AIFF "NONE") with the byte lanes reversed.
template <int NB, bool BE>
__device__ __forceinline__ float fe_decode(const unsigned char* b)
{
    if constexpr (NB == 2) {
        const int lo = BE ? b[1] : b[0], hi = BE ? b[0] : b[1];
        int v = lo | (hi << 8);
        v -= (v & 0x8000) << 1;  // sign-extend 16 -> 32
        return __fmul_rn(__int2float_rn(v), 1.0f / 32768.0f);
    }
    const int lo = BE ? b[2] : b[0], mid = b[1], hi = BE ? b[0] : b[2];
    int v = lo | (mid << 8) | (hi << 16);
    v -= (v & 0x800000) << 1;  // sign-extend 24 -> 32
    return __fmul_rn(__int2float_rn(v), 1.0f / 8388608.0f);
}

// The output at tile frame j of channel c (input channel s): +0.0 past the
// valid span or on a silent channel, else the decoded or copied sample; in
// stream mode minus (real ? mean : +0.0).
template <int NB, bool BE>
__device__ __forceinline__ float fe_value(const FeArgs& a, const unsigned char* sm, long long f,
                                          long long t0, int j, int nr, int s, float m)
{
    float v = 0.0f;
    if (j < nr && s >= 0) {
        if constexpr (NB > 0)
            v = fe_decode<NB, BE>(sm + (long long)j * (a.c_in * NB) + s * NB);
        else
            v = a.xs[f * a.row_stride + s * a.chan_stride + t0 + j];
    }
    if (a.mean != nullptr) {
        const long long i = t0 + j + a.idx_offset;
        v = __fsub_rn(v, (i >= a.lo && i < a.hi) ? m : 0.0f);
    }
    return v;
}

// Stage bytes [src, src + nbytes) at shared byte (src & 15) + k: 16-byte
// loads for the words on the 16-byte grid, byte loads for the head and tail.
__device__ __forceinline__ void fe_stage(uint4* sm, const unsigned char* src, long long nbytes)
{
    const int shift = (int)(reinterpret_cast<uintptr_t>(src) & 15);
    const unsigned char* base = src - shift;  // on the 16-byte grid
    const long long end = shift + nbytes;     // staged bytes [shift, end) of base
    const long long first = shift ? 16 : 0;   // the first whole word
    const long long last = end & ~15LL;       // the end of the last whole word
    for (long long w = first / 16 + threadIdx.x; w < last / 16; w += FE_THREADS)
        sm[w] = reinterpret_cast<const uint4*>(base)[w];
    unsigned char* smb = reinterpret_cast<unsigned char*>(sm);
    const long long head_end = first < end ? first : end;
    for (long long k = shift + threadIdx.x; k < head_end; k += FE_THREADS) smb[k] = base[k];
    for (long long k = (last > first ? last : first) + threadIdx.x; k < end; k += FE_THREADS)
        smb[k] = base[k];
}

template <int NB, bool BE>
__global__ void __launch_bounds__(FE_THREADS) front_end_kernel(const FeArgs a)
{
    extern __shared__ uint4 fe_sm[];
    const long long blk = blockIdx.x;
    const long long f = blk / a.tiles;
    const long long t0 = (blk - f * a.tiles) * a.tile;
    const int n = (int)(a.frames - t0 < a.tile ? a.frames - t0 : a.tile);
    long long lim = a.frames;
    if (a.valid != nullptr) {
        const long long v = a.valid[f];
        lim = v < 0 ? 0 : (v < lim ? v : lim);
    }
    const int nr = (int)(lim - t0 <= 0 ? 0 : (lim - t0 < n ? lim - t0 : n));
    const unsigned char* sm = nullptr;
    if constexpr (NB > 0) {
        const unsigned char* src = a.wire + f * a.row_stride + t0 * (a.c_in * NB);
        fe_stage(fe_sm, src, (long long)nr * (a.c_in * NB));
        sm = reinterpret_cast<const unsigned char*>(fe_sm)
             + (reinterpret_cast<uintptr_t>(src) & 15);
    }
    __syncthreads();

    // per row: slot 0 the head (frames before the first 16-byte boundary of
    // the output row), slots 1..nq the quads, slot nq + 1 the tail
    const int S = n / 4 + 2;
    for (int item = threadIdx.x; item < a.c_out * S; item += FE_THREADS) {
        const int c = item / S, slot = item - c * S;
        float* dst = a.out + (f * a.c_out + c) * a.frames + t0;
        const int to_grid = (int)(((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2);
        const int h = to_grid < n ? to_grid : n;
        const int nq = (n - h) >> 2;
        if (slot > nq + 1) continue;
        const int s = a.map[c];
        const float m = a.mean != nullptr ? a.mean[c] : 0.0f;
        if (slot == 0 || slot == nq + 1) {
            const int j0 = slot == 0 ? 0 : h + 4 * nq, j1 = slot == 0 ? h : n;
            for (int j = j0; j < j1; ++j) dst[j] = fe_value<NB, BE>(a, sm, f, t0, j, nr, s, m);
        } else {
            const int j = h + 4 * (slot - 1);
            float4 q;
            q.x = fe_value<NB, BE>(a, sm, f, t0, j, nr, s, m);
            q.y = fe_value<NB, BE>(a, sm, f, t0, j + 1, nr, s, m);
            q.z = fe_value<NB, BE>(a, sm, f, t0, j + 2, nr, s, m);
            q.w = fe_value<NB, BE>(a, sm, f, t0, j + 3, nr, s, m);
            *reinterpret_cast<float4*>(dst + j) = q;
        }
    }
}

// Shared memory of a tile of `tile` frames of `bpf` bytes: the staged bytes
// start at their address's offset from the 16-byte grid (at most 15), as
// ops/frontend.py front_end_smem counts them.
long long fe_smem(int tile, int bpf) { return ((long long)tile * bpf + 30) & ~15LL; }

template <int NB, bool BE>
cudaError_t fe_launch(const FeArgs& a, long long blocks, int smem, cudaStream_t stream)
{
    front_end_kernel<NB, BE><<<(unsigned)blocks, FE_THREADS, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The front end of `files` rows.  nbytes 2 or 3: `src` is the uint8 wire, row
// f at src + f * row_stride bytes, frames * c_in * nbytes of it read as
// interleaved PCM (big_endian: AIFF "NONE"); nbytes 0: `src` is float32,
// sample (f, s, t) at src[f * row_stride + s * chan_stride + t].  Output
// channel c is input channel map[c] (-1: +0.0).  `valid` (files) int32, or
// null, zeroes frames at and past each file's length; `mean` (c_out) float32,
// or null, is subtracted where lo <= t + idx_offset < hi.  `out` (files,
// c_out, frames) float32, contiguous.  `tile` is a power of two <= 4096
// frames.  Launches on `stream`; returns a CUDA error code (0 = launched).
int f9_front_end(const void* src, const int* map, const int* valid, const float* mean, float* out,
                 long long files, long long frames, long long row_stride, long long chan_stride,
                 int c_in, int c_out, int nbytes, int big_endian, int tile, long long lo,
                 long long hi, long long idx_offset, void* stream)
{
    if (files < 1 || frames < 1 || c_in < 1 || c_out < 1 || tile < 1 || tile > FE_MAX_TILE
        || (tile & (tile - 1)) != 0 || (nbytes != 0 && nbytes != 2 && nbytes != 3)
        || (big_endian && nbytes == 0) || row_stride < 0 || chan_stride < 0)
        return (int)cudaErrorInvalidValue;
    const long long smem = nbytes ? fe_smem(tile, c_in * nbytes) : 0;
    const long long tiles = (frames + tile - 1) / tile;
    if (smem > FE_SMEM_MAX || files * tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    FeArgs a;
    a.wire = nbytes ? static_cast<const unsigned char*>(src) : nullptr;
    a.xs = nbytes ? nullptr : static_cast<const float*>(src);
    a.map = map;
    a.valid = valid;
    a.mean = mean;
    a.out = out;
    a.frames = frames;
    a.row_stride = row_stride;
    a.chan_stride = chan_stride;
    a.tiles = tiles;
    a.lo = lo;
    a.hi = hi;
    a.idx_offset = idx_offset;
    a.c_in = c_in;
    a.c_out = c_out;
    a.tile = tile;
    const cudaStream_t s = (cudaStream_t)stream;
    const long long blocks = files * tiles;
    switch (nbytes * 2 + (big_endian ? 1 : 0)) {
        case 4: return (int)fe_launch<2, false>(a, blocks, (int)smem, s);
        case 5: return (int)fe_launch<2, true>(a, blocks, (int)smem, s);
        case 6: return (int)fe_launch<3, false>(a, blocks, (int)smem, s);
        case 7: return (int)fe_launch<3, true>(a, blocks, (int)smem, s);
        default: return (int)fe_launch<0, false>(a, blocks, 0, s);
    }
}

}  // extern "C"
