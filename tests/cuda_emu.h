// The CUDA features f9tpu_torch/csrc/cycle_fold.cu and csrc/frontend.cu use,
// emulated on the CPU for tests/test_torch_cycle_fold.py and
// tests/test_torch_frontend.py: one std::thread per CUDA thread, a
// std::barrier for __syncthreads, the blocks of a launch one after another,
// a block's dynamic shared memory filled with NaNs before it starts (so a
// word read before it is written shows).  Host memory stands for device
// memory.  The test rewrites the kernel's launch and shared declarations to
// `emu_launch`, `emu_dynamic_smem` and `emu_static_smem`.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__

struct dim3 { unsigned x = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, unsigned long n, cudaStream_t)
{
    std::memset(p, v, n);
    return cudaSuccess;
}

inline std::barrier<>* emu_bar = nullptr;
inline std::vector<unsigned> emu_lanes(1024);
inline std::vector<double> emu_dynamic((232448 + 7) / 8);
inline std::vector<unsigned> emu_static(64);
inline std::mutex emu_atomic;

inline double* emu_dynamic_smem() { return emu_dynamic.data(); }
inline unsigned* emu_static_smem() { return emu_static.data(); }
inline void __syncthreads() { emu_bar->arrive_and_wait(); }

// a barrier that also tells each thread whether any thread's predicate held
inline int __syncthreads_or(int pred)
{
    emu_lanes[threadIdx.x] = pred != 0;
    emu_bar->arrive_and_wait();
    int any = 0;
    for (unsigned k = 0; k < blockDim.x; ++k) any |= emu_lanes[k];
    emu_bar->arrive_and_wait();
    return any;
}

// every lane of the warp arrives (as every thread of the kernel calls it)
inline unsigned __reduce_max_sync(unsigned, unsigned v)
{
    emu_lanes[threadIdx.x] = v;
    emu_bar->arrive_and_wait();
    unsigned m = 0;
    const unsigned w0 = threadIdx.x & ~31u;
    for (unsigned k = 0; k < 32; ++k) m = std::max(m, emu_lanes[w0 + k]);
    emu_bar->arrive_and_wait();
    return m;
}

inline unsigned atomicMax(unsigned* p, unsigned v)
{
    const std::lock_guard<std::mutex> lock(emu_atomic);
    const unsigned old = *p;
    *p = std::max(old, v);
    return old;
}

struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) float4 { float x, y, z, w; };

inline float __double2float_rn(double d) { return static_cast<float>(d); }
inline float __int2float_rn(int v) { return static_cast<float>(v); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline unsigned __float_as_uint(float f)
{
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}
using std::fma;
using std::max;

template <typename Body>
void emu_launch(unsigned blocks, unsigned threads, Body body)
{
    blockDim.x = threads;
    for (unsigned b = 0; b < blocks; ++b) {
        std::fill(emu_dynamic.begin(), emu_dynamic.end(), std::nan(""));
        std::barrier<> bar(threads);
        emu_bar = &bar;
        std::vector<std::thread> ts;
        for (unsigned t = 0; t < threads; ++t)
            ts.emplace_back([=, &body] {
                threadIdx.x = t;
                blockIdx.x = b;
                body();
            });
        for (auto& th : ts) th.join();
    }
}
