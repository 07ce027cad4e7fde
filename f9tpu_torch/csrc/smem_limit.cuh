// Raising a kernel's dynamic shared-memory limit past the 48 KB a launch
// gets without asking, shared by the chain's kernels.
//
// Include it inside a translation unit's anonymous namespace, after
// <cuda_runtime.h> and <mutex>: it declares no namespace.

constexpr int SMEM_MAX_DEVICES = 64;

// Raise `fn`'s limit on the current device to `bytes` if it is lower, and
// never lower it (an earlier, larger launch may still rely on it).
// `allowed` is the kernel's own record of what was raised, per device;
// one lock keeps host threads (one per shard) from racing on it.
inline cudaError_t allow_smem(const void* fn, int (&allowed)[SMEM_MAX_DEVICES], int bytes)
{
    static std::mutex mu;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= SMEM_MAX_DEVICES) return cudaErrorInvalidDevice;
    const std::lock_guard<std::mutex> lock(mu);
    if (bytes > allowed[dev]) {
        e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (e != cudaSuccess) return e;
        allowed[dev] = bytes;
    }
    return cudaSuccess;
}
