// Hopper's asynchronous data movement, shared by the port's kernels: shared
// memory addresses, mbarriers with transaction counts and parity waits, the
// TMA's 1-D bulk copies in both directions (with and without an L2 cache
// policy), bulk groups, and the proxy fence between them.
//
// Include it inside a translation unit's anonymous namespace, after
// <cstdint>: it declares no namespace and includes nothing.

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// the TMA's 1-D bulk copy global -> shared (16-byte aligned ends), completion
// counted in bytes on `bar`
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// an L2 policy for the accesses that carry it: keep the lines past
// others (evict_last) or drop them first (evict_first)
__device__ __forceinline__ uint64_t policy_evict_last()
{
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
    return p;
}

__device__ __forceinline__ uint64_t policy_evict_first()
{
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
    return p;
}

// bulk_g2s with an L2 policy on the reads
__device__ __forceinline__ void bulk_g2s_hint(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar, uint64_t policy)
{
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
                 : "memory");
}

// the TMA's 1-D bulk copy shared -> global (16-byte aligned ends) in the
// issuing thread's current bulk group, with an L2 policy on the writes
__device__ __forceinline__ void bulk_s2g_hint(void* dst, const void* src, uint32_t bytes,
                                              uint64_t policy)
{
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
                 " [%0], [%1], %2, %3;\n"
                 :: "l"(dst), "r"(smem_u32(src)), "r"(bytes), "l"(policy) : "memory");
}

__device__ __forceinline__ void bulk_commit()
{
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// the issuing thread's bulk groups have read their shared memory (it may
// be written again)
__device__ __forceinline__ void bulk_wait_read_all()
{
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// the issuing thread's bulk groups are complete (their writes are done)
__device__ __forceinline__ void bulk_wait_all()
{
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// order this thread's generic-proxy writes to shared memory before a later
// bulk copy (async proxy) reads them
__device__ __forceinline__ void fence_proxy_async_smem()
{
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence_mbarrier_init()
{
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
