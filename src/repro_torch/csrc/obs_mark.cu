// Device-time marks for the span tracer (repro_torch/obs/trace.py).
//
// Replaces no TPU kernel: the JAX package times its spans on the host
// (jax.block_until_ready at span exit).  On the card a span instead
// enqueues a mark at each end: a one-thread kernel that writes the
// GPU's %globaltimer (nanoseconds) into its slot of a page-locked,
// host-mapped ring and returns.  The host reads the slot after a
// synchronisation the program makes anyway, so a traced run adds no
// copy and no synchronisation of its own, and a mark captured in a CUDA
// graph rewrites its slot at every replay.
//
// Bound on this card: launch latency, a few microseconds; the kernel
// moves 8 bytes.  Each boundary of the speculative round is a kernel of
// its own name, so the profiler's device timeline shows where a replay
// of the round's graph passes from the verify to the draft and where
// the rollback starts and ends; every other span uses obs_mark_span.
#include <cuda_runtime.h>
#include <string.h>

namespace {

__device__ __forceinline__ void stamp(unsigned long long* ring, int slot) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    ring[slot] = t;
    __threadfence_system();
}

}  // namespace

extern "C" __global__ void obs_mark_span(unsigned long long* ring, int slot) {
    stamp(ring, slot);
}

extern "C" __global__ void obs_mark_round_begin(unsigned long long* ring,
                                                int slot) {
    stamp(ring, slot);
}

extern "C" __global__ void obs_mark_draft_begin(unsigned long long* ring,
                                                int slot) {
    stamp(ring, slot);
}

extern "C" __global__ void obs_mark_round_end(unsigned long long* ring,
                                              int slot) {
    stamp(ring, slot);
}

extern "C" __global__ void obs_mark_rollback_begin(unsigned long long* ring,
                                                   int slot) {
    stamp(ring, slot);
}

extern "C" __global__ void obs_mark_rollback_end(unsigned long long* ring,
                                                 int slot) {
    stamp(ring, slot);
}

// kind: the index of the mark in kernels/obs_mark.py's KINDS.
extern "C" int obs_mark(int kind, void* ring, int slot, void* stream) {
    unsigned long long* r = static_cast<unsigned long long*>(ring);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case 0: obs_mark_span<<<1, 1, 0, s>>>(r, slot); break;
        case 1: obs_mark_round_begin<<<1, 1, 0, s>>>(r, slot); break;
        case 2: obs_mark_draft_begin<<<1, 1, 0, s>>>(r, slot); break;
        case 3: obs_mark_round_end<<<1, 1, 0, s>>>(r, slot); break;
        case 4: obs_mark_rollback_begin<<<1, 1, 0, s>>>(r, slot); break;
        case 5: obs_mark_rollback_end<<<1, 1, 0, s>>>(r, slot); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

// n zeroed 8-byte slots of page-locked host memory mapped into the
// device's address space: *host for the host's reads, *dev for the marks.
extern "C" int obs_ring_alloc(int n, void** host, void** dev) {
    cudaError_t e = cudaHostAlloc(host, static_cast<size_t>(n) * 8,
                                  cudaHostAllocMapped | cudaHostAllocPortable);
    if (e != cudaSuccess) return static_cast<int>(e);
    memset(*host, 0, static_cast<size_t>(n) * 8);
    return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}
