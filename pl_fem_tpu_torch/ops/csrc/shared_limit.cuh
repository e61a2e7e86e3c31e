// The dynamic shared-memory limit of the row-owned kernels (K1, K3, K5).
//
// Each launcher sets its kernel's limit to this one value at every
// launch, never to the size of the launch at hand: two host threads (the
// dataset engine's bucket pipeline) launch at once, and a size set per
// launch by one could fall under the other's request before it launches,
// which then fails as "too many resources requested for launch".
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr size_t kMaxShared = 227 * 1024 - 1024;   // of a block

template <typename Kernel>
cudaError_t set_shared_limit(Kernel kernel)
{
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxShared);
}

}  // namespace
