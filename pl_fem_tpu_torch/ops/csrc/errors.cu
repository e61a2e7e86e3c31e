// Error text for the codes the kernel launchers return.

#include <cuda_runtime.h>

extern "C" const char* pl_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
