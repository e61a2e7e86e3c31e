// K5: element part of the stacked-block operator apply,
// Ye_e = A_e * (m X)_e for the per-element (6C x 6C) blocks A_e.
//
// Replaces the gather and the batched product of
// pl_fem_tpu/ops/kernels.py _apply_stacked (the einsum "eij,ejk->eik" at
// Precision.HIGHEST between the DOF gather and _accumulate). C = 1 is
// the scalar Helmholtz pencil, C = 3 the fixed-beta vectorial operator
// from its assembled (E, 18, 18) blocks. The element -> DOF sum and the
// mask / park epilogue are K2's (accumulate.cu).
//
// Layout: X is the stacked component-major block (C * D, k); the kernel
// multiplies each gathered row by its mask value (mask (D,), the same
// for every component), so no masked copy of X is ever written. Ye is
// (C, E, 6, k): component c's slab is an (E, 6, k) block that K2 takes
// as it is, one K2 launch per component writing rows [c D, (c + 1) D).
//
// One block owns G consecutive elements and stages their blocks, DOF
// indices and mask values in shared memory; one thread owns one
// (element, column), holds the 6C gathered inputs in registers and
// forms each of the 6C result rows as a chain of plain f32 FMAs over
// j = 0 .. 6C - 1 in order (no TF32, no tensor cores). Neighbouring
// threads own neighbouring columns, so a gathered row segment and a Ye
// store are contiguous across the warp.
//
// Bound on the H100: bytes. It reads the blocks once (36 C^2 E floats),
// X once (C D k floats; the ~6 elements sharing a DOF row re-read it,
// mostly from L2) and writes Ye (6 C E k floats). The arithmetic is
// 36 C^2 FMAs per (element, column), far under the f32 roof.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;        // elements per block at most

template <int C>
__global__ void __launch_bounds__(kThreads)
apply_stacked_kernel(const float* __restrict__ X,        // (C * D, k)
                     const float* __restrict__ mask,     // (D,)
                     const int* __restrict__ elem_dofs,  // (E, 6)
                     const float* __restrict__ Abig,     // (E, 6C, 6C)
                     int E, int D, int k, int G,
                     float* __restrict__ Ye)             // (C, E, 6, k)
{
    constexpr int R = 6 * C;
    extern __shared__ float smem[];
    float* sA = smem;                                    // (G, R, R)
    int* sd = reinterpret_cast<int*>(sA + G * R * R);    // (G, 6)
    float* sm = reinterpret_cast<float*>(sd + G * 6);    // (G, 6)

    const int e0 = blockIdx.x * G;
    const int ne = min(G, E - e0);
    const float* Ag = Abig + (size_t)e0 * R * R;
    for (int i = threadIdx.x; i < ne * R * R; i += blockDim.x) sA[i] = Ag[i];
    for (int i = threadIdx.x; i < ne * 6; i += blockDim.x) {
        const int d = elem_dofs[(size_t)e0 * 6 + i];
        sd[i] = d;
        sm[i] = mask[d];
    }
    __syncthreads();

    for (int t = threadIdx.x; t < ne * k; t += blockDim.x) {
        const int el = t / k;
        const int j = t - el * k;
        float u[R];
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                const size_t row = (size_t)c * D + sd[el * 6 + i];
                u[c * 6 + i] = X[row * k + j] * sm[el * 6 + i];
            }
        }
        const float* A = sA + el * R * R;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float acc = 0.0f;
#pragma unroll
            for (int jj = 0; jj < R; ++jj)
                acc = fmaf(A[r * R + jj], u[jj], acc);
            const int c = r / 6;
            const int i = r - 6 * c;
            Ye[(((size_t)c * E + e0 + el) * 6 + i) * k + j] = acc;
        }
    }
}

template <int C>
cudaError_t launch(const float* X, const float* mask, const int* elem_dofs,
                   const float* Abig, int E, int D, int k, float* Ye,
                   cudaStream_t stream)
{
    constexpr int R = 6 * C;
    // as many elements per block as fill its threads with (element,
    // column) pairs, at most kMaxGroup (C = 3: 41 KB of blocks)
    int G = kThreads / k;
    G = G < 1 ? 1 : (G > kMaxGroup ? kMaxGroup : G);
    const size_t shmem = (size_t)G * (R * R + 12) * sizeof(float);
    apply_stacked_kernel<C><<<(E + G - 1) / G, kThreads, shmem, stream>>>(
        X, mask, elem_dofs, Abig, E, D, k, G, Ye);
    return cudaGetLastError();
}

}  // namespace

extern "C" int pl_apply_stacked(
    const void* X, const void* mask, const void* elem_dofs, const void* Abig,
    int E, int D, int k, int C, void* Ye, void* stream)
{
    if (E < 1 || D < 1 || k < 1 || (C != 1 && C != 3))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 1)
        return (int)launch<1>((const float*)X, (const float*)mask,
                              (const int*)elem_dofs, (const float*)Abig,
                              E, D, k, (float*)Ye, s);
    return (int)launch<3>((const float*)X, (const float*)mask,
                          (const int*)elem_dofs, (const float*)Abig,
                          E, D, k, (float*)Ye, s);
}
