// K8: the deterministic spectrum bound of the pencil (A, B),
//   bound = 1.02 * max_e max_i sum_l |W_e[i, l]|,
//   W_e = Linv (A_e / |detJ|_e) Linv^T,
// the Gershgorin row sums of the element blocks after the constant
// congruence with L_ref^{-1} (block-diagonal over the C components).
//
// Replaces pl_fem_tpu/ops/kernels.py pencil_bounds_elem (a jitted
// "ij,ejk,lk->eil" einsum at Precision.HIGHEST plus reductions). |detJ|_e
// comes from the trace of the element's mass block over the reference
// trace, floored at ``tiny`` and set to 1 on padded elements before the
// division, and padded elements contribute 0 to the maximum, as there.
//
// First launch: one thread owns one row i of one element. A block
// stages its G elements' blocks, already divided by |detJ|_e, in shared
// memory; the thread forms T[i, :] = Linv[i, :] a (6 products per
// entry: Linv is 6 x 6 per component), then row i of W and its absolute
// sum; the block reduces its rows to one partial maximum. Second
// launch: one block reduces the partials and multiplies by 1.02. A
// maximum does not depend on the order it is taken in, so the result
// is deterministic without float atomics.
//
// Bound on the H100: bytes. It reads the blocks once (36 C^2 E floats),
// the 6 diagonal entries of each mass block and one flag per element;
// the arithmetic is 12 * 6C FMAs per row.

#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 256;

template <int C> struct Group;       // elements per block
template <> struct Group<1> { static constexpr int n = 32; };
template <> struct Group<3> { static constexpr int n = 8; };

template <int C>
__global__ void __launch_bounds__(Group<C>::n * 6 * C)
pencil_rows_kernel(const float* __restrict__ Abig,           // (E, 6C, 6C)
                   const float* __restrict__ Bblk,           // (E, 6, 6)
                   const unsigned char* __restrict__ valid,  // (E,)
                   const float* __restrict__ Linv,           // (6, 6)
                   float trace_ref, float tiny, int E,
                   float* __restrict__ partial)              // (blocks,)
{
    constexpr int R = 6 * C;
    constexpr int G = Group<C>::n;
    __shared__ float sA[G * R * R];
    __shared__ float sL[36];
    __shared__ float sdet[G];
    __shared__ float srow[G * R];

    const int e0 = blockIdx.x * G;
    const int ne = min(G, E - e0);
    if (threadIdx.x < 36) sL[threadIdx.x] = Linv[threadIdx.x];
    if (threadIdx.x < ne) {
        const int e = e0 + threadIdx.x;
        float tr = 0.0f;
#pragma unroll
        for (int i = 0; i < 6; ++i) tr += Bblk[(size_t)e * 36 + i * 7];
        const float dj = tr / trace_ref;
        sdet[threadIdx.x] = valid[e] ? fmaxf(dj, tiny) : 1.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < ne * R * R; i += blockDim.x)
        sA[i] = Abig[(size_t)e0 * R * R + i] / sdet[i / (R * R)];
    __syncthreads();

    const int el = threadIdx.x / R;
    const int i = threadIdx.x - el * R;
    float rowsum = 0.0f;
    if (el < ne) {
        const int c = i / 6;
        const int il = i - 6 * c;
        const float* a = sA + el * R * R + (6 * c) * R;   // rows 6c .. 6c+5
        float T[R];
#pragma unroll
        for (int kk = 0; kk < R; ++kk) {
            float t = 0.0f;
#pragma unroll
            for (int j = 0; j < 6; ++j)
                t = fmaf(sL[il * 6 + j], a[j * R + kk], t);
            T[kk] = t;
        }
#pragma unroll
        for (int l = 0; l < R; ++l) {
            const int c2 = l / 6;
            const int ll = l - 6 * c2;
            float wv = 0.0f;
#pragma unroll
            for (int kk = 0; kk < 6; ++kk)
                wv = fmaf(T[6 * c2 + kk], sL[ll * 6 + kk], wv);
            rowsum += fabsf(wv);
        }
    }
    srow[threadIdx.x] = rowsum;
    __syncthreads();
    if (threadIdx.x == 0) {
        float best = 0.0f;
        for (int g = 0; g < ne; ++g) {
            if (!valid[e0 + g]) continue;
            for (int r = 0; r < R; ++r) best = fmaxf(best, srow[g * R + r]);
        }
        partial[blockIdx.x] = best;
    }
}

__global__ void __launch_bounds__(kReduceThreads)
pencil_max_kernel(const float* __restrict__ partial, int n,
                  float* __restrict__ out)
{
    __shared__ float s[kReduceThreads];
    float best = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        best = fmaxf(best, partial[i]);
    s[threadIdx.x] = best;
    __syncthreads();
    for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h)
            s[threadIdx.x] = fmaxf(s[threadIdx.x], s[threadIdx.x + h]);
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = s[0] * 1.02f;
}

template <int C>
cudaError_t launch(const float* Abig, const float* Bblk,
                   const unsigned char* valid, const float* Linv,
                   float trace_ref, float tiny, int E, float* partial,
                   float* out, cudaStream_t stream)
{
    constexpr int G = Group<C>::n;
    const int nb = (E + G - 1) / G;
    pencil_rows_kernel<C><<<nb, G * 6 * C, 0, stream>>>(
        Abig, Bblk, valid, Linv, trace_ref, tiny, E, partial);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    pencil_max_kernel<<<1, kReduceThreads, 0, stream>>>(partial, nb, out);
    return cudaGetLastError();
}

}  // namespace

// The partial array must hold pl_pencil_bounds_blocks(E, C) floats.
extern "C" int pl_pencil_bounds_blocks(int E, int C)
{
    const int G = C == 1 ? Group<1>::n : Group<3>::n;
    return (E + G - 1) / G;
}

extern "C" int pl_pencil_bounds(
    const void* Abig, const void* Bblk, const void* valid, const void* Linv,
    float trace_ref, float tiny, int E, int C, void* partial, void* out,
    void* stream)
{
    if (E < 1 || (C != 1 && C != 3)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 1)
        return (int)launch<1>((const float*)Abig, (const float*)Bblk,
                              (const unsigned char*)valid,
                              (const float*)Linv, trace_ref, tiny, E,
                              (float*)partial, (float*)out, s);
    return (int)launch<3>((const float*)Abig, (const float*)Bblk,
                          (const unsigned char*)valid, (const float*)Linv,
                          trace_ref, tiny, E, (float*)partial, (float*)out,
                          s);
}
