// K3: element math of the consistent P2 mass apply,
// Ye[e, i, l] = sum_j C_ij(e) Xm[dof(e, j), l] with
// C_ij(e) = sum_q w[e, q] N[q, i] N[q, j].
//
// Replaces the element part of pl_fem_tpu/ops/kernels.py
// _apply_mass_fused (the 21 per-element coefficients and the 36
// broadcast FMAs). Mask, park and the element->DOF sum live in K2.
//
// One block owns one element: its 36 coefficients are formed once, in
// shared memory, from the element's Q weights and the shape table N
// (passed in at launch from the port's quadrature module). Each thread
// then owns one lane l, gathers the element's 6 DOF values for it and
// writes the 6 results.
//
// Bound on the H100: bytes, exactly as K1 (gathered block in, Ye out,
// E * 6 * L floats each) at a sixth of K1's arithmetic. The lanes of a
// block are contiguous, so gathers and stores are coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 16;

__global__ void apply_mass_elem_kernel(
    const float* __restrict__ Xm,        // (D, L)
    const int* __restrict__ elem_dofs,   // (E, 6)
    const float* __restrict__ w,         // (E, Q)
    const float* __restrict__ Nref,      // (Q, 6)
    int Q, int L,
    float* __restrict__ Ye)              // (E, 6, L)
{
    __shared__ float sC[36];
    __shared__ int sd[6];
    const int e = blockIdx.x;
    if (threadIdx.x < 36) {
        const int i = threadIdx.x / 6, j = threadIdx.x % 6;
        float c = 0.0f;
        for (int q = 0; q < Q; ++q)
            c += (Nref[q * 6 + i] * Nref[q * 6 + j]) * w[(size_t)e * Q + q];
        sC[threadIdx.x] = c;
    }
    if (threadIdx.x < 6) sd[threadIdx.x] = elem_dofs[e * 6 + threadIdx.x];
    __syncthreads();

    const int l = blockIdx.y * blockDim.x + threadIdx.x;
    if (l >= L) return;
    float u[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) u[j] = Xm[(size_t)sd[j] * L + l];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) acc += sC[i * 6 + j] * u[j];
        Ye[((size_t)e * 6 + i) * L + l] = acc;
    }
}

}  // namespace

extern "C" int pl_apply_mass_elem(
    const void* Xm, const void* elem_dofs, const void* w, const void* Nref,
    int E, int Q, int L, void* Ye, void* stream)
{
    if (Q < 1 || Q > kMaxQ || E < 1 || L < 1)
        return (int)cudaErrorInvalidValue;
    // split L into the fewest blocks of <= 256 lanes, evenly
    const int nb = (L + 255) / 256;
    int threads = (((L + nb - 1) / nb + 31) / 32) * 32;
    if (threads < 64) threads = 64;          // 36 coefficient threads
    dim3 grid(E, nb);
    apply_mass_elem_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)Xm, (const int*)elem_dofs, (const float*)w,
        (const float*)Nref, Q, L, (float*)Ye);
    return (int)cudaGetLastError();
}
