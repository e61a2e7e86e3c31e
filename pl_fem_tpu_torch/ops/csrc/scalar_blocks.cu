// K7: the scalar Helmholtz pencil's element blocks,
//   A_e = K_e - k0^2 Me_e,   B_e = M_e,   with
//   K_e[i,j]  = sum_q w_q (dx N_i dx N_j + dy N_i dy N_j),
//   Me_e[i,j] = sum_q w_q eps_q N_i N_j,   M_e[i,j] = sum_q w_q N_i N_j.
//
// Replaces pl_fem_tpu/ops/assembly.py scalar_blocks and the combination
// A = K - k0^2 Me of assemble_scalar_system (three weighted einsums
// "eq,eqi,eqj->eij" inside one jit). The mass diagonal of the same
// function is K2 at lane count 1 on B's diagonal.
//
// One thread owns one entry (element, i, j) and sums the Q quadrature
// points in order; one block owns kElems elements and stages their
// gradient, weight and permittivity tables and the shape table in
// shared memory, so device memory is read once.
//
// Bound on the H100: bytes. Per element it reads 12 Q gradients, Q
// weights and Q permittivities and writes two 6 x 6 blocks (4 * (14 Q +
// 72) bytes); the arithmetic is ~9 Q operations per entry.

#include <cuda_runtime.h>

namespace {

constexpr int kElems = 8;            // elements per block
constexpr int kMaxQ = 16;

__global__ void __launch_bounds__(kElems * 36)
scalar_blocks_kernel(const float* __restrict__ gp,     // (E, Q, 6, 2)
                     const float* __restrict__ w,      // (E, Q)
                     const float* __restrict__ Nref,   // (Q, 6)
                     const float* __restrict__ eps,    // (E, Q)
                     float k2, int E, int Q,
                     float* __restrict__ A,            // (E, 6, 6)
                     float* __restrict__ B)            // (E, 6, 6)
{
    __shared__ float sgp[kElems * kMaxQ * 12];
    __shared__ float sw[kElems * kMaxQ];
    __shared__ float se[kElems * kMaxQ];
    __shared__ float sN[kMaxQ * 6];

    const int e0 = blockIdx.x * kElems;
    const int ne = min(kElems, E - e0);
    for (int i = threadIdx.x; i < ne * Q * 12; i += blockDim.x)
        sgp[i] = gp[(size_t)e0 * Q * 12 + i];
    for (int i = threadIdx.x; i < ne * Q; i += blockDim.x) {
        sw[i] = w[(size_t)e0 * Q + i];
        se[i] = eps[(size_t)e0 * Q + i];
    }
    for (int i = threadIdx.x; i < Q * 6; i += blockDim.x) sN[i] = Nref[i];
    __syncthreads();

    const int el = threadIdx.x / 36;
    if (el >= ne) return;
    const int ij = threadIdx.x - el * 36;
    const int i = ij / 6;
    const int j = ij - 6 * i;
    float kx = 0.0f, ky = 0.0f, me = 0.0f, m = 0.0f;
    for (int q = 0; q < Q; ++q) {
        const float wq = sw[el * Q + q];
        const float* g = sgp + (el * Q + q) * 12;    // g[2i] = dx, g[2i+1] = dy
        const float nn = sN[q * 6 + i] * sN[q * 6 + j];
        kx += wq * g[2 * i] * g[2 * j];
        ky += wq * g[2 * i + 1] * g[2 * j + 1];
        me += wq * se[el * Q + q] * nn;
        m += wq * nn;
    }
    const size_t o = (size_t)(e0 + el) * 36 + ij;
    A[o] = (kx + ky) - k2 * me;
    B[o] = m;
}

}  // namespace

extern "C" int pl_scalar_blocks(
    const void* gp, const void* w, const void* Nref, const void* eps,
    float k2, int E, int Q, void* A, void* B, void* stream)
{
    if (E < 1 || Q < 1 || Q > kMaxQ) return (int)cudaErrorInvalidValue;
    scalar_blocks_kernel<<<(E + kElems - 1) / kElems, kElems * 36, 0,
                           (cudaStream_t)stream>>>(
        (const float*)gp, (const float*)w, (const float*)Nref,
        (const float*)eps, k2, E, Q, (float*)A, (float*)B);
    return (int)cudaGetLastError();
}
