// K1: element math of the packed A(beta_b) apply (fixed-beta curl-curl
// plus alpha * div penalty on P2 triangles), Ye = A_e(beta_b) U_e.
//
// Replaces the element part of pl_fem_tpu/ops/kernels.py
// _apply_vector3_fused (the q-loop between the DOF gather and
// _accumulate_fused). Mask, park and the element->DOF sum live in K2.
//
// Layout: Xm is (D, L) with L = B * 3 * k lanes ordered (b, c, j), the
// JAX package's fused-lane layout. Ye is (E, 6, L) in the same lanes.
// One thread owns one (element, b, j) and all three components c, so
// the 6 x 3 gathered nodal values and the 6 x 3 results stay in
// registers; one block owns one element and stages that element's
// per-quadrature tables (gp, w, 1/eps_b) and the shape table N in
// shared memory, so each table entry is read from device memory once
// per block, not once per lane.
//
// Bound on the H100: bytes. Per apply it reads the gathered block
// (E * 6 * L floats, each DOF row re-read by the ~6 elements that
// share it, mostly from L2) and writes Ye (E * 6 * L floats); the
// arithmetic is ~600 FMAs per (element, lane), well under the FLOP
// roof. The design keeps every intermediate (values, gradients, curl
// and divergence terms at the Q points) in registers, so device memory
// sees only the gather and the one Ye store. Neighbouring threads
// handle neighbouring columns j, so each gathered row segment and each
// Ye store is contiguous across the warp.
//
// Padded elements carry w = 0 and therefore contribute exactly 0.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxQ = 16;

__global__ void apply_vector3_elem_kernel(
    const float* __restrict__ Xm,        // (D, L)
    const int* __restrict__ elem_dofs,   // (E, 6)
    const float* __restrict__ gp,        // (E, Q, 6, 2)
    const float* __restrict__ w,         // (E, Q)
    const float* __restrict__ inv_eps,   // (B, E, Q)
    const float* __restrict__ betas,     // (B,)
    const float* __restrict__ Nref,      // (Q, 6)
    float alpha, int E, int B, int k, int Q,
    float* __restrict__ Ye)              // (E, 6, L)
{
    __shared__ float sN[kMaxQ * 6];
    __shared__ float sgp[kMaxQ * 12];
    __shared__ float sw[kMaxQ];
    __shared__ int sd[6];

    const int e = blockIdx.x;
    for (int i = threadIdx.x; i < Q * 6; i += blockDim.x) sN[i] = Nref[i];
    for (int i = threadIdx.x; i < Q * 12; i += blockDim.x)
        sgp[i] = gp[(size_t)e * Q * 12 + i];
    for (int i = threadIdx.x; i < Q; i += blockDim.x)
        sw[i] = w[(size_t)e * Q + i];
    if (threadIdx.x < 6) sd[threadIdx.x] = elem_dofs[e * 6 + threadIdx.x];
    __syncthreads();

    const int t = blockIdx.y * blockDim.x + threadIdx.x;
    if (t >= B * k) return;
    const int b = t / k;
    const int j = t - b * k;
    const size_t L = (size_t)3 * B * k;
    const size_t off = (size_t)b * 3 * k + j;

    float u[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const float* xr = Xm + (size_t)sd[i] * L + off;
        u[i][0] = xr[0];
        u[i][1] = xr[k];
        u[i][2] = xr[2 * k];
    }
    float y[6][3];
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i][0] = y[i][1] = y[i][2] = 0.0f;

    const float beta = betas[b];
    const float* ie = inv_eps + ((size_t)b * E + e) * Q;
    for (int q = 0; q < Q; ++q) {
        const float* Nq = sN + q * 6;
        const float* g = sgp + q * 12;        // (6, 2): g[2i] = dx, g[2i+1] = dy
        float V[3], Gx[3], Gy[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            float v = 0.0f, gx = 0.0f, gy = 0.0f;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                v += Nq[i] * u[i][c];
                gx += g[2 * i] * u[i][c];
                gy += g[2 * i + 1] * u[i][c];
            }
            V[c] = v; Gx[c] = gx; Gy[c] = gy;
        }
        const float c1 = Gy[2] - beta * V[1];            // dy hz - b hy
        const float c2 = beta * V[0] - Gx[2];            // b hx - dx hz
        const float c3 = Gx[1] - Gy[0];                  // dx hy - dy hx
        const float dv = Gx[0] + Gy[1] - beta * V[2];    // div_t - b hz
        const float we = sw[q] * ie[q];
        const float wa = sw[q] * alpha;
        const float c1h = we * c1, c2h = we * c2, c3h = we * c3;
        const float dvh = wa * dv;
        // value channel S and gradient channels Tx, Ty per component
        const float S[3] = {beta * c2h, -beta * c1h, -beta * dvh};
        const float Tx[3] = {dvh, c3h, -c2h};
        const float Ty[3] = {-c3h, dvh, c1h};
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int c = 0; c < 3; ++c)
                y[i][c] += Nq[i] * S[c] + g[2 * i] * Tx[c] + g[2 * i + 1] * Ty[c];
        }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        float* yr = Ye + ((size_t)e * 6 + i) * L + off;
        yr[0] = y[i][0];
        yr[k] = y[i][1];
        yr[2 * k] = y[i][2];
    }
}

}  // namespace

extern "C" int pl_apply_vector3_elem(
    const void* Xm, const void* elem_dofs, const void* gp, const void* w,
    const void* inv_eps, const void* betas, const void* Nref, float alpha,
    int E, int B, int k, int Q, void* Ye, void* stream)
{
    if (Q < 1 || Q > kMaxQ || E < 1 || B < 1 || k < 1)
        return (int)cudaErrorInvalidValue;
    // split the B * k lanes into the fewest blocks of <= 256, evenly
    const int lanes = B * k;
    const int nb = (lanes + 255) / 256;
    const int threads = (((lanes + nb - 1) / nb + 31) / 32) * 32;
    dim3 grid(E, nb);
    apply_vector3_elem_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)Xm, (const int*)elem_dofs, (const float*)gp,
        (const float*)w, (const float*)inv_eps, (const float*)betas,
        (const float*)Nref, alpha, E, B, k, Q, (float*)Ye);
    return (int)cudaGetLastError();
}
