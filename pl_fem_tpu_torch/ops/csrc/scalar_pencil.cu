// K11: the scalar Helmholtz pencil's set-up in one launch: the
// permittivity at the quadrature points, the element blocks
//   A_e = K_e - k0^2 Me_e,   B_e = M_e,
// B_e's diagonal terms, and the spectrum bound
//   bound = 1.02 * max_e max_i sum_l |W_e[i, l]|,
//   W_e = Linv (A_e / |detJ|_e) Linv^T,
// with K_e, Me_e, M_e the sums of K7 (scalar_blocks.cu) and the bound
// that of K8 at C = 1 (pencil_bounds.cu).
//
// Replaces pl_fem_tpu/ops/assembly.py eps_at_quadrature (its real part:
// the scalar pencil drops the PML's imaginary part), scalar_blocks and
// assemble_scalar_system's A = K - k0^2 Me, and pl_fem_tpu/ops/kernels.py
// pencil_bounds_elem on those blocks: on the scalar path the single-design
// K6 (Triton), K7 and K8's two launches at C = 1, with the (E, Q)
// permittivity, the strided read of B's diagonal and the second read of
// A in device memory between them.
//
// A block owns kElems elements, one thread a row (element, i), and
// works in shared memory throughout:
//  a. it starts the copies of the elements' gradients (16 bytes each)
//     and weights into shared memory (cp.async) and stages the shape
//     table, Linv and the elements' flags; while the copies fly, a
//     thread a quadrature point loads its coordinates and decides
//     eps_core (d^2 <= r^2 for any core) or eps_clad, each square and
//     the sum rounded on their own (no FMA contraction), so every point
//     is decided as K6 and its twin decide it; r^2 is r * r rounded
//     once, as the wrapper of K6 forms it;
//  b. a thread sums row i of K, Me and M over the Q points in order,
//     each entry as K7 sums it (the products of row i's factors formed
//     once a point), so A and B equal K7's bit for bit, and puts the
//     rows in shared memory;
//  c. the block writes A and B in 16-byte copies and the diagonal terms
//     (E, 6) for K2 at lane count 1; a thread takes |detJ|_e from the
//     trace of B_e over the reference trace (floored at ``tiny``, 1 on
//     padded elements) and divides its row of A by it, then forms its
//     row of T = Linv (A_e / |detJ|_e) and of W = T Linv^T and its
//     absolute sum (0 on padded elements), in K8's order of operations:
//     the bound equals K8's on the same blocks bit for bit. The block
//     takes the maximum of its rows.
// Each block folds fl(1.02 * its maximum) into the bound with an
// atomicMax on the bits of a non-negative float, whose order is the
// unsigned order of the bits; rounding is monotone, so that is
// fl(1.02 * the maximum over all rows), as K8's reduce gives it, and a
// maximum does not depend on the order the blocks arrive in: the bound
// is bit for bit repeatable. The launcher zeroes the bound first (a
// 4-byte memset on the stream), so a call is one memset and one kernel.
//
// Bound on the H100: bytes. Per element it reads 12 Q gradients, Q
// weights, 2 Q point coordinates and a flag and writes two 6 x 6 blocks
// and 6 diagonal terms (4 * (15 Q + 78) + 1 bytes); the operations are
// ~6 per (point, core), ~12 Q per entry and ~1100 for the rows. A thread
// a row keeps a row's 24 sums in registers and reads each point's
// factors once for six entries: a thread an entry (K7's layout) issued
// ~3x the instructions and took twice the time. Most of the time is
// the loads and stores themselves (on the H100 the kernel with its
// arithmetic removed is not much faster); the copies fly while the
// core test runs. Persistent blocks that stream the next tile during
// this one's arithmetic were no faster. Shared memory is static (~15 KB
// a block, under the 48 KB a launch gets without an attribute), so no
// launch sets a limit.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kElems = 16;                // elements per block
constexpr int kThreads = kElems * 6;      // a thread per (element, row)
constexpr int kMaxQ = 8;
constexpr int kWarps = kThreads / 32;
static_assert(kThreads % 32 == 0, "whole warps");

__global__ void __launch_bounds__(kThreads)
scalar_pencil_kernel(const float* __restrict__ gp,        // (E, Q, 6, 2)
                     const float* __restrict__ w,         // (E, Q)
                     const float* __restrict__ xy,        // (E, Q, 2)
                     const float* __restrict__ Nref,      // (Q, 6)
                     const float* __restrict__ pos,       // (n_cores, 2)
                     const float* __restrict__ radii,     // (n_cores,)
                     const float* __restrict__ eps_core,  // 0-d
                     const float* __restrict__ eps_clad,  // 0-d
                     float k2,
                     const unsigned char* __restrict__ valid,  // (E,)
                     const float* __restrict__ Linv,      // (6, 6)
                     float trace_ref, float tiny, int E, int Q, int n_cores,
                     float* __restrict__ A,               // (E, 6, 6)
                     float* __restrict__ B,               // (E, 6, 6)
                     float* __restrict__ diag,            // (E, 6)
                     float* __restrict__ eps_out,         // (E, Q) or null
                     unsigned int* __restrict__ bound)    // f32 bits
{
    __shared__ __align__(16) float sgp[kElems * kMaxQ * 12];
    __shared__ float sw[kElems * kMaxQ];
    __shared__ float se[kElems * kMaxQ];
    __shared__ __align__(16) float sN[kMaxQ * 6];
    __shared__ __align__(16) float sL[36];
    __shared__ __align__(16) float sA[kElems * 36];   // A_e
    __shared__ __align__(16) float sB[kElems * 36];   // B_e
    __shared__ __align__(16) float sH[kElems * 36];   // A_e / |detJ|_e
    __shared__ unsigned char sv[kElems];
    __shared__ float swarp[kWarps];

    const int t = threadIdx.x;
    const int e0 = blockIdx.x * kElems;
    const int ne = min(kElems, E - e0);

    // a. staging, and the permittivity at the block's points
    {
        const float* g = gp + (size_t)e0 * Q * 12;
        for (int k = t; k < ne * Q * 3; k += kThreads)
            __pipeline_memcpy_async(sgp + 4 * k, g + 4 * k, 16);
        const float* v = w + (size_t)e0 * Q;
        for (int k = t; k < ne * Q; k += kThreads)
            __pipeline_memcpy_async(sw + k, v + k, 4);
        __pipeline_commit();
    }
    for (int k = t; k < Q * 6; k += kThreads) sN[k] = Nref[k];
    if (t < 36) sL[t] = Linv[t];
    if (t < ne) sv[t] = valid[e0 + t];
    const float2* xy2 = reinterpret_cast<const float2*>(xy) + (size_t)e0 * Q;
    const float2* pos2 = reinterpret_cast<const float2*>(pos);
    for (int p = t; p < ne * Q; p += kThreads) {
        const float2 c = xy2[p];
        bool inside = false;
        for (int n = 0; n < n_cores; ++n) {
            const float2 o = __ldg(pos2 + n);
            const float r = __ldg(radii + n);
            const float dx = __fsub_rn(c.x, o.x);
            const float dy = __fsub_rn(c.y, o.y);
            inside |= __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy))
                      <= __fmul_rn(r, r);
        }
        const float e = inside ? __ldg(eps_core) : __ldg(eps_clad);
        se[p] = e;
        if (eps_out) eps_out[(size_t)e0 * Q + p] = e;
    }
    __pipeline_wait_prior(0);
    __syncthreads();

    // b. row i of element el: K7's sums
    const int el = t / 6;
    const int i = t - 6 * el;
    const bool own = el < ne;
    float a[6] = {};
    if (own) {
        float kx[6], ky[6], me[6], m[6];
#pragma unroll
        for (int j = 0; j < 6; ++j) kx[j] = ky[j] = me[j] = m[j] = 0.0f;
        for (int q = 0; q < Q; ++q) {
            const float wq = sw[el * Q + q];
            const float* gq = sgp + (el * Q + q) * 12;
            const float2 gi = reinterpret_cast<const float2*>(gq)[i];
            const float ni = sN[q * 6 + i];
            const float wgx = wq * gi.x;      // (dx N_i, dy N_i) weighted
            const float wgy = wq * gi.y;
            const float wqe = wq * se[el * Q + q];
            float g[12], nq[6];               // 16- and 8-byte loads
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float4 v = reinterpret_cast<const float4*>(gq)[k];
                g[4 * k] = v.x; g[4 * k + 1] = v.y;
                g[4 * k + 2] = v.z; g[4 * k + 3] = v.w;
                const float2 u =
                    reinterpret_cast<const float2*>(sN + q * 6)[k];
                nq[2 * k] = u.x; nq[2 * k + 1] = u.y;
            }
#pragma unroll
            for (int j = 0; j < 6; ++j) {
                const float nn = ni * nq[j];
                kx[j] = fmaf(wgx, g[2 * j], kx[j]);
                ky[j] = fmaf(wgy, g[2 * j + 1], ky[j]);
                me[j] = fmaf(wqe, nn, me[j]);
                m[j] = fmaf(wq, nn, m[j]);
            }
        }
        float* ar = sA + el * 36 + i * 6;
        float* br = sB + el * 36 + i * 6;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            a[j] = (kx[j] + ky[j]) - k2 * me[j];
            ar[j] = a[j];
            br[j] = m[j];
        }
    }
    __syncthreads();

    // c. A, B and the diagonal terms out; A_e / |detJ|_e
    {
        const float4* a4 = reinterpret_cast<const float4*>(sA);
        const float4* b4 = reinterpret_cast<const float4*>(sB);
        float4* A4 = reinterpret_cast<float4*>(A + (size_t)e0 * 36);
        float4* B4 = reinterpret_cast<float4*>(B + (size_t)e0 * 36);
        for (int k = t; k < ne * 9; k += kThreads) {
            A4[k] = a4[k];
            B4[k] = b4[k];
        }
    }
    if (own) {
        diag[(size_t)e0 * 6 + t] = sB[el * 36 + i * 7];
        float tr = 0.0f;
#pragma unroll
        for (int r = 0; r < 6; ++r) tr += sB[el * 36 + r * 7];
        const float dj = tr / trace_ref;
        const float det = sv[el] ? fmaxf(dj, tiny) : 1.0f;
        float* hr = sH + el * 36 + i * 6;
#pragma unroll
        for (int j = 0; j < 6; ++j) hr[j] = a[j] / det;
    }
    __syncthreads();

    // K8's row: T[i, :] = Linv[i, :] (A_e / |detJ|_e), W[i, l] =
    // T[i, :] . Linv[l, :], and sum_l |W[i, l]|
    float rs = 0.0f;
    if (own && sv[el]) {
        const float2* h = reinterpret_cast<const float2*>(sH + el * 36);
        const float2* L2 = reinterpret_cast<const float2*>(sL);
        float li[6], T[6];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float2 u = L2[i * 3 + k];
            li[2 * k] = u.x; li[2 * k + 1] = u.y;
        }
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) T[kk] = 0.0f;
#pragma unroll
        for (int j = 0; j < 6; ++j) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float2 u = h[j * 3 + k];
                T[2 * k] = fmaf(li[j], u.x, T[2 * k]);
                T[2 * k + 1] = fmaf(li[j], u.y, T[2 * k + 1]);
            }
        }
#pragma unroll
        for (int l = 0; l < 6; ++l) {
            float wv = 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                const float2 u = L2[l * 3 + k];
                wv = fmaf(T[2 * k], u.x, wv);
                wv = fmaf(T[2 * k + 1], u.y, wv);
            }
            rs += fabsf(wv);
        }
    }
    for (int o = 16; o > 0; o >>= 1)
        rs = fmaxf(rs, __shfl_xor_sync(0xffffffffu, rs, o));
    if ((t & 31) == 0) swarp[t >> 5] = rs;
    __syncthreads();
    if (t == 0) {
        float best = swarp[0];
#pragma unroll
        for (int k = 1; k < kWarps; ++k) best = fmaxf(best, swarp[k]);
        atomicMax(bound, __float_as_uint(best * 1.02f));
    }
}

}  // namespace

extern "C" int pl_scalar_pencil(
    const void* gp, const void* w, const void* xy, const void* Nref,
    const void* pos, const void* radii, const void* eps_core,
    const void* eps_clad, float k2, const void* valid, const void* Linv,
    float trace_ref, float tiny, int E, int Q, int n_cores, void* A,
    void* B, void* diag, void* eps_out, void* bound, void* stream)
{
    if (E < 1 || Q < 1 || Q > kMaxQ || n_cores < 0)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    cudaError_t rc = cudaMemsetAsync(bound, 0, sizeof(unsigned int), s);
    if (rc != cudaSuccess) return (int)rc;
    scalar_pencil_kernel<<<(E + kElems - 1) / kElems, kThreads, 0, s>>>(
        (const float*)gp, (const float*)w, (const float*)xy,
        (const float*)Nref, (const float*)pos, (const float*)radii,
        (const float*)eps_core, (const float*)eps_clad, k2,
        (const unsigned char*)valid, (const float*)Linv, trace_ref, tiny, E,
        Q, n_cores, (float*)A, (float*)B, (float*)diag, (float*)eps_out,
        (unsigned int*)bound);
    return (int)cudaGetLastError();
}
