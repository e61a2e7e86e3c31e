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
//
// The vectorial sweep's K8 (pl_pencil_bounds_vector3) bounds A(beta_b)
// of all B designs of a sweep from the quadrature data, without the
// twelve (E, 6, 6) primitives or the (E, 18, 18) stack in device memory:
//
//   bound_b = 1.02 * max_e max_i sum_l |Linv3 (A_e(beta_b) / |detJ|_e)
//                                       Linv3^T|_il|,
//
// A_e(beta) the 3 x 3 component blocks of pl_fem_tpu/ops/assembly.py
// combine_vector3 over the primitives of vector3_primitives, and
// |detJ|_e the trace of u_nn over the reference trace, floored and set
// to 1 on padded elements as above. Replaces, per sweep, the reference's
// per-design loop of assemble_vector3_system, vector3_stacked_A and
// pencil_bounds_elem (pl_fem_tpu/solvers/vectorial.py:648-664).
//
// The congruence is linear, so it is applied to the basis first: with
// a~_q = Linv a_q for a = dN/dx, dN/dy, N at each quadrature point,
// Linv P_ab Linv^T = sum_q c_q a~_q b~_q^T for every primitive P_ab, and
// W_e is combine_vector3's combination of the primitives of the
// transformed basis, over |detJ|_e. No 18 x 18 block is formed.
//
// A block owns kVecElems elements. It stages their gradients, weights
// and the shape table in shared memory, transforms the basis (Linv,
// 6 x 6, applied to 3 Q vectors per element) and forms the six
// design-independent u primitives once. A thread owns one row (c1, i)
// of one element's W, c1 the same across a warp. For every design b the
// w / eps weights of the block's elements go to shared memory, and each
// thread sums the four i primitives its row needs (over the Q points,
// for all six columns j), combines them with the u primitives, beta_b
// and alpha into the row's 18 entries and takes their absolute sum over
// |detJ|_e; a warp and then the block take the maximum, one partial per
// (design, block). A second launch reduces the partials of each design
// in a fixed order: no float atomics, so the result is bit for bit
// repeatable.
//
// Bound on the H100: f32 operations. Per (element, design) the 171
// distinct i-primitive entries of the transformed basis (6 x 6 for
// S_xy, S_nx, S_ny; the symmetric S_xx, S_yy, S_nn 21 each), 2 Q each,
// and the 324 entries' combination and absolute sums; per element the
// basis transform and the u primitives. Against 4 * 13 Q bytes per
// element (gradients, weights) and 4 Q per element and design (1/eps).
// The rows' sums repeat the symmetric primitives
// (4 sums per column and row: 432 against 171), the price of keeping a
// row's entries in one thread's registers.

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

// Block b reduces the n partials of row b (one row per design).
__global__ void __launch_bounds__(kReduceThreads)
pencil_max_kernel(const float* __restrict__ partial, int n,
                  float* __restrict__ out)
{
    __shared__ float s[kReduceThreads];
    const float* p = partial + (size_t)blockIdx.x * n;
    float best = 0.0f;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        best = fmaxf(best, p[i]);
    s[threadIdx.x] = best;
    __syncthreads();
    for (int h = kReduceThreads / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h)
            s[threadIdx.x] = fmaxf(s[threadIdx.x], s[threadIdx.x + h]);
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = s[0] * 1.02f;
}

constexpr int kVecElems = 16;                  // elements per block
constexpr int kVecThreads = kVecElems * 18;    // a thread per row (c1, i)
constexpr int kVecMaxQ = 8;

// The three kinds of row. A thread owns row (c1, i) of W_e for one
// element; v points at the element's transformed vectors (per q: x~, y~,
// n~, 6 each), u at its transformed u primitives, c at its w / eps.
// With S_ab(i, j) = sum_q c_q a~_qi b~_qj and U likewise with w_q, the
// entries of W_e |detJ|_e are combine_vector3's, block (c1, c2):
//   c1 = 0: S_yy + a U_xx + b2 S_nn | -S_yx + a U_xy | b (-S_nx - a U_nx^T)
//   c1 = 1: -S_xy + a U_xy^T | S_xx + a U_yy + b2 S_nn | b (-S_ny - a U_ny^T)
//   c1 = 2: b (-S_xn - a U_nx) | b (-S_yn - a U_ny) | S_xx + S_yy + b2 a U_nn
// (T: the transposed primitive). Returns the row's absolute sum.
template <int C1>
__device__ __forceinline__ float vector3_row(
    const float* __restrict__ v, const float* __restrict__ u,
    const float* __restrict__ c, int Q, int i, float alpha, float beta,
    float b2, float b2a)
{
    constexpr int X = 0, Y = 6, N = 12;          // offsets of x~, y~, n~
    constexpr int P0 = C1 == 0 ? Y : X;          // the two i-side vectors
    constexpr int P1 = C1 == 2 ? Y : N;
    float s0[6], s1[6], s2[6], s3[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) s0[j] = s1[j] = s2[j] = s3[j] = 0.0f;
    for (int q = 0; q < Q; ++q) {
        const float* vq = v + q * 18;
        const float c0 = c[q] * vq[P0 + i];
        const float c1 = c[q] * vq[P1 + i];
#pragma unroll
        for (int j = 0; j < 6; ++j) {
            const float xj = vq[X + j], yj = vq[Y + j], nj = vq[N + j];
            if (C1 == 0) {        // c0 = c y~_i, c1 = c n~_i
                s0[j] = fmaf(c0, yj, s0[j]);     // S_yy
                s1[j] = fmaf(c1, nj, s1[j]);     // S_nn
                s2[j] = fmaf(c0, xj, s2[j]);     // S_yx
                s3[j] = fmaf(c1, xj, s3[j]);     // S_nx
            } else if (C1 == 1) { // c0 = c x~_i, c1 = c n~_i
                s0[j] = fmaf(c0, yj, s0[j]);     // S_xy
                s1[j] = fmaf(c0, xj, s1[j]);     // S_xx
                s2[j] = fmaf(c1, nj, s2[j]);     // S_nn
                s3[j] = fmaf(c1, yj, s3[j]);     // S_ny
            } else {              // c0 = c x~_i, c1 = c y~_i
                s0[j] = fmaf(c0, nj, s0[j]);     // S_xn
                s1[j] = fmaf(c1, nj, s1[j]);     // S_yn
                s2[j] = fmaf(c0, xj, s2[j]);     // S_xx
                s3[j] = fmaf(c1, yj, s3[j]);     // S_yy
            }
        }
    }
    // u: kinds xx, yy, nn, xy, nx, ny, each 6 x 6 row-major
    const float* uxx = u;
    const float* uyy = u + 36;
    const float* unn = u + 72;
    const float* uxy = u + 108;
    const float* unx = u + 144;
    const float* uny = u + 180;
    float rs = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
        const int ij = i * 6 + j, ji = j * 6 + i;
        if (C1 == 0) {
            rs += fabsf((s0[j] + alpha * uxx[ij]) + b2 * s1[j]);
            rs += fabsf(-s2[j] + alpha * uxy[ij]);
            rs += fabsf(beta * (-s3[j] - alpha * unx[ji]));
        } else if (C1 == 1) {
            rs += fabsf(-s0[j] + alpha * uxy[ji]);
            rs += fabsf((s1[j] + alpha * uyy[ij]) + b2 * s2[j]);
            rs += fabsf(beta * (-s3[j] - alpha * uny[ji]));
        } else {
            rs += fabsf(beta * (-s0[j] - alpha * unx[ij]));
            rs += fabsf(beta * (-s1[j] - alpha * uny[ij]));
            rs += fabsf((s2[j] + s3[j]) + b2a * unn[ij]);
        }
    }
    return rs;
}

__global__ void __launch_bounds__(kVecThreads)
pencil_rows_vector3_kernel(const float* __restrict__ gp,      // (E, Q, 6, 2)
                           const float* __restrict__ w,       // (E, Q)
                           const float* __restrict__ Nref,    // (Q, 6)
                           const float* __restrict__ inv_eps, // (B, E, Q)
                           const float* __restrict__ betas,   // (B,)
                           float alpha,
                           const unsigned char* __restrict__ valid,  // (E,)
                           const float* __restrict__ Linv,    // (6, 6)
                           float trace_ref, float tiny, int E, int Q, int B,
                           float* __restrict__ partial)       // (B, blocks)
{
    constexpr int G = kVecElems;
    __shared__ float sgp[G * kVecMaxQ * 12];
    __shared__ float sw[G * kVecMaxQ];
    __shared__ float sc[G * kVecMaxQ];     // w / eps of the design at hand
    __shared__ float sN[kVecMaxQ * 6];
    __shared__ float sL[36];
    __shared__ float sdet[G];
    __shared__ float sv[G * kVecMaxQ * 18];  // Linv gx, Linv gy, Linv N
    __shared__ float su[G * 216];            // the six u primitives
    __shared__ float swarp[kVecThreads / 32];

    const int t = threadIdx.x;
    const int e0 = blockIdx.x * G;
    const int ne = min(G, E - e0);
    for (int k = t; k < ne * Q * 12; k += blockDim.x)
        sgp[k] = gp[(size_t)e0 * Q * 12 + k];
    for (int k = t; k < ne * Q; k += blockDim.x)
        sw[k] = w[(size_t)e0 * Q + k];
    for (int k = t; k < Q * 6; k += blockDim.x) sN[k] = Nref[k];
    if (t < 36) sL[t] = Linv[t];
    __syncthreads();
    if (t < ne) {
        // |detJ|_e: the trace of u_nn (untransformed) over the reference
        float tr = 0.0f;
        for (int i = 0; i < 6; ++i) {
            float d = 0.0f;
            for (int q = 0; q < Q; ++q) {
                const float n = sN[q * 6 + i];
                d = fmaf(sw[t * Q + q] * n, n, d);
            }
            tr += d;
        }
        sdet[t] = valid[e0 + t] ? fmaxf(tr / trace_ref, tiny) : 1.0f;
    }
    // the congruence on the basis: a~_q = Linv a_q for a = gx, gy, N
    for (int k = t; k < ne * Q * 18; k += blockDim.x) {
        const int eq = k / 18;              // el * Q + q
        const int ci = k - 18 * eq;
        const int comp = ci / 6;
        const int i = ci - 6 * comp;
        const int q = eq % Q;
        float a = 0.0f;
#pragma unroll
        for (int m = 0; m < 6; ++m) {
            const float raw = comp == 2 ? sN[q * 6 + m]
                                        : sgp[eq * 12 + 2 * m + comp];
            a = fmaf(sL[i * 6 + m], raw, a);
        }
        sv[k] = a;
    }
    __syncthreads();
    // the design-independent u primitives in that basis (read after the
    // first barrier of the design loop)
    for (int k = t; k < ne * 216; k += blockDim.x) {
        const int el = k / 216;
        const int r = k - 216 * el;
        const int kind = r / 36;
        const int i = (r - 36 * kind) / 6;
        const int j = r - 36 * kind - 6 * i;
        // kinds xx, yy, nn, xy, nx, ny: offsets of (a~, b~) in a q's 18
        const int oa = kind == 0 || kind == 3 ? 0 : (kind == 1 ? 6 : 12);
        const int ob = kind == 0 || kind == 4 ? 0
                     : (kind == 1 || kind == 3 || kind == 5 ? 6 : 12);
        float acc = 0.0f;
        for (int q = 0; q < Q; ++q) {
            const float* vq = sv + (el * Q + q) * 18;
            acc = fmaf(sw[el * Q + q] * vq[oa + i], vq[ob + j], acc);
        }
        su[k] = acc;
    }

    // this thread's row (c1, i) of element el; c1 is uniform per warp
    const int c1 = t / (G * 6);
    const int el = (t - c1 * G * 6) / 6;
    const int i = t - c1 * G * 6 - 6 * el;
    const bool own = el < ne;
    const float* v = sv + el * Q * 18;
    const float* u = su + el * 216;
    const float* c = sc + el * Q;
    for (int b = 0; b < B; ++b) {
        const float* ie = inv_eps + ((size_t)b * E + e0) * Q;
        for (int k = t; k < ne * Q; k += blockDim.x) sc[k] = sw[k] * ie[k];
        __syncthreads();
        float rs = 0.0f;
        if (own) {
            const float beta = betas[b];
            const float b2 = beta * beta;
            const float b2a = b2 * alpha;
            if (c1 == 0)
                rs = vector3_row<0>(v, u, c, Q, i, alpha, beta, b2, b2a);
            else if (c1 == 1)
                rs = vector3_row<1>(v, u, c, Q, i, alpha, beta, b2, b2a);
            else
                rs = vector3_row<2>(v, u, c, Q, i, alpha, beta, b2, b2a);
            rs = valid[e0 + el] ? rs / sdet[el] : 0.0f;
        }
        for (int o = 16; o > 0; o >>= 1)
            rs = fmaxf(rs, __shfl_xor_sync(0xffffffffu, rs, o));
        if ((t & 31) == 0) swarp[t >> 5] = rs;
        __syncthreads();
        if (t == 0) {
            float best = 0.0f;
            for (int k = 0; k < kVecThreads / 32; ++k)
                best = fmaxf(best, swarp[k]);
            partial[(size_t)b * gridDim.x + blockIdx.x] = best;
        }
    }
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

// The partial array of pl_pencil_bounds_vector3 must hold B times
// pl_pencil_bounds_vector3_blocks(E) floats.
extern "C" int pl_pencil_bounds_vector3_blocks(int E)
{
    return (E + kVecElems - 1) / kVecElems;
}

extern "C" int pl_pencil_bounds_vector3(
    const void* gp, const void* w, const void* Nref, const void* inv_eps,
    const void* betas, float alpha, const void* valid, const void* Linv,
    float trace_ref, float tiny, int E, int Q, int B, void* partial,
    void* out, void* stream)
{
    if (E < 1 || Q < 1 || Q > kVecMaxQ || B < 1)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int nb = pl_pencil_bounds_vector3_blocks(E);
    pencil_rows_vector3_kernel<<<nb, kVecThreads, 0, s>>>(
        (const float*)gp, (const float*)w, (const float*)Nref,
        (const float*)inv_eps, (const float*)betas, alpha,
        (const unsigned char*)valid, (const float*)Linv, trace_ref, tiny, E,
        Q, B, (float*)partial);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    pencil_max_kernel<<<B, kReduceThreads, 0, s>>>((const float*)partial,
                                                   nb, (float*)out);
    return (int)cudaGetLastError();
}

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
