// K3: the masked consistent P2 mass apply, DOF-centric, with one step of
// the Chebyshev B^{-1} semi-iteration as its optional epilogue.
//
// Replaces pl_fem_tpu/ops/kernels.py _apply_mass_fused (:605) and the
// loop body of _apply_binv_fused (:640).
//
// Plain mode (y = M~ x, the Rayleigh-Ritz tail's B Q):
//     y = m * M (m * x) + park * (x - m * x)
// Step mode (one degree step, s = ds the Jacobi scale, park = 1):
//     V  = first ? (s * W) / theta : Dd        (R0 = s W, Dd0 = R0 / theta;
//                                               / theta as x * (1 / theta))
//     R' = (first ? s * W : R) - s * M~(s * V)
//     Z' = (first ? 0 : Z) + V
//     D' = a * V + b * R'
//     last ? out = s * (Z' + D') : (R = R', Z = Z', out = D')
// so a B^{-1} apply of degree d is d launches; at degree 1 it reads W
// once and writes the result once.
//
// M (m * x) at DOF row d is the sum over the row's transpose-table
// entries (e, i), in table order, of sum_j C_ij(e) u(dof(e, j)) with
// C_ij(e) = sum_q w[e, q] N[q, i] N[q, j]: the summation order of the
// plain twin (an element pass, then the accumulate), with no (E, 6, L)
// intermediate, no atomics and bitwise repeatable results.
//
// Bound on the H100: bytes. Plain mode reads X and writes Y (two (D, L)
// f32 arrays) plus the tables; step mode at degree 1 reads W and writes
// the result; a middle step reads Dd, R, Z and writes R, Z, Dd.
//
// Design. The rows make ~18 row gathers each (a vertex row's ~6
// elements times 6 nodes), so gathering from device memory row by row
// is bound by L2 traffic and latency. Instead each block owns
// kRows = 32 rows of a Morton (Z-curve) walk of the DOF coordinates:
// a compact patch of the mesh whose gathered rows, its halo, number
// about 2.6 per owned row (the per-grid plan, ops/assembly.py
// mass_plan). Per chunk of 64 lanes the block loads each halo row once,
// coalesced, applies the operand transform (mask, Jacobi scale, the
// first step's 1 / theta) once per value, and keeps the chunk in shared
// memory; the owned rows then sum their entries from there. The
// entries' coefficients and halo offsets are staged once per block,
// and each thread keeps kBatch halo loads in flight while staging.
// Consecutive blocks cover neighbouring patches, so the halos the
// blocks in flight share stay in L2 and device memory sees X about
// once. Each thread owns VEC consecutive lanes of one row (float4 when
// L % 4 == 0, float2 when L % 2 == 0, scalar otherwise: a row at
// dof * L is only aligned to 4 * gcd(L, 4) bytes).

#include <cuda_runtime.h>

#include "shared_limit.cuh"

namespace {

constexpr int kRows = 32;            // DOF rows per block (the plan's)
constexpr int kThreads = 256;
constexpr int kChunk = 64;           // lanes staged per pass
constexpr int kBatch = 8;            // halo loads a thread issues at once
constexpr int kLanes = 4;            // lanes a thread sums (a float4 of s_x)
constexpr int kMaxQ = 16;

struct MassArgs {
    const float* X;            // (D, L): x, W (first step) or Dd
    const float* w;            // (E, Q)
    const float* Nref;         // (Q, 6)
    const int* order;          // (D,) the plan's row walk
    const int* halo;           // (NB, H)
    const int* n_halo;         // (NB,)
    const int* row_ptr;        // (NB * kRows + 1,)
    const int* ent;            // (n_entries,) flat e * 6 + i
    const short* loc;          // (n_entries, 6) halo slots
    const float* mask;         // (D,)
    const float* ds;           // (D,) step mode only
    float* R;                  // (D, L) step mode, in place
    float* Z;                  // (D, L) step mode, in place
    float* out;                // (D, L)
    float park, a, b, theta;
    int D, H, max_ent, Q, L, tile;
    bool step, first, last;
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[VEC])
{
    if constexpr (VEC == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    } else if constexpr (VEC == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        r[0] = t.x; r[1] = t.y;
    } else {
        r[0] = __ldg(p);
    }
}

// a VEC-vector that this thread alone reads and writes (R, Z; shared
// memory)
template <int VEC>
__device__ __forceinline__ void load_own(const float* p, float (&r)[VEC])
{
    if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    } else if constexpr (VEC == 2) {
        const float2 t = *reinterpret_cast<const float2*>(p);
        r[0] = t.x; r[1] = t.y;
    } else {
        r[0] = *p;
    }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[VEC])
{
    if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
    } else if constexpr (VEC == 2) {
        *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
    } else {
        *p = r[0];
    }
}

// A thread's kLanes consecutive lanes of a global row at p (lane l), as
// kLanes / VEC VEC-vectors; vectors at or past lane1 read as 0 and are
// not stored. RO: read-only for the kernel's lifetime (X), else a
// buffer this thread also writes (R, Z).
template <int VEC, bool RO>
__device__ __forceinline__ void load_lanes(const float* p, int l, int lane1,
                                           float (&r)[kLanes])
{
#pragma unroll
    for (int m = 0; m < kLanes / VEC; ++m) {
        float t[VEC];
        if (l + m * VEC < lane1) {
            if constexpr (RO) load_vec<VEC>(p + m * VEC, t);
            else load_own<VEC>(p + m * VEC, t);
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) t[k] = 0.0f;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) r[m * VEC + k] = t[k];
    }
}

template <int VEC>
__device__ __forceinline__ void store_lanes(float* p, int l, int lane1,
                                            const float (&r)[kLanes])
{
#pragma unroll
    for (int m = 0; m < kLanes / VEC; ++m) {
        if (l + m * VEC >= lane1) break;
        float t[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[k] = r[m * VEC + k];
        store_vec<VEC>(p + m * VEC, t);
    }
}

// The gathered operand of a halo row with mask m and Jacobi scale s:
// OP 0 plain m x, OP 1 a step's m (s Dd), OP 2 the first step's
// m (s (s W / theta)); rounded as the plain twin's separate ops.
template <int OP>
__device__ __forceinline__ float operand(float x, float m, float s,
                                         float inv_theta)
{
    if constexpr (OP == 1) x = __fmul_rn(s, x);
    if constexpr (OP == 2)
        x = __fmul_rn(s, __fmul_rn(__fmul_rn(s, x), inv_theta));
    return __fmul_rn(x, m);
}

template <int VEC, int OP>
__global__ void __launch_bounds__(kThreads)
mass_apply_kernel(const MassArgs p)
{
    constexpr int SPR = kChunk / VEC;         // staging threads per row
    constexpr int TPR = kChunk / kLanes;      // summing threads per row
    constexpr int RPP = kThreads / TPR;       // rows summed per pass
    extern __shared__ float4 smem4[];
    // (max_ent * 6) pairs (C_ij, offset of the halo row's chunk in s_x)
    float2* s_cx = reinterpret_cast<float2*>(smem4);
    float* s_x = reinterpret_cast<float*>(s_cx + p.max_ent * 6);
                                                       // (H, kChunk)
    float* s_hm = s_x + p.H * kChunk;                  // (H,) halo mask
    float* s_hs = s_hm + p.H;                          // (H,) halo ds
    int* s_hg = reinterpret_cast<int*>(s_hs + p.H);    // (H,) halo rows
    __shared__ int s_ptr[kRows + 1];
    __shared__ int s_d[kRows];
    __shared__ float s_md[kRows], s_sd[kRows];

    const int tid = threadIdx.x;
    const int blk = blockIdx.x;
    const int p0 = blk * kRows;
    const int nh = p.n_halo[blk];
    if (tid <= kRows) s_ptr[tid] = p.row_ptr[p0 + tid];
    if (tid < kRows) {
        const int d = p0 + tid < p.D ? p.order[p0 + tid] : 0;
        s_d[tid] = d;
        s_md[tid] = p.mask[d];
        s_sd[tid] = p.step ? p.ds[d] : 1.0f;
    }
    for (int h = tid; h < nh; h += kThreads) {
        const int g = p.halo[(size_t)blk * p.H + h];
        s_hg[h] = g;
        s_hm[h] = p.mask[g];
        s_hs[h] = p.step ? p.ds[g] : 1.0f;
    }
    __syncthreads();
    const int e0 = s_ptr[0];
    const int ne = s_ptr[kRows] - e0;
    for (int t = tid; t < 6 * ne; t += kThreads) {
        const int k = t / 6;
        const int j = t - 6 * k;
        const int f = p.ent[e0 + k];
        const int e = f / 6;
        const int i = f - 6 * e;
        float c = 0.0f;
        for (int q = 0; q < p.Q; ++q)
            c = fmaf(p.Nref[q * 6 + i] * p.Nref[q * 6 + j],
                     p.w[(size_t)e * p.Q + q], c);
        s_cx[t] = make_float2(
            c, __int_as_float(p.loc[(size_t)e0 * 6 + t] * kChunk));
    }

    const float inv_theta = 1.0f / p.theta;      // as torch's x / theta
    const int lane0 = blockIdx.y * p.tile;
    const int lane1 = min(p.L, lane0 + p.tile);
    const int v = tid % TPR;
    for (int c0 = lane0; c0 < lane1; c0 += kChunk) {
        __syncthreads();        // tables staged / the last chunk's sums done
        // kBatch loads in flight per thread before any is stored
        for (int t0 = tid; t0 < nh * SPR; t0 += kBatch * kThreads) {
            float x[kBatch][VEC];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int t = t0 + u * kThreads;
                const int h = t / SPR;
                const int lh = c0 + (t - h * SPR) * VEC;
                if (t < nh * SPR && lh < lane1) {
                    load_vec<VEC>(p.X + (size_t)s_hg[h] * p.L + lh, x[u]);
                } else {
#pragma unroll
                    for (int k = 0; k < VEC; ++k) x[u][k] = 0.0f;
                }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int t = t0 + u * kThreads;
                if (t >= nh * SPR) break;
                const int h = t / SPR;
                const float m = s_hm[h], s = s_hs[h];
#pragma unroll
                for (int k = 0; k < VEC; ++k)
                    x[u][k] = operand<OP>(x[u][k], m, s, inv_theta);
                store_vec<VEC>(s_x + h * kChunk + (t - h * SPR) * VEC, x[u]);
            }
        }
        __syncthreads();

        const int l = c0 + v * kLanes;
        if (l >= lane1) continue;
        for (int r = tid / TPR; r < kRows; r += RPP) {
            if (p0 + r >= p.D) break;
            // the epilogue's own-row operands, issued before the sum
            const size_t o = (size_t)s_d[r] * p.L + l;
            float xo[kLanes], rr[kLanes], zz[kLanes];
            load_lanes<VEC, true>(p.X + o, l, lane1, xo);
            if constexpr (OP == 1) {
                load_lanes<VEC, false>(p.R + o, l, lane1, rr);
                load_lanes<VEC, false>(p.Z + o, l, lane1, zz);
            }
            float acc[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
            const float4* cx = reinterpret_cast<const float4*>(s_cx);
            for (int k3 = 3 * (s_ptr[r] - e0); k3 < 3 * (s_ptr[r + 1] - e0);
                 k3 += 3) {
                float ye[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int jj = 0; jj < 3; ++jj) {
                    const float4 c2 = cx[k3 + jj];    // pairs j = 2jj, 2jj + 1
                    const float4 u0 = *reinterpret_cast<const float4*>(
                        s_x + __float_as_int(c2.y) + v * kLanes);
                    const float4 u1 = *reinterpret_cast<const float4*>(
                        s_x + __float_as_int(c2.w) + v * kLanes);
                    ye[0] = fmaf(c2.x, u0.x, ye[0]);
                    ye[1] = fmaf(c2.x, u0.y, ye[1]);
                    ye[2] = fmaf(c2.x, u0.z, ye[2]);
                    ye[3] = fmaf(c2.x, u0.w, ye[3]);
                    ye[0] = fmaf(c2.z, u1.x, ye[0]);
                    ye[1] = fmaf(c2.z, u1.y, ye[1]);
                    ye[2] = fmaf(c2.z, u1.z, ye[2]);
                    ye[3] = fmaf(c2.z, u1.w, ye[3]);
                }
#pragma unroll
                for (int k = 0; k < kLanes; ++k)
                    acc[k] = __fadd_rn(acc[k], ye[k]);
            }

            const float md = s_md[r];
            const float sd = s_sd[r];
            float y[kLanes];
            if constexpr (OP == 0) {
#pragma unroll
                for (int k = 0; k < kLanes; ++k)
                    y[k] = __fadd_rn(__fmul_rn(acc[k], md),
                                     __fmul_rn(p.park, __fsub_rn(
                                         xo[k], __fmul_rn(xo[k], md))));
                store_lanes<VEC>(p.out + o, l, lane1, y);
                continue;
            }
            float V[kLanes];
            if constexpr (OP == 2) {
#pragma unroll
                for (int k = 0; k < kLanes; ++k) {
                    rr[k] = __fmul_rn(sd, xo[k]);
                    V[k] = __fmul_rn(rr[k], inv_theta);
                    zz[k] = 0.0f;
                }
            } else {
#pragma unroll
                for (int k = 0; k < kLanes; ++k) V[k] = xo[k];
            }
#pragma unroll
            for (int k = 0; k < kLanes; ++k) {
                const float vs = __fmul_rn(sd, V[k]);
                const float my = __fadd_rn(__fmul_rn(acc[k], md),
                                           __fsub_rn(vs, __fmul_rn(vs, md)));
                rr[k] = __fsub_rn(rr[k], __fmul_rn(sd, my));
                zz[k] = __fadd_rn(zz[k], V[k]);
                y[k] = __fadd_rn(__fmul_rn(p.a, V[k]), __fmul_rn(p.b, rr[k]));
            }
            if (p.last) {
#pragma unroll
                for (int k = 0; k < kLanes; ++k)
                    y[k] = __fmul_rn(sd, __fadd_rn(zz[k], y[k]));
            } else {
                store_lanes<VEC>(p.R + o, l, lane1, rr);
                store_lanes<VEC>(p.Z + o, l, lane1, zz);
            }
            store_lanes<VEC>(p.out + o, l, lane1, y);
        }
    }
}

template <int VEC, int OP>
cudaError_t launch_op(const MassArgs& p, dim3 grid, size_t shmem,
                      cudaStream_t stream)
{
    const cudaError_t err = set_shared_limit(
        mass_apply_kernel<VEC, OP>);
    if (err != cudaSuccess) return err;
    mass_apply_kernel<VEC, OP><<<grid, kThreads, shmem, stream>>>(p);
    return cudaGetLastError();
}

template <int VEC>
cudaError_t launch(const MassArgs& p, cudaStream_t stream)
{
    const int nb = (p.D + kRows - 1) / kRows;
    dim3 grid(nb, (p.L + p.tile - 1) / p.tile);
    const size_t shmem = sizeof(float2) * 6 * p.max_ent
        + sizeof(float) * p.H * (kChunk + 2) + sizeof(int) * p.H;
    if (!p.step) return launch_op<VEC, 0>(p, grid, shmem, stream);
    if (!p.first) return launch_op<VEC, 1>(p, grid, shmem, stream);
    return launch_op<VEC, 2>(p, grid, shmem, stream);
}

}  // namespace

// flags: bit 0 step mode, bit 1 first step, bit 2 last step.
extern "C" int pl_mass_apply(
    const void* X, const void* w, const void* Nref,
    const void* order, const void* halo, const void* n_halo,
    const void* row_ptr, const void* ent, const void* loc, const void* mask,
    const void* ds, void* R, void* Z, void* out, float park, float a,
    float b, float theta, int D, int H, int max_ent, int Q, int L,
    int flags, void* stream)
{
    if (D < 1 || L < 1 || Q < 1 || Q > kMaxQ || H < 1 || H > 32767
        || max_ent < 1
        || (8 * 6 * max_ent + 4 * (kChunk + 3) * H) > 200 * 1024)
        return (int)cudaErrorInvalidValue;
    MassArgs p;
    p.X = (const float*)X;
    p.w = (const float*)w;
    p.Nref = (const float*)Nref;
    p.order = (const int*)order;
    p.halo = (const int*)halo;
    p.n_halo = (const int*)n_halo;
    p.row_ptr = (const int*)row_ptr;
    p.ent = (const int*)ent;
    p.loc = (const short*)loc;
    p.mask = (const float*)mask;
    p.ds = (const float*)ds;
    p.R = (float*)R;
    p.Z = (float*)Z;
    p.out = (float*)out;
    p.park = park;
    p.a = a;
    p.b = b;
    p.theta = theta;
    p.D = D;
    p.H = H;
    p.max_ent = max_ent;
    p.Q = Q;
    p.L = L;
    p.step = (flags & 1) != 0;
    p.first = (flags & 2) != 0;
    p.last = (flags & 4) != 0;
    if (p.step && (ds == nullptr
                   || (!(p.first && p.last) && (R == nullptr || Z == nullptr))))
        return (int)cudaErrorInvalidValue;
    // lane tiles of at most 1024 lanes, split evenly, whole chunks each
    const int ntiles = (L + 1023) / 1024;
    p.tile = (((L + ntiles - 1) / ntiles + kChunk - 1) / kChunk) * kChunk;
    const cudaStream_t s = (cudaStream_t)stream;
    if (L % 4 == 0) return (int)launch<4>(p, s);
    if (L % 2 == 0) return (int)launch<2>(p, s);
    return (int)launch<1>(p, s);
}
