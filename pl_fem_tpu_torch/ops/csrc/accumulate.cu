// K2: element -> DOF accumulate through the bounded-valence transpose
// tables, with the optional mask/park epilogue of the operator applies.
//
// Replaces the gather branch of pl_fem_tpu/ops/kernels.py
// _accumulate_fused and the epilogue Y * m + park * (X - X * m) of
// _apply_vector3_fused. On the solver paths it sums the mass diagonal
// (L = 1): the A(beta) apply (apply_vector3.cu), the stacked apply
// (apply_stacked.cu) and the mass apply (mass_apply.cu) sum their own
// rows in the same table order.
//
// Ye is (E * 6, L); DOF rows [0, split) sum up to Wv entries of idx_v,
// rows [split, D) up to 2 entries of idx_e (P2 edge midpoints). Every
// row sums its valid entries in table order, so the result is
// deterministic and needs no atomics.
//
// Bound on the H100: bytes. It reads Ye once (each flat entry belongs to
// exactly one DOF row) and writes Y, plus X when the epilogue is on.
// Work split:
// - L >= 8: one warp owns one DOF row and a tile of its lanes (eight
//   rows per block). The row's indices are read once per warp into
//   shared memory; each thread owns VEC consecutive lanes (float4 when
//   L % 4 == 0, float2 when L % 2 == 0, scalar otherwise, since a row of
//   Ye starts at a multiple of L floats) and issues the loads of four
//   entries before it adds them, so several Ye segments are in flight
//   per thread. Padded entries are not loaded (a warp-uniform
//   predicate) and add nothing.
// - L < 8 (the L = 1 mass diagonal): one thread owns one row and all of
//   its lanes, so a warp covers 32 rows instead of idling 31 lanes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;            // rows per block on the lane path
constexpr int kMaxW = 32;            // vertex table width the warp stages
constexpr int kGroup = 4;            // entries loaded before they are added

struct AccArgs {
    const float* Ye;                 // (E * 6, L)
    const int* idx_v;                // (split, Wv)
    const unsigned char* valid_v;
    const int* idx_e;                // (D - split, 2)
    const unsigned char* valid_e;
    const float* X;                  // (D, L) or null: no epilogue
    const float* mask;               // (D,)
    const float* park;               // (L,)
    float* Y;                        // (D, L)
    int D, split, Wv, L, tile;
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

// the table row of DOF d: its entries and width
__device__ __forceinline__ int table_row(const AccArgs& p, int d,
                                         const int** idx,
                                         const unsigned char** valid)
{
    if (d < p.split) {
        *idx = p.idx_v + (size_t)d * p.Wv;
        *valid = p.valid_v + (size_t)d * p.Wv;
        return p.Wv;
    }
    *idx = p.idx_e + (size_t)(d - p.split) * 2;
    *valid = p.valid_e + (size_t)(d - p.split) * 2;
    return 2;
}

// Y * m + park * (X - X * m), rounded as the plain twin's separate ops
__device__ __forceinline__ float epilogue(float acc, float m, float x,
                                          float pk)
{
    return __fadd_rn(__fmul_rn(acc, m),
                     __fmul_rn(pk, __fsub_rn(x, __fmul_rn(x, m))));
}

template <int VEC>
__global__ void __launch_bounds__(kWarps * 32)
accumulate_lanes_kernel(const AccArgs p)
{
    __shared__ int s_idx[kWarps][kMaxW];     // -1 marks a padded entry
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int d = blockIdx.x * kWarps + warp;
    if (d >= p.D) return;                    // the whole warp leaves
    const int* idx;
    const unsigned char* valid;
    const int W = table_row(p, d, &idx, &valid);
    if (lane < W) s_idx[warp][lane] = valid[lane] ? idx[lane] : -1;
    __syncwarp();
    const int* si = s_idx[warp];

    const int nv = p.L / VEC;
    const int v0 = blockIdx.y * p.tile;
    const int v1 = min(nv, v0 + p.tile);
    const size_t row = (size_t)d * p.L;
    const float m = p.X != nullptr ? p.mask[d] : 0.0f;
    for (int v = v0 + lane; v < v1; v += 32) {
        const size_t l = (size_t)v * VEC;
        float acc[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
        for (int t0 = 0; t0 < W; t0 += kGroup) {
            float y[kGroup][VEC];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                const int f = (t0 + u < W) ? si[t0 + u] : -1;
                if (f >= 0) {
                    load_vec<VEC>(p.Ye + (size_t)f * p.L + l, y[u]);
                } else {
#pragma unroll
                    for (int k = 0; k < VEC; ++k) y[u][k] = 0.0f;
                }
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                if ((t0 + u < W) && si[t0 + u] >= 0) {
#pragma unroll
                    for (int k = 0; k < VEC; ++k)
                        acc[k] = __fadd_rn(acc[k], y[u][k]);
                }
            }
        }
        if (p.X != nullptr) {
            float x[VEC], pk[VEC];
            load_vec<VEC>(p.X + row + l, x);
            load_vec<VEC>(p.park + l, pk);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
                acc[k] = epilogue(acc[k], m, x[k], pk[k]);
        }
        store_vec<VEC>(p.Y + row + l, acc);
    }
}

__global__ void __launch_bounds__(256)
accumulate_rows_kernel(const AccArgs p)
{
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= p.D) return;
    const int* idx;
    const unsigned char* valid;
    const int W = table_row(p, d, &idx, &valid);
    const size_t row = (size_t)d * p.L;
    for (int l = 0; l < p.L; ++l) {
        float acc = 0.0f;
        for (int t0 = 0; t0 < W; t0 += kGroup) {
            float y[kGroup];
#pragma unroll
            for (int u = 0; u < kGroup; ++u) {
                const bool ok = t0 + u < W && valid[t0 + u];
                y[u] = ok ? __ldg(p.Ye + (size_t)idx[t0 + u] * p.L + l) : 0.0f;
            }
#pragma unroll
            for (int u = 0; u < kGroup; ++u)
                if (t0 + u < W && valid[t0 + u]) acc = __fadd_rn(acc, y[u]);
        }
        if (p.X != nullptr)
            acc = epilogue(acc, p.mask[d], p.X[row + l], p.park[l]);
        p.Y[row + l] = acc;
    }
}

template <int VEC>
cudaError_t launch_lanes(AccArgs p, cudaStream_t stream)
{
    // lane tiles of at most 256 vectors, split evenly, whole warps each
    const int nv = p.L / VEC;
    const int ntiles = (nv + 255) / 256;
    p.tile = (((nv + ntiles - 1) / ntiles + 31) / 32) * 32;
    dim3 grid((p.D + kWarps - 1) / kWarps, (nv + p.tile - 1) / p.tile);
    accumulate_lanes_kernel<VEC><<<grid, kWarps * 32, 0, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" int pl_accumulate(
    const void* Ye, const void* idx_v, const void* valid_v,
    const void* idx_e, const void* valid_e, const void* X,
    const void* mask, const void* park, int D, int split, int Wv, int L,
    void* Y, void* stream)
{
    if (D < 1 || L < 1 || split < 0 || split > D || Wv < 0 || Wv > kMaxW)
        return (int)cudaErrorInvalidValue;
    AccArgs p;
    p.Ye = (const float*)Ye;
    p.idx_v = (const int*)idx_v;
    p.valid_v = (const unsigned char*)valid_v;
    p.idx_e = (const int*)idx_e;
    p.valid_e = (const unsigned char*)valid_e;
    p.X = (const float*)X;
    p.mask = (const float*)mask;
    p.park = (const float*)park;
    p.Y = (float*)Y;
    p.D = D;
    p.split = split;
    p.Wv = Wv;
    p.L = L;
    p.tile = 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (L < 8) {
        accumulate_rows_kernel<<<(D + 255) / 256, 256, 0, s>>>(p);
        return (int)cudaGetLastError();
    }
    if (L % 4 == 0) return (int)launch_lanes<4>(p, s);
    if (L % 2 == 0) return (int)launch_lanes<2>(p, s);
    return (int)launch_lanes<1>(p, s);
}
