// K10: the Rayleigh-Ritz residual norms and the pass gate of the
// Chebyshev-filter eigensolvers,
//
//   res[b, l] = ||(AQ_b - theta_bl BQ_b) Ys_b[:, l]||
//               / (||AQ_b Ys_b[:, l]|| + 1e-30),
//   gate      = max of res over the wanted (b, l), or min(res) if none,
//
// over all rows of design b of the fused blocks AQ, BQ (D, B, C, k):
// row (d, c) of design b starts at ((d * B + b) * C + c) * k. A column
// is wanted where theta_bl < cuts_b and, when n_wanted > 0, l <
// n_wanted. Replaces the tail of pl_fem_tpu/ops/kernels.py
// cheb_sweep_rr_impl (the Ritz blocks AXr = AQ Ys, BXr = BQ Ys, R = AXr
// - BXr theta as three (3D, B, k) arrays and their column norms) and
// _sweep_gate_maxres (a jitted reduction to one scalar), which the port
// ran as torch ops with two host reads per pass. The stacked solver's
// pass (C = 1, one design) uses it too.
//
// First launch: a block owns one design b and a run of node tiles. Ys_b
// (k x k, columns padded with zeros to a multiple of 8) and theta_b sit
// in shared memory. A tile is 32 nodes, the C rows of each (C k
// contiguous floats of AQ_b and of BQ_b), staged in shared memory by
// whole rows with an odd row stride, so no index is divided at run time
// and the lanes hit distinct banks; warp g owns Ritz columns 8g .. 8g +
// 7, lane i node i, and forms u = AQ row . Ys, v = BQ row . Ys for its C
// rows and 8 columns (16 C FMAs per k step, Ys read as two broadcast
// float4). The tiles are staged with asynchronous copies into two
// buffers, the next tile's in flight while this one is summed. The
// rows' R = u - theta v and u are squared into sums that the thread
// carries across the block's tiles (a few rows each, f32); at the end
// the warp sums its 32 lanes in f64 in a fixed butterfly order and
// writes one partial per (design, block, column). AXr, BXr and R never reach device memory.
// Second launch, one block: a warp per (b, l) sums its partials (lane q
// takes blocks q, q + 32, ..., then a fixed butterfly) in f64 and writes
// res, and the block reduces the gate (NaN propagates, as in the
// reference's max and min). No float atomics: the result repeats bit
// for bit. C is 1 (the stacked solver's block as one design) or 3; k
// is at most 96 (two tiles of 96 rows in shared memory).
//
// Bound on the H100: bytes (AQ and BQ read once, 8 C D B k bytes) at
// k = 22; at k = 42 the 4 k^2 + 6 k operations per row and design
// (u and v are 2 k^2 FMAs) just pass the byte time (0.247 against 0.234
// ms at the r5 shape). The design reads each AQ / BQ element once from
// device memory and k / 8 times from shared memory, and spends 2 C + 2
// shared loads per 16 C FMAs.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>

#include "shared_limit.cuh"

namespace {

constexpr int kTileD = 32;          // nodes per tile: a lane each
constexpr int kCols = 8;            // Ritz columns per thread
constexpr int kMaxK = 96;           // two tiles of 96 rows fit at C = 3
constexpr int kTargetBlocks = 2048; // first launch, over all designs
constexpr int kReduceThreads = 1024;

__host__ __device__ inline int groups_of(int k)
{
    return (k + kCols - 1) / kCols;
}

inline long tiles_of(int D)
{
    return ((long)D + kTileD - 1) / kTileD;
}

// Node tiles per block: about kTargetBlocks blocks over all designs.
inline long tiles_per_block(int D, int B)
{
    const long per = (tiles_of(D) * B + kTargetBlocks - 1) / kTargetBlocks;
    return per < 1 ? 1 : per;
}

inline size_t shared_bytes(int C, int k)
{
    const int kp = groups_of(k) * kCols;
    return sizeof(float)
           * ((size_t)k * kp + kp + 4 * (size_t)kTileD * C * (k | 1));
}

// Stage the tile of nodes d0 .. d0 + 31 of design b (rows of AQ into sa,
// of BQ into sb) with asynchronous copies, zeros past d_end, and commit
// them as one group. Warp w takes nodes w, w + nwarps, ...
template <int C>
__device__ __forceinline__ void stage_tile(
    float* sa, float* sb, const float* __restrict__ AQ,
    const float* __restrict__ BQ, long d0, long d_end, size_t node_stride,
    size_t boff, int k, int ld, int warp, int lane, int nwarps)
{
    for (int dd = warp; dd < kTileD; dd += nwarps) {
        const long d = d0 + dd;
        const size_t o = (size_t)d * node_stride + boff;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            float* ra = sa + (dd * C + c) * ld;
            float* rb = sb + (dd * C + c) * ld;
            for (int m = lane; m < k; m += 32) {
                if (d < d_end) {
                    __pipeline_memcpy_async(ra + m, AQ + o + c * k + m, 4);
                    __pipeline_memcpy_async(rb + m, BQ + o + c * k + m, 4);
                } else {
                    ra[m] = 0.0f;
                    rb[m] = 0.0f;
                }
            }
        }
    }
    __pipeline_commit();
}

template <int C>
__global__ void __launch_bounds__(kMaxK / kCols * 32)
ritz_rows_kernel(const float* __restrict__ AQ,     // (D, B, C, k)
                 const float* __restrict__ BQ,     // (D, B, C, k)
                 const float* __restrict__ Ys,     // (B, k, k)
                 const float* __restrict__ theta,  // (B, k)
                 int D, int B, int k, long tiles,
                 double* __restrict__ partial)     // (B, blocks, 2, k)
{
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    const int nt = blockDim.x;
    const int kp = nt / 32 * kCols;              // k padded to the groups
    const int ld = k | 1;                        // odd row stride
    const int tile = kTileD * C * ld;            // floats of one tile
    float* sY = smem;                            // (k, kp)
    float* sT = sY + k * kp;                     // (kp,)
    float* sA = sT + kp;                         // 2 x (kTileD * C, ld)
    float* sB = sA + 2 * tile;                   // 2 x (kTileD * C, ld)

    const int b = blockIdx.y;
    const int t = threadIdx.x;
    for (int i = t; i < k * kp; i += nt) {
        const int m = i / kp;
        const int l = i - m * kp;
        sY[i] = l < k ? Ys[((size_t)b * k + m) * k + l] : 0.0f;
    }
    for (int i = t; i < kp; i += nt)
        sT[i] = i < k ? theta[(size_t)b * k + i] : 0.0f;

    const int g = t >> 5;                        // column group: the warp
    const int lane = t & 31;
    const int nwarps = nt >> 5;
    const long d_begin = (long)blockIdx.x * tiles * kTileD;
    const long d_end = min((long)D, d_begin + tiles * kTileD);
    const size_t node_stride = (size_t)B * C * k;   // node d to d + 1
    const size_t boff = (size_t)b * C * k;
    const float* yg = sY + g * kCols;
    const float* tg = sT + g * kCols;
    // per-thread sums of a few rows each in f32; the warp's in f64
    float sr[kCols], su[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) sr[j] = su[j] = 0.0f;

    // two tile buffers: the next tile's copies run while this one is
    // summed
    if (d_begin < d_end)
        stage_tile<C>(sA, sB, AQ, BQ, d_begin, d_end, node_stride, boff, k,
                      ld, g, lane, nwarps);
    int buf = 0;
    for (long d0 = d_begin; d0 < d_end; d0 += kTileD, buf ^= 1) {
        if (d0 + kTileD < d_end)
            stage_tile<C>(sA + (buf ^ 1) * tile, sB + (buf ^ 1) * tile, AQ,
                          BQ, d0 + kTileD, d_end, node_stride, boff, k, ld,
                          g, lane, nwarps);
        else
            __pipeline_commit();                 // keep one group a tile
        __pipeline_wait_prior(1);                // this tile's copies
        __syncthreads();
        // lane i owns node d0 + i: its C rows (C ld is odd: no conflicts)
        float u[C][kCols], v[C][kCols];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
            for (int j = 0; j < kCols; ++j) u[c][j] = v[c][j] = 0.0f;
        const float* ar = sA + buf * tile + lane * C * ld;
        const float* br = sB + buf * tile + lane * C * ld;
        for (int m = 0; m < k; ++m) {
            const float4 y0 = *reinterpret_cast<const float4*>(yg + m * kp);
            const float4 y1 =
                *reinterpret_cast<const float4*>(yg + m * kp + 4);
            const float y[kCols] = {y0.x, y0.y, y0.z, y0.w,
                                    y1.x, y1.y, y1.z, y1.w};
#pragma unroll
            for (int c = 0; c < C; ++c) {
                const float am = ar[c * ld + m];
                const float bm = br[c * ld + m];
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    u[c][j] = fmaf(am, y[j], u[c][j]);
                    v[c][j] = fmaf(bm, y[j], v[c][j]);
                }
            }
        }
        if (d0 + lane < d_end) {
#pragma unroll
            for (int c = 0; c < C; ++c)
#pragma unroll
                for (int j = 0; j < kCols; ++j) {
                    const float rj = u[c][j] - tg[j] * v[c][j];
                    sr[j] = fmaf(rj, rj, sr[j]);
                    su[j] = fmaf(u[c][j], u[c][j], su[j]);
                }
        }
        __syncthreads();                         // the tile is read
    }
    // the warp's 32 nodes, summed in f64 in a fixed butterfly order
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
        double r2 = sr[j], u2 = su[j];
        for (int o = 16; o > 0; o >>= 1) {
            r2 += __shfl_xor_sync(0xffffffffu, r2, o);
            u2 += __shfl_xor_sync(0xffffffffu, u2, o);
        }
        const int l = g * kCols + j;
        if (lane == 0 && l < k) {
            double* p =
                partial + ((size_t)b * gridDim.x + blockIdx.x) * 2 * k;
            p[l] = r2;
            p[k + l] = u2;
        }
    }
}

// NaN wins, as in the reference's max and min
__device__ __forceinline__ float nan_max(float a, float b)
{
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ float nan_min(float a, float b)
{
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// One block. Warp w sums the partials of columns i = w, w + 32, ...:
// lane q takes blocks q, q + 32, ... in order, then a fixed butterfly.
__global__ void __launch_bounds__(kReduceThreads)
ritz_reduce_kernel(const double* __restrict__ partial,  // (B, nP, 2, k)
                   int nP, const float* __restrict__ theta,
                   const float* __restrict__ cuts, int B, int k,
                   int n_wanted, float* __restrict__ res,
                   float* __restrict__ gate)
{
    __shared__ float s_max[kReduceThreads / 32];
    __shared__ float s_min[kReduceThreads / 32];
    __shared__ int s_any[kReduceThreads / 32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    float mx = -INFINITY, mn = INFINITY;
    int any = 0;
    for (int i = w; i < B * k; i += nw) {
        const int b = i / k;
        const int l = i - b * k;
        const double* p = partial + (size_t)b * nP * 2 * k + l;
        double nr = 0.0, nu = 0.0;
        for (int q = lane; q < nP; q += 32) {
            nr += p[(size_t)q * 2 * k];
            nu += p[(size_t)q * 2 * k + k];
        }
        for (int o = 16; o > 0; o >>= 1) {
            nr += __shfl_xor_sync(0xffffffffu, nr, o);
            nu += __shfl_xor_sync(0xffffffffu, nu, o);
        }
        const float r = (float)(sqrt(nr) / (sqrt(nu) + 1e-30));
        if (lane == 0) res[i] = r;
        mn = nan_min(mn, r);
        if (theta[i] < cuts[b] && (n_wanted <= 0 || l < n_wanted)) {
            any = 1;
            mx = nan_max(mx, r);
        }
    }
    if (lane == 0) {
        s_max[w] = mx;
        s_min[w] = mn;
        s_any[w] = any;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int q = 1; q < nw; ++q) {
            mx = nan_max(mx, s_max[q]);
            mn = nan_min(mn, s_min[q]);
            any |= s_any[q];
        }
        gate[0] = any ? mx : mn;
    }
}

template <int C>
cudaError_t launch_rows(const float* AQ, const float* BQ, const float* Ys,
                        const float* theta, int D, int B, int k,
                        double* partial, cudaStream_t s)
{
    cudaError_t rc = set_shared_limit(ritz_rows_kernel<C>);
    if (rc != cudaSuccess) return rc;
    const long per = tiles_per_block(D, B);
    const int nP = (int)((tiles_of(D) + per - 1) / per);
    ritz_rows_kernel<C><<<dim3(nP, B), groups_of(k) * 32,
                          shared_bytes(C, k), s>>>(AQ, BQ, Ys, theta, D, B,
                                                   k, per, partial);
    return cudaGetLastError();
}

}  // namespace

// The partial array of pl_ritz_residual holds B times
// pl_ritz_residual_blocks(D, B) times 2 k doubles.
extern "C" int pl_ritz_residual_blocks(int D, int B)
{
    const long per = tiles_per_block(D, B);
    return (int)((tiles_of(D) + per - 1) / per);
}

extern "C" int pl_ritz_residual(
    const void* AQ, const void* BQ, const void* Ys, const void* theta,
    const void* cuts, int D, int B, int C, int k, int n_wanted,
    void* partial, void* res, void* gate, void* stream)
{
    if (D < 1 || B < 1 || B > 65535 || (C != 1 && C != 3) || k < 1
        || k > kMaxK)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const cudaError_t rc =
        C == 1 ? launch_rows<1>((const float*)AQ, (const float*)BQ,
                                (const float*)Ys, (const float*)theta, D, B,
                                k, (double*)partial, s)
               : launch_rows<3>((const float*)AQ, (const float*)BQ,
                                (const float*)Ys, (const float*)theta, D, B,
                                k, (double*)partial, s);
    if (rc != cudaSuccess) return (int)rc;
    ritz_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
        (const double*)partial, pl_ritz_residual_blocks(D, B),
        (const float*)theta, (const float*)cuts, B, k, n_wanted,
        (float*)res, (float*)gate);
    return (int)cudaGetLastError();
}
