// K9: the two-grid bootstrap seed of the vectorial sweep, written in the
// filter's fused layout (Dp, B, 3, k):
//
//   F = P Hc                     (the coarse Ritz vectors, prolonged)
//   X = F / |F| m + R1 / |R1| (1 - m) + s R2,    s = 0.05 / sqrt(3 Dp)
//   X = X / (|X| + 1e-30)
//
// with |F| = ||F|| + 1e-30 and |R1| likewise, every norm per (design,
// column) over all 3 Dp rows, m = colmask[b, j]. P is given as padded
// gather tables (Dp, W): row d of F is sum_w wts[d, w] Hc[b, c,
// cols[d, w], j]. R1 and R2 are standard-normal blocks in the fused
// layout. Replaces pl_fem_tpu/solvers/vectorial.py _seed_from_coarse (a
// jitted loop of W full-size gathers, a transpose and three column
// norms), which the port ran as W torch gathers, a permute copy and a
// transpose into the fused layout.
//
// ||X||^2 expands into the six column sums F.F, R1.R1, R2.R2, F.R1,
// F.R2 and R1.R2, so X needs no second pass over itself. First launch:
// a block owns one design and a run of rows, a thread one lane (c, j) of
// four rows at a time (their table loads, gathers and noise loads issued
// together); it gathers F and accumulates the six sums in f64,
// and the block writes one partial per (design, block, column) after
// summing its threads in a fixed order. Second launch, the same grid:
// each block sums its design's partials in block order, forms the
// column's three coefficients and writes X = a F + b R1 + c R2, with F
// gathered again. No float atomics: the result repeats bit for bit. A
// row of P has at most 8 entries (6 for the P2 prolongation).
//
// Bound on the H100: bytes. R1 and R2 read once, X written once (12
// bytes per element of the (Dp, B, 3, k) block), the tables and Hc.
// The design reads R1, R2 and the tables twice and Hc's gathered rows
// twice (from L2 for the most part): about 5 / 3 of the bound.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxW = 8;            // prolongation entries per row
constexpr int kThreads = 512;       // at most, a whole number of rows
constexpr int kTargetBlocks = 1024; // over all designs
constexpr int kSums = 6;            // F.F R1.R1 R2.R2 F.R1 F.R2 R1.R2
constexpr int kUnroll = 4;          // rows a thread has in flight

inline int rows_in_flight(int k)
{
    const int r = kThreads / (3 * k);
    return r < 1 ? 1 : r;
}

// Rows per block: about kTargetBlocks blocks over all designs, and at
// least the rows one pass of the block covers.
inline int rows_per_block(int Dp, int B, int k)
{
    const long target = (kTargetBlocks + B - 1) / B;
    long rows = ((long)Dp + target - 1) / target;
    const int r = rows_in_flight(k);
    if (rows < r) rows = r;
    return (int)rows;
}

// row d of F at lane (c, j) of design b: hc points at Hc[b, c, 0, j].
// The W table entries, then the W gathers, are issued together.
__device__ __forceinline__ float prolong(const float* __restrict__ hc,
                                         const int* __restrict__ cols,
                                         const float* __restrict__ wts,
                                         int d, int W, int k)
{
    int col[kMaxW];
    float wt[kMaxW], h[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
        const size_t e = (size_t)d * W + w;
        col[w] = w < W ? cols[e] : 0;
        wt[w] = w < W ? wts[e] : 0.0f;
    }
#pragma unroll
    for (int w = 0; w < kMaxW; ++w)
        h[w] = w < W ? hc[(size_t)col[w] * k] : 0.0f;
    float f = 0.0f;
#pragma unroll
    for (int w = 0; w < kMaxW; ++w)
        if (w < W) f = fmaf(wt[w], h[w], f);
    return f;
}

__global__ void __launch_bounds__(kThreads)
seed_sums_kernel(const float* __restrict__ Hc,     // (B, 3, nc, k)
                 const int* __restrict__ cols,     // (Dp, W)
                 const float* __restrict__ wts,    // (Dp, W)
                 const float* __restrict__ R1,     // (Dp, B, 3, k)
                 const float* __restrict__ R2,     // (Dp, B, 3, k)
                 int Dp, int B, int nc, int k, int W, int rows,
                 double* __restrict__ partial)     // (B, blocks, 6, k)
{
    extern __shared__ double red[];               // (6, blockDim)
    const int b = blockIdx.y;
    const int L3 = 3 * k;
    const int R = blockDim.x / L3;
    const int t = threadIdx.x;
    const int l = t % L3;
    const int r0 = t / L3;
    const int c = l / k;
    const int j = l - c * k;
    const float* hc = Hc + ((size_t)(b * 3 + c) * nc) * k + j;
    const int d0 = blockIdx.x * rows;
    const int d1 = min(Dp, d0 + rows);
    double s[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int d = d0 + r0; d < d1; d += kUnroll * R) {
        // kUnroll rows at once, their loads issued together (a row past
        // d1 reads row d1 - 1 and counts zero)
        float f[kUnroll], r1[kUnroll], r2[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int du = min(d + u * R, d1 - 1);
            const size_t o = ((size_t)du * B + b) * L3 + l;
            f[u] = prolong(hc, cols, wts, du, W, k);
            r1[u] = R1[o];
            r2[u] = R2[o];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (d + u * R >= d1) break;
            const double fd = f[u], a = r1[u], c2 = r2[u];
            s[0] += fd * fd;
            s[1] += a * a;
            s[2] += c2 * c2;
            s[3] += fd * a;
            s[4] += fd * c2;
            s[5] += a * c2;
        }
    }
    const int nt = blockDim.x;
#pragma unroll
    for (int q = 0; q < kSums; ++q) red[q * nt + t] = s[q];
    __syncthreads();
    double* p = partial + ((size_t)b * gridDim.x + blockIdx.x) * kSums * k;
    for (int i = t; i < kSums * k; i += nt) {
        const int q = i / k;
        const int jj = i - q * k;
        double acc = 0.0;
        for (int rr = 0; rr < R; ++rr)
            for (int cc = 0; cc < 3; ++cc)
                acc += red[q * nt + rr * L3 + cc * k + jj];
        p[i] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
seed_blend_kernel(const float* __restrict__ Hc, const int* __restrict__ cols,
                  const float* __restrict__ wts,
                  const float* __restrict__ R1, const float* __restrict__ R2,
                  const float* __restrict__ colmask,   // (B, k)
                  float scale, int Dp, int B, int nc, int k, int W, int rows,
                  const double* __restrict__ partial,  // (B, nP, 6, k)
                  float* __restrict__ X)               // (Dp, B, 3, k)
{
    __shared__ double sums[kSums * kMaxK];
    __shared__ float coef[3 * kMaxK];
    const int b = blockIdx.y;
    const int nP = gridDim.x;
    const int t = threadIdx.x;
    const int nt = blockDim.x;
    // full warp w sums the design's partials of sums i = w, w + warps,
    // ...: lane q takes blocks q, q + 32, ... in order, then a fixed
    // butterfly (the block's last warp may be partial: it sits out)
    const double* p = partial + (size_t)b * nP * kSums * k;
    const int lane = t & 31;
    const int warps = nt >> 5;
    for (int i = t >> 5; i < kSums * k && (t >> 5) < warps; i += warps) {
        double acc = 0.0;
        for (int q = lane; q < nP; q += 32)
            acc += p[(size_t)q * kSums * k + i];
        for (int o = 16; o > 0; o >>= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (lane == 0) sums[i] = acc;
    }
    __syncthreads();
    for (int jj = t; jj < k; jj += nt) {
        const double FF = sums[jj], R11 = sums[k + jj], R22 = sums[2 * k + jj];
        const double FR1 = sums[3 * k + jj], FR2 = sums[4 * k + jj];
        const double R12 = sums[5 * k + jj];
        const double m = colmask[(size_t)b * k + jj];
        const double a = m / (sqrt(FF) + 1e-30);
        const double c1 = (1.0 - m) / (sqrt(R11) + 1e-30);
        const double s = scale;
        const double x2 = a * a * FF + c1 * c1 * R11 + s * s * R22
                          + 2.0 * (a * c1 * FR1 + a * s * FR2 + c1 * s * R12);
        const double inv = 1.0 / (sqrt(fmax(x2, 0.0)) + 1e-30);
        coef[jj] = (float)(a * inv);
        coef[kMaxK + jj] = (float)(c1 * inv);
        coef[2 * kMaxK + jj] = (float)(s * inv);
    }
    __syncthreads();
    const int L3 = 3 * k;
    const int R = nt / L3;
    const int l = t % L3;
    const int r0 = t / L3;
    const int c = l / k;
    const int j = l - c * k;
    const float* hc = Hc + ((size_t)(b * 3 + c) * nc) * k + j;
    const float ca = coef[j], cr1 = coef[kMaxK + j], cr2 = coef[2 * kMaxK + j];
    const int d0 = blockIdx.x * rows;
    const int d1 = min(Dp, d0 + rows);
    for (int d = d0 + r0; d < d1; d += kUnroll * R) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int du = min(d + u * R, d1 - 1);
            const size_t o = ((size_t)du * B + b) * L3 + l;
            x[u] = ca * prolong(hc, cols, wts, du, W, k) + cr1 * R1[o]
                   + cr2 * R2[o];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (d + u * R < d1)
                X[((size_t)(d + u * R) * B + b) * L3 + l] = x[u];
    }
}

}  // namespace

// The partial array of pl_seed_prolong holds B times
// pl_seed_prolong_blocks(Dp, B, k) times 6 k doubles.
extern "C" int pl_seed_prolong_blocks(int Dp, int B, int k)
{
    const int rows = rows_per_block(Dp, B, k);
    return (Dp + rows - 1) / rows;
}

extern "C" int pl_seed_prolong(
    const void* Hc, const void* colmask, const void* cols, const void* wts,
    const void* R1, const void* R2, float scale, int Dp, int B, int nc,
    int k, int W, void* partial, void* X, void* stream)
{
    if (Dp < 1 || B < 1 || B > 65535 || nc < 1 || k < 1 || k > kMaxK
        || W < 1 || W > kMaxW)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const int rows = rows_per_block(Dp, B, k);
    const int nP = pl_seed_prolong_blocks(Dp, B, k);
    const int threads = 3 * k * rows_in_flight(k);
    const dim3 grid(nP, B);
    seed_sums_kernel<<<grid, threads, sizeof(double) * kSums * threads,
                       s>>>(
        (const float*)Hc, (const int*)cols, (const float*)wts,
        (const float*)R1, (const float*)R2, Dp, B, nc, k, W, rows,
        (double*)partial);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    seed_blend_kernel<<<grid, threads, 0, s>>>(
        (const float*)Hc, (const int*)cols, (const float*)wts,
        (const float*)R1, (const float*)R2, (const float*)colmask, scale,
        Dp, B, nc, k, W, rows, (const double*)partial, (float*)X);
    return (int)cudaGetLastError();
}
