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
// F.R2 and R1.R2, so X needs no second pass over itself. Three launches:
//
// 1. sums: a block owns a run of rows of ALL designs (of a group of
//    whole designs along the grid's y where B k passes 256) and walks it
//    in tiles of 8 rows. A tile of R1 and R2 is one contiguous range of
//    each, streamed into a two-stage shared-memory ring with 16-byte
//    asynchronous copies, with the tile's rows of the prolongation
//    tables (so each table row is loaded once for all B 3 k lanes). A
//    thread owns one column (b, j) and its three components of every
//    R-th row: neighbouring threads take neighbouring j, so a warp's
//    gathers of Hc are contiguous runs. Where colmask[b, j] is exactly
//    1, R1's coefficient is 0: a 16-byte chunk of R1 whose four lanes
//    are all such columns is not copied, and R1's sums are not formed;
//    where it is exactly 0, F's coefficient is 0: F is not gathered. The
//    thread keeps its column's six sums in f64 and writes them as one
//    partial per (block, row phase, sum, column). Two blocks an SM (64
//    registers a thread) keep about 28 warps' gathers in flight: the
//    gathers of Hc, not the streams, take most of its time.
// 2. coefficients: each (b, j) sums its partials once, in block order
//    (32 columns a block, its 16 warps over the partials, then the warps
//    in order), and forms X's three coefficients.
// 3. blend: the geometry of launch 1; X = a F + c1 R1 + c2 R2 with the
//    same skips, F gathered again, X written into a shared tile and
//    stored in 16-byte chunks.
//
// No float atomics: the result repeats bit for bit. A row of P has at
// most 8 entries (6 for the P2 prolongation). With finite inputs the
// skipped terms are exact zeros (the plain twin multiplies them by 0).
// Groups of designs (B k > 256) copy element by element.
//
// Bound on the H100: bytes. R1 on the columns that are not seeded, R2
// read and X written once (each row of each), the tables and Hc's needed
// columns. The design reads R2, R1's unseeded chunks and the tables
// twice, and Hc's gathered rows twice from L2 for the most part.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "shared_limit.cuh"

namespace {

constexpr int kMaxK = 128;
constexpr int kMaxW = 8;            // prolongation entries per row
constexpr int kMaxCols = 256;       // (b, j) columns a block, at most
constexpr int kMaxThreads = 512;    // columns times row phases
constexpr int kTileRows = 8;        // rows a tile
constexpr int kBlocksPerSM = 2;     // launches 1 and 3, over all groups
constexpr int kSums = 6;            // F.F R1.R1 R2.R2 F.R1 F.R2 R1.R2
constexpr int kCoefCols = 32;       // launch 2: columns a block
constexpr int kCoefWarps = 16;

struct Plan {
    int G;          // designs a block (a group along y)
    int groups;
    int pc;         // columns a block: G k
    int R;          // row phases (pc R threads)
    int threads;
    int Lg;         // lanes of a row in the block: 3 G k
    int flat;       // 1: a tile is one contiguous range (one group)
    int P;          // 16-byte chunks before the lanes repeat (flat)
    int rows;       // rows a block, a multiple of kTileRows
    int nblk;       // blocks along x
    size_t bytes;   // dynamic shared memory
};

inline int multiprocessors()
{
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess
        || n < 1)
        return 132;
    return n;
}

inline int gcd4(int L) { return L % 4 == 0 ? 4 : (L % 2 == 0 ? 2 : 1); }

// floats of one stage: the R1 and R2 tiles and the tile's table rows
__host__ __device__ inline size_t stage_floats(int Lg)
{
    return 2 * (size_t)kTileRows * Lg + 2 * kTileRows * kMaxW;
}

Plan make_plan(int Dp, int B, int k)
{
    Plan p;
    p.G = B * k <= kMaxCols ? B : (kMaxCols / k > 0 ? kMaxCols / k : 1);
    p.groups = (B + p.G - 1) / p.G;
    p.pc = p.G * k;
    p.R = kMaxThreads / p.pc;
    p.R = p.R < 1 ? 1 : (p.R >= 4 ? 4 : (p.R >= 2 ? 2 : 1));
    p.threads = (p.pc * p.R + 31) / 32 * 32;
    p.Lg = 3 * p.G * k;
    p.flat = p.groups == 1;
    p.P = p.flat ? p.Lg / gcd4(p.Lg) : 0;
    const long target =
        ((long)kBlocksPerSM * multiprocessors() + p.groups - 1) / p.groups;
    long rows = ((long)Dp + target - 1) / target;
    rows = (rows + kTileRows - 1) / kTileRows * kTileRows;
    p.rows = (int)rows;
    p.nblk = (int)(((long)Dp + rows - 1) / rows);
    // two stages, the X tile, the chunk flags
    p.bytes = sizeof(float) * (2 * stage_floats(p.Lg)
                               + (size_t)kTileRows * p.Lg)
              + ((size_t)p.P + 15) / 16 * 16;
    return p;
}

// Issue one tile's copies (rows d .. d + nr - 1, the lg lanes of the
// block's designs) into one stage and commit them as one group: R2 whole,
// R1 where a chunk (flat) or lane (groups) may have a nonzero
// coefficient, the table rows.
__device__ __forceinline__ void stage_tile(
    float* st, const Plan& p, const float* __restrict__ R1,
    const float* __restrict__ R2, const int* __restrict__ cols,
    const float* __restrict__ wts, const unsigned char* need4,
    const float* __restrict__ colmask, long d, int nr, int lg, size_t L,
    size_t goff, int b0, int k, int W)
{
    float* s1 = st;
    float* s2 = st + (size_t)kTileRows * p.Lg;
    int* scol = reinterpret_cast<int*>(s2 + (size_t)kTileRows * p.Lg);
    float* swt = reinterpret_cast<float*>(scol + kTileRows * kMaxW);
    const int t = threadIdx.x, nth = blockDim.x;
    if (p.flat) {
        // rows d .. d + nr - 1 are one range; d L is a multiple of 4
        const size_t base = (size_t)d * L;
        const int n = nr * p.Lg;
        const int n4 = n >> 2;
        int ph = t % p.P;                        // chunk i's lanes: i mod P
        for (int i = t; i < n4; i += nth) {
            __pipeline_memcpy_async(s2 + 4 * i, R2 + base + 4 * i, 16);
            if (need4[ph])
                __pipeline_memcpy_async(s1 + 4 * i, R1 + base + 4 * i, 16);
            ph += nth;
            while (ph >= p.P) ph -= p.P;
        }
        for (int i = 4 * n4 + t; i < n; i += nth) {
            __pipeline_memcpy_async(s2 + i, R2 + base + i, 4);
            const int l = i % p.Lg;
            if (colmask[(size_t)(l / (3 * k)) * k + l % k] != 1.0f)
                __pipeline_memcpy_async(s1 + i, R1 + base + i, 4);
        }
    } else {
        for (int e = t; e < nr * lg; e += nth) {
            const int r = e / lg;
            const int l = e - r * lg;
            const size_t o = (size_t)(d + r) * L + goff + l;
            __pipeline_memcpy_async(s2 + r * p.Lg + l, R2 + o, 4);
            if (colmask[(size_t)(b0 + l / (3 * k)) * k + l % k] != 1.0f)
                __pipeline_memcpy_async(s1 + r * p.Lg + l, R1 + o, 4);
        }
    }
    for (int e = t; e < nr * W; e += nth) {
        const int r = e / W;
        const int w = e - r * W;
        __pipeline_memcpy_async(scol + r * kMaxW + w, cols + d * W + e, 4);
        __pipeline_memcpy_async(swt + r * kMaxW + w, wts + d * W + e, 4);
    }
    __pipeline_commit();
}

// F at row r of a staged tile, components c = 0..2 of one column: hc
// points at Hc[b, 0, 0, j]. The W entries, then the 3 W gathers, are
// issued together.
__device__ __forceinline__ void prolong3(float (&f)[3],
                                         const float* __restrict__ hc,
                                         const int* scol, const float* swt,
                                         int r, int W, size_t nck, int k)
{
    const int4 c0 = *reinterpret_cast<const int4*>(scol + r * kMaxW);
    const int4 c1 = *reinterpret_cast<const int4*>(scol + r * kMaxW + 4);
    const float4 w0 = *reinterpret_cast<const float4*>(swt + r * kMaxW);
    const float4 w1 = *reinterpret_cast<const float4*>(swt + r * kMaxW + 4);
    const int col[kMaxW] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
    const float wt[kMaxW] = {w0.x, w0.y, w0.z, w0.w,
                             w1.x, w1.y, w1.z, w1.w};
    float h[3][kMaxW];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
            h[c][w] = w < W ? hc[c * nck + (size_t)col[w] * k] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < kMaxW; ++w)
            if (w < W) acc = fmaf(wt[w], h[c][w], acc);
        f[c] = acc;
    }
}

// One staged tile's rows r0, r0 + R, ... < nr of this thread's column
// (lane l0 of component 0 in a tile row): kF: F is needed (m != 0), kR1:
// R1 is (m != 1). With kBlend, X = ca F + cr1 R1 + cr2 R2 goes into the X
// tile; else the six sums are formed.
template <bool kF, bool kR1, bool kBlend>
__device__ __forceinline__ void tile_rows(
    double (&s)[kSums], const float* st, float* sx, const Plan& p,
    const float* __restrict__ hc, float ca, float cr1, float cr2, int r0,
    int nr, int l0, int W, size_t nck, int k)
{
    const float* s1 = st;
    const float* s2 = st + (size_t)kTileRows * p.Lg;
    const int* scol =
        reinterpret_cast<const int*>(s2 + (size_t)kTileRows * p.Lg);
    const float* swt =
        reinterpret_cast<const float*>(scol + kTileRows * kMaxW);
    for (int r = r0; r < nr; r += p.R) {
        float f[3];
        if (kF) prolong3(f, hc, scol, swt, r, W, nck, k);
        const int o = r * p.Lg + l0;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const float a = kR1 ? s1[o + c * k] : 0.0f;
            const float c2 = s2[o + c * k];
            if (kBlend) {
                float x = cr2 * c2;
                if (kR1) x = fmaf(cr1, a, x);
                if (kF) x = fmaf(ca, f[c], x);
                sx[o + c * k] = x;
            } else {
                const double r2 = c2;
                s[2] += r2 * r2;
                if (kF) {
                    const double fd = f[c];
                    s[0] += fd * fd;
                    s[4] += fd * r2;
                    if (kR1) s[3] += fd * (double)a;
                }
                if (kR1) {
                    const double r1 = a;
                    s[1] += r1 * r1;
                    s[5] += r1 * r2;
                }
            }
        }
    }
}

// Launches 1 (kBlend false: the sums) and 3 (the blend).
template <bool kBlend>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSM)
seed_rows_kernel(const float* __restrict__ Hc,       // (B, 3, nc, k)
                 const float* __restrict__ colmask,  // (B, k)
                 const int* __restrict__ cols,       // (Dp, W)
                 const float* __restrict__ wts,      // (Dp, W)
                 const float* __restrict__ R1,       // (Dp, B, 3, k)
                 const float* __restrict__ R2,       // (Dp, B, 3, k)
                 const float* __restrict__ coef,     // (3, B k): blend
                 int Dp, int B, int nc, int k, int W, Plan p,
                 double* __restrict__ partial,       // (nblk R, 6, B k)
                 float* __restrict__ X)              // (Dp, B, 3, k)
{
    extern __shared__ float4 smem4[];
    float* stages = reinterpret_cast<float*>(smem4);
    const size_t sf = stage_floats(p.Lg);
    float* sx = stages + 2 * sf;                             // (8, Lg)
    unsigned char* need4 =
        reinterpret_cast<unsigned char*>(sx + (size_t)kTileRows * p.Lg);
    const int b0 = blockIdx.y * p.G;
    const int Gy = min(p.G, B - b0);
    const int lg = 3 * Gy * k;
    const size_t L = (size_t)B * 3 * k;
    const size_t goff = (size_t)b0 * 3 * k;
    const int t = threadIdx.x, nth = blockDim.x;
    // chunk i of a tile (flat): copy R1 unless its 4 lanes all have a
    // zero coefficient
    for (int i = t; i < p.P; i += nth) {
        bool any = false;
        for (int u = 0; u < 4; ++u) {
            const int l = (4 * i + u) % p.Lg;
            any |= colmask[(size_t)(l / (3 * k)) * k + l % k] != 1.0f;
        }
        need4[i] = any;
    }
    __syncthreads();
    const long d0 = (long)blockIdx.x * p.rows;
    const long d1 = min((long)Dp, d0 + p.rows);
    const int tiles = (int)((d1 - d0 + kTileRows - 1) / kTileRows);

    // this thread's column (b, j) of the block and its row phase
    const int pl = t % p.pc;
    const int r0 = t / p.pc;
    const bool active = r0 < p.R && pl < Gy * k;
    const int bl = pl / k, j = pl - (pl / k) * k;
    const int pg = (b0 + bl) * k + j;                 // (b, j) in B k
    const size_t nck = (size_t)nc * k;
    const float* hc = Hc + (size_t)(b0 + bl) * 3 * nck + j;
    const int l0 = bl * 3 * k + j;
    const float m = active ? colmask[pg] : 1.0f;
    float ca = 0.0f, cr1 = 0.0f, cr2 = 0.0f;
    if (kBlend && active) {
        const size_t P2 = (size_t)B * k;
        ca = coef[pg];
        cr1 = coef[P2 + pg];
        cr2 = coef[2 * P2 + pg];
    }
    double s[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};

    stage_tile(stages, p, R1, R2, cols, wts, need4, colmask, d0,
               (int)min((long)kTileRows, d1 - d0), lg, L, goff, b0, k, W);
    for (int it = 0; it < tiles; ++it) {
        __pipeline_wait_prior(0);
        __syncthreads();              // the tile is in; the other stage
                                      // and the X tile are free
        const long d = d0 + (long)it * kTileRows;
        const int nr = (int)min((long)kTileRows, d1 - d);
        if (it + 1 < tiles) {
            const long dn = d + kTileRows;
            stage_tile(stages + ((it + 1) & 1) * sf, p, R1, R2, cols, wts,
                       need4, colmask, dn, (int)min((long)kTileRows, d1 - dn),
                       lg, L, goff, b0, k, W);
        }
        const float* st = stages + (it & 1) * sf;
        if (active) {
            if (m == 1.0f)
                tile_rows<true, false, kBlend>(s, st, sx, p, hc, ca, cr1,
                                               cr2, r0, nr, l0, W, nck, k);
            else if (m == 0.0f)
                tile_rows<false, true, kBlend>(s, st, sx, p, hc, ca, cr1,
                                               cr2, r0, nr, l0, W, nck, k);
            else
                tile_rows<true, true, kBlend>(s, st, sx, p, hc, ca, cr1,
                                              cr2, r0, nr, l0, W, nck, k);
        }
        if (kBlend) {
            __syncthreads();                     // the X tile is written
            if (p.flat) {
                float* xo = X + (size_t)d * L;
                const int n = nr * p.Lg;
                const int n4 = n >> 2;
                for (int i = t; i < n4; i += nth)
                    reinterpret_cast<float4*>(xo)[i] =
                        reinterpret_cast<const float4*>(sx)[i];
                for (int i = 4 * n4 + t; i < n; i += nth) xo[i] = sx[i];
            } else {
                for (int e = t; e < nr * lg; e += nth) {
                    const int r = e / lg;
                    const int l = e - r * lg;
                    X[(size_t)(d + r) * L + goff + l] = sx[r * p.Lg + l];
                }
            }
        }
    }
    if (kBlend || !active) return;
    const size_t P2 = (size_t)B * k;
    double* out = partial + ((size_t)blockIdx.x * p.R + r0) * kSums * P2 + pg;
#pragma unroll
    for (int q = 0; q < kSums; ++q) out[q * P2] = s[q];
}

// 32 columns a block: warp w sums partials w, w + 16, ... of each of its
// lanes' columns, then warp 0 sums the 16 warps in order and forms the
// coefficients coef[0 / 1 / 2][p] of F, R1 and R2.
__global__ void __launch_bounds__(kCoefCols * kCoefWarps)
seed_coef_kernel(const double* __restrict__ partial,  // (nP, 6, B k)
                 int nP, int P2, const float* __restrict__ colmask,
                 float scale, float* __restrict__ coef)  // (3, B k)
{
    __shared__ double red[kCoefWarps][kSums][kCoefCols];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int p = blockIdx.x * kCoefCols + lane;
    double s[kSums] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    if (p < P2)
#pragma unroll 4
        for (int q = w; q < nP; q += kCoefWarps)
#pragma unroll
            for (int i = 0; i < kSums; ++i)
                s[i] += partial[((size_t)q * kSums + i) * P2 + p];
#pragma unroll
    for (int i = 0; i < kSums; ++i) red[w][i][lane] = s[i];
    __syncthreads();
    if (w != 0 || p >= P2) return;
    for (int q = 1; q < kCoefWarps; ++q)
#pragma unroll
        for (int i = 0; i < kSums; ++i) s[i] += red[q][i][lane];
    const double FF = s[0], R11 = s[1], R22 = s[2];
    const double FR1 = s[3], FR2 = s[4], R12 = s[5];
    const double m = colmask[p];
    const double a = m / (sqrt(FF) + 1e-30);
    const double c1 = (1.0 - m) / (sqrt(R11) + 1e-30);
    const double sc = scale;
    const double x2 = a * a * FF + c1 * c1 * R11 + sc * sc * R22
                      + 2.0 * (a * c1 * FR1 + a * sc * FR2 + c1 * sc * R12);
    const double inv = 1.0 / (sqrt(fmax(x2, 0.0)) + 1e-30);
    coef[p] = (float)(a * inv);
    coef[P2 + p] = (float)(c1 * inv);
    coef[2 * P2 + p] = (float)(sc * inv);
}

}  // namespace

// The partial array of pl_seed_prolong holds pl_seed_prolong_blocks(Dp,
// B, k) times 6 B k doubles; its coefficient array 3 B k floats.
extern "C" int pl_seed_prolong_blocks(int Dp, int B, int k)
{
    if (Dp < 1 || B < 1 || k < 1) return 0;
    const Plan p = make_plan(Dp, B, k);
    return p.nblk * p.R;
}

extern "C" int pl_seed_prolong(
    const void* Hc, const void* colmask, const void* cols, const void* wts,
    const void* R1, const void* R2, float scale, int Dp, int B, int nc,
    int k, int W, void* partial, void* coef, void* X, void* stream)
{
    if (Dp < 1 || B < 1 || B > 65535 || nc < 1 || k < 1 || k > kMaxK
        || W < 1 || W > kMaxW)
        return (int)cudaErrorInvalidValue;
    const Plan p = make_plan(Dp, B, k);
    if (p.flat && ((uintptr_t)R1 % 16 || (uintptr_t)R2 % 16
                   || (uintptr_t)X % 16))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const dim3 grid(p.nblk, p.groups);
    cudaError_t rc = set_shared_limit(seed_rows_kernel<false>);
    if (rc == cudaSuccess) rc = set_shared_limit(seed_rows_kernel<true>);
    if (rc != cudaSuccess) return (int)rc;
    seed_rows_kernel<false><<<grid, p.threads, p.bytes, s>>>(
        (const float*)Hc, (const float*)colmask, (const int*)cols,
        (const float*)wts, (const float*)R1, (const float*)R2, nullptr, Dp,
        B, nc, k, W, p, (double*)partial, nullptr);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    const int P2 = B * k;
    seed_coef_kernel<<<(P2 + kCoefCols - 1) / kCoefCols,
                       kCoefCols * kCoefWarps, 0, s>>>(
        (const double*)partial, p.nblk * p.R, P2, (const float*)colmask,
        scale, (float*)coef);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
    seed_rows_kernel<true><<<grid, p.threads, p.bytes, s>>>(
        (const float*)Hc, (const float*)colmask, (const int*)cols,
        (const float*)wts, (const float*)R1, (const float*)R2,
        (const float*)coef, Dp, B, nc, k, W, p, nullptr, (float*)X);
    return (int)cudaGetLastError();
}
