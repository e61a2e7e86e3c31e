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
// First launch: persistent blocks, about one per SM, walk the node
// tiles in a fixed round-robin order. A tile is 8 Q nodes of ALL the
// block's designs: in the fused layout one contiguous range of AQ and
// one of BQ, streamed into a ring of 2-4 shared-memory stages with
// 16-byte asynchronous copies (per node, into a padded stride that keeps
// the fragment loads free of bank conflicts, where a node's row is a
// multiple of 8 floats; element by element for a group of designs whose
// rows do not start on 16 bytes). Ys of the block's designs sits in
// shared memory once, split into TF32 hi and lo parts in the order of
// the mma's B fragments, with theta. The products run on the tensor
// cores (mma.sync m16n8k8 TF32, f32 sums) with the 3xTF32 split: a = hi
// + lo, u = a Ys ~ lo hi' + hi lo' + hi hi', which keeps f32 accuracy
// (plain TF32 keeps ~3 digits, far from a converged column's residual).
// An item is 8 nodes of one design and component: its 16 mma rows are
// AQ's 8 rows over BQ's, so one product gives u and v of a node in the
// same lane, and R = u - theta v and the squares come straight from the
// accumulator fragments. A warp takes a tile's items in a fixed order;
// the 8 nodes' squares are summed by a fixed shuffle tree into the
// warp's f64 sums in shared memory (one slot per item position, so a
// slot always holds one design); Q is chosen so the block's warps share
// a tile's items evenly. At the end the block sums its warps' slots per
// design in item order and writes one partial per (design, block,
// column). AXr, BXr and R never reach device memory. Designs whose Ys do
// not fit next to two stages are split into groups along the grid's y.
// Second launch, one block: a warp per (b, l) sums its partials (lane q
// takes blocks q, q + 32, ..., then a fixed butterfly) in f64 and writes
// res, and the block reduces the gate (NaN propagates, as in the
// reference's max and min). No float atomics and a grid fixed by the
// card: the result repeats bit for bit. C is 1 (the stacked solver's
// block as one design) or 3; k is 1 to 96.
//
// Bound on the H100: bytes (AQ and BQ read once, 8 C D B k bytes); the
// 3 x 4 k^2 TF32 products per row and design take 0.10 ms at the r5
// shape at 495 TFLOP/s, under its 0.234 ms of bytes. The design reads
// each AQ / BQ element once from device memory and once from shared
// memory; Ys is read once per block.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <algorithm>
#include <cstdint>

#include "shared_limit.cuh"

namespace {

constexpr int kMaxK = 96;
constexpr int kMaxStages = 4;
constexpr int kMaxQ = 64;           // node octets a tile, at most
constexpr int kTileFloats = 16384;  // one matrix's tile, at most (floats)
constexpr int kReduceThreads = 1024;

// warps a block: 16, or 8 at 12 column tiles (their registers)
__host__ __device__ constexpr int warps_for(int NT)
{
    return NT >= 12 ? 8 : 16;
}

// The first launch's shared-memory plan, the same in host and kernel.
struct Plan {
    int G;          // designs per block (a group along the grid's y)
    int KS;         // k steps of 8
    int NT;         // column tiles of 8 (the kernel's template)
    int Q;          // node octets per tile
    int sp;         // floats per node in a shared tile (>= G C k)
    int flat;       // 1: the tile is one contiguous range (G == B)
    int vec16;      // per-node copies in 16-byte chunks, else 4-byte
    int stages;     // tiles in the ring
    int J;          // item slots per warp
    int groups;     // ceil(B / G)
    int blocks;     // persistent blocks per group
    size_t bytes;   // dynamic shared memory
};

// column tiles of 8 the kernel is built for: 1, 2, 3, 4, 6, 8 or 12
inline int tiles_for(int k)
{
    const int n = (k + 7) / 8;
    return n <= 4 ? n : (n <= 6 ? 6 : (n <= 8 ? 8 : 12));
}

__host__ __device__ inline size_t up16(size_t n)
{
    return (n + 15) & ~(size_t)15;
}

// Ys's B fragments: a float4 (rows m and m + 4 of one column, each as
// TF32 hi and lo) a lane per (design, k step, column tile)
inline size_t ys_bytes(int G, int KS, int NT)
{
    return (size_t)G * KS * NT * 32 * sizeof(float4);
}

inline size_t sums_bytes(int warps, int J, int NT)
{
    return (size_t)warps * J * 2 * NT * 8 * sizeof(double);
}

__host__ __device__ inline size_t theta_bytes(int G, int NT)
{
    return up16((size_t)G * NT * 8 * sizeof(float));
}

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

// The largest group of designs whose Ys, theta and sums leave room for
// two stages; 16-byte copies where a node's rows start on 16 bytes; the
// tile's node octets Q chosen so the block's warps share its items
// evenly (then the most stages, then the smallest tile).
bool make_plan(int D, int B, int C, int k, Plan* p)
{
    const long s = (long)B * C * k;              // floats per node
    p->KS = (k + 7) / 8;
    p->NT = tiles_for(k);
    const int W = warps_for(p->NT);
    for (int G = B; G >= 1; --G) {
        const int gk = G * C * k;
        Plan c = *p;
        c.G = G;
        c.flat = G == B && s % 8 != 0;
        c.vec16 = s % 4 == 0 && (G == B || (C * k) % 4 == 0);
        if (c.flat) {
            c.sp = (int)s;
        } else {
            // 4 (mod 8) floats a node: the 8 rows of a fragment load hit
            // 8 distinct 4-bank groups
            c.sp = gk;
            while (c.sp % 8 != 4) ++c.sp;
        }
        const size_t ys = ys_bytes(G, c.KS, c.NT) + theta_bytes(G, c.NT);
        if (ys > kMaxShared) {
            // fewer designs: jump to the most that fit, the loop takes 1
            const size_t per = ys_bytes(1, c.KS, c.NT) + theta_bytes(1, c.NT);
            const long fit = (long)(kMaxShared / per);
            if (G > 1 && fit + 1 < G) G = (int)fit + 1;
            if (G == 1) return false;
            continue;
        }
        double best = -1.0;
        const int qmax = (int)std::max(1L, std::min((long)kMaxQ,
                                       (long)kTileFloats / (8L * c.sp)));
        for (int Q = 1; Q <= qmax; ++Q) {
            const int items = G * C * Q;
            const int J = (items + W - 1) / W;
            const size_t fixed = ys + sums_bytes(W, J, c.NT);
            const size_t stage = 2 * sizeof(float) * (size_t)8 * Q * c.sp;
            if (fixed + 2 * stage > kMaxShared) break;
            const long st = std::min((long)kMaxStages,
                                     (long)((kMaxShared - fixed) / stage));
            const double score = (double)items / (J * W) + 0.01 * (st >= 3);
            if (score > best + 1e-9) {
                best = score;
                c.Q = Q;
                c.J = J;
                c.stages = (int)st;
                c.bytes = fixed + st * stage;
            }
        }
        if (best < 0.0) {
            if (G == 1) return false;
            continue;
        }
        c.groups = (B + G - 1) / G;
        const long tiles = ((long)D + 8 * c.Q - 1) / (8 * c.Q);
        long per = (multiprocessors() + c.groups - 1) / c.groups;
        if (per > tiles) per = tiles;
        c.blocks = (int)(per < 1 ? 1 : per);
        *p = c;
        return true;
    }
    return false;
}

// D += A B on the tensor cores in TF32, f32 sums: A 16 x 8 (a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)) and B 8 x 8 (b0 (t,
// g), b1 (t + 4, g)), with lane = 4 g + t; D's d[0], d[1] are row g,
// columns 2 t and 2 t + 1, and d[2], d[3] row g + 8 there. The 16 rows
// are 8 nodes of AQ over the same 8 nodes of BQ, so a lane holds u and v
// of its node g.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// x = hi + lo, each a TF32 value
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo)
{
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
}

// One step of a recursive-halving sum over the lanes lane and lane ^ OFF:
// the lane without bit OFF keeps val[0, H) and adds its partner's, the
// other keeps val[H, 2H) and adds its partner's, into val[0, H).
template <int H, int OFF, typename T, int N>
__device__ __forceinline__ void halve(T (&val)[N], int lane)
{
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const T send = hi ? val[i] : val[i + H];
        const T keep = hi ? val[i + H] : val[i];
        val[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
}

// Issue the copies of tile `tile` (nodes 8 Q tile ...) of the block's
// designs into one stage (sa: AQ, sb: BQ) and commit them as one group.
template <int WARPS>
__device__ __forceinline__ void stage_tile(
    float* sa, float* sb, const float* __restrict__ AQ,
    const float* __restrict__ BQ, const Plan& p, long tile, int D, long s,
    size_t goff, int gk, int t)
{
    constexpr int NTH = WARPS * 32;
    const int TN = 8 * p.Q;
    const long d0 = tile * TN;
    const int nv = (int)min((long)TN, (long)D - d0);
    if (p.flat) {
        // one range of nv s floats from node d0: d0 s is a multiple of 4
        const size_t base = (size_t)d0 * s;
        const int n = nv * (int)s;
        const int n4 = n >> 2;
        const float* ga = AQ + base;
        const float* gb = BQ + base;
        for (int i = t; i < n4; i += NTH) {
            __pipeline_memcpy_async(sa + 4 * i, ga + 4 * i, 16);
            __pipeline_memcpy_async(sb + 4 * i, gb + 4 * i, 16);
        }
        for (int i = 4 * n4 + t; i < n; i += NTH) {
            __pipeline_memcpy_async(sa + i, ga + i, 4);
            __pipeline_memcpy_async(sb + i, gb + i, 4);
        }
    } else {
        const int warp = t >> 5, lane = t & 31;
        for (int nd = warp; nd < nv; nd += WARPS) {
            const size_t o = (size_t)(d0 + nd) * s + goff;
            float* da = sa + nd * p.sp;
            float* db = sb + nd * p.sp;
            if (p.vec16) {
                for (int i = 4 * lane; i < gk; i += 128) {
                    __pipeline_memcpy_async(da + i, AQ + o + i, 16);
                    __pipeline_memcpy_async(db + i, BQ + o + i, 16);
                }
            } else {
                for (int i = lane; i < gk; i += 32) {
                    __pipeline_memcpy_async(da + i, AQ + o + i, 4);
                    __pipeline_memcpy_async(db + i, BQ + o + i, 4);
                }
            }
        }
    }
    __pipeline_commit();
}

template <int NT>
__global__ void __launch_bounds__(warps_for(NT) * 32, 1)
ritz_rows_kernel(const float* __restrict__ AQ,     // (D, B, C, k)
                 const float* __restrict__ BQ,     // (D, B, C, k)
                 const float* __restrict__ Ys,     // (B, k, k)
                 const float* __restrict__ theta,  // (B, k)
                 int D, int B, int C, int k, Plan p,
                 double* __restrict__ partial)     // (B, blocks, 2, k)
{
    constexpr int WARPS = warps_for(NT);
    constexpr int NTH = WARPS * 32;
    constexpr int N8 = NT * 8;                   // padded columns
    constexpr int V = (4 * NT + 7) / 8 * 8;      // reduced values, padded
    extern __shared__ float4 smem4[];
    const int G = p.G, KS = p.KS, J = p.J, Q = p.Q, sp = p.sp;
    const int b0 = blockIdx.y * G;
    const int Gy = min(G, B - b0);
    float4* sY = smem4;                                      // (G, KS, NT, 32)
    double* sS = reinterpret_cast<double*>(sY + (size_t)G * KS * NT * 32);
    float* sT = reinterpret_cast<float*>(sS + WARPS * J * 2 * N8);
    // (stages, 2, tile)
    float* sTile = sT + theta_bytes(G, NT) / sizeof(float);
    const int tileF = 8 * Q * sp;
    const long s = (long)B * C * k;
    const size_t goff = (size_t)b0 * C * k;
    const int gk = Gy * C * k;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const int g = lane >> 2, tq = lane & 3;

    // B fragments of Ys: rows m and m + 4 of column l, each split
    for (int i = t; i < Gy * KS * NT * 32; i += NTH) {
        const int ln = i & 31;
        int r = i >> 5;
        const int nt = r % NT;
        r /= NT;
        const int ks = r % KS;
        const int bl = r / KS;
        const int m = ks * 8 + (ln & 3), l = nt * 8 + (ln >> 2);
        const float* yb = Ys + (size_t)(b0 + bl) * k * k;
        const float y0 = m < k && l < k ? yb[(size_t)m * k + l] : 0.0f;
        const float y1 = m + 4 < k && l < k ? yb[(size_t)(m + 4) * k + l]
                                            : 0.0f;
        uint32_t h0, l0, h1, l1;
        split_tf32(y0, h0, l0);
        split_tf32(y1, h1, l1);
        sY[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                            __uint_as_float(l0), __uint_as_float(l1));
    }
    for (int i = t; i < Gy * N8; i += NTH) {
        const int bl = i / N8, l = i - bl * N8;
        sT[i] = l < k ? theta[(size_t)(b0 + bl) * k + l] : 0.0f;
    }
    for (int i = t; i < WARPS * J * 2 * N8; i += NTH) sS[i] = 0.0;

    const long tiles = ((long)D + 8 * Q - 1) / (8 * Q);
    const int S = p.stages;
    // the ring: tiles blockIdx.x + i gridDim.x go to stage i % S
    for (int i = 0; i < S - 1; ++i) {
        const long tl = blockIdx.x + (long)i * gridDim.x;
        if (tl < tiles)
            stage_tile<WARPS>(sTile + (size_t)i * 2 * tileF,
                              sTile + ((size_t)i * 2 + 1) * tileF, AQ, BQ, p,
                              tl, D, s, goff, gk, t);
        else
            __pipeline_commit();                 // one group a tile
    }
    const int items = Gy * C * Q;
    int it = 0;
    for (long tl = blockIdx.x; tl < tiles; tl += gridDim.x, ++it) {
        // this tile's copies (the wait takes a constant), all threads',
        // and the last tile is read
        if (S == 2)
            __pipeline_wait_prior(0);
        else if (S == 3)
            __pipeline_wait_prior(1);
        else
            __pipeline_wait_prior(2);
        __syncthreads();
        {
            const long nx = tl + (long)(S - 1) * gridDim.x;
            const int st = (it + S - 1) % S;
            if (nx < tiles)
                stage_tile<WARPS>(sTile + (size_t)st * 2 * tileF,
                                  sTile + ((size_t)st * 2 + 1) * tileF, AQ,
                                  BQ, p, nx, D, s, goff, gk, t);
            else
                __pipeline_commit();
        }
        const float* sa = sTile + (size_t)(it % S) * 2 * tileF;
        const float* sb = sa + tileF;
        const int nv = (int)min((long)8 * Q, (long)D - tl * 8 * Q);
        for (int itm = warp, j = 0; itm < items; itm += WARPS, ++j) {
            // item (bl, c, q): nodes q*8 .. q*8 + 7, component c
            const int q = itm % Q;
            const int bc = itm / Q;              // bl * C + c
            const int bl = bc / C;
            const int node = q * 8 + g;
            const bool row_ok = node < nv;
            const float* ra = sa + node * sp + bc * k;
            const float* rb = sb + node * sp + bc * k;
            const float4* yb = sY + (size_t)bl * KS * NT * 32 + lane;
            float acc[NT][4];
#pragma unroll
            for (int n = 0; n < NT; ++n)
                acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll 2
            for (int ks = 0; ks < KS; ++ks) {
                const int col = ks * 8 + tq;
                const bool ok = row_ok && col < k;
                const bool ok4 = row_ok && col + 4 < k;
                uint32_t hi[4], lo[4];
                split_tf32(ok ? ra[col] : 0.0f, hi[0], lo[0]);
                split_tf32(ok ? rb[col] : 0.0f, hi[1], lo[1]);
                split_tf32(ok4 ? ra[col + 4] : 0.0f, hi[2], lo[2]);
                split_tf32(ok4 ? rb[col + 4] : 0.0f, hi[3], lo[3]);
                const float4* yk = yb + ks * NT * 32;
                float4 y[NT];
#pragma unroll
                for (int n = 0; n < NT; ++n) y[n] = yk[n * 32];
                // the small products first, then hi hi; each pass over
                // all column tiles, so neighbouring products are
                // independent
#pragma unroll
                for (int n = 0; n < NT; ++n)
                    mma_tf32(acc[n], lo, __float_as_uint(y[n].x),
                             __float_as_uint(y[n].y));
#pragma unroll
                for (int n = 0; n < NT; ++n)
                    mma_tf32(acc[n], hi, __float_as_uint(y[n].z),
                             __float_as_uint(y[n].w));
#pragma unroll
                for (int n = 0; n < NT; ++n)
                    mma_tf32(acc[n], hi, __float_as_uint(y[n].x),
                             __float_as_uint(y[n].y));
            }
            // R^2 and u^2 of this lane's node at columns 2 tq, 2 tq + 1 of
            // each tile: val[4 n + e] (e: R^2, R^2, u^2, u^2)
            float val[V];
            const float* th = sT + bl * N8 + 2 * tq;
#pragma unroll
            for (int n = 0; n < NT; ++n) {
                const float r0 = acc[n][0] - th[n * 8] * acc[n][2];
                const float r1 = acc[n][1] - th[n * 8 + 1] * acc[n][3];
                val[4 * n] = r0 * r0;
                val[4 * n + 1] = r1 * r1;
                val[4 * n + 2] = acc[n][0] * acc[n][0];
                val[4 * n + 3] = acc[n][1] * acc[n][1];
            }
#pragma unroll
            for (int i = 4 * NT; i < V; ++i) val[i] = 0.0f;
            // sum over the 8 nodes (lane bits 2-4) by recursive halving: a
            // lane keeps half its values at each step, V / 8 at the end
            halve<V / 2, 16>(val, lane);
            halve<V / 4, 8>(val, lane);
            halve<V / 8, 4>(val, lane);
            const int base = ((lane & 16) ? V / 2 : 0)
                             + ((lane & 8) ? V / 4 : 0)
                             + ((lane & 4) ? V / 8 : 0);
            double* slot = sS + ((size_t)warp * J + j) * 2 * N8;
#pragma unroll
            for (int i = 0; i < V / 8; ++i) {
                const int o = base + i;
                if (o < 4 * NT) {
                    const int e = o & 3;
                    const int l = (o >> 2) * 8 + 2 * tq + (e & 1);
                    slot[(e >> 1) * N8 + l] += (double)val[i];
                }
            }
        }
    }
    __syncthreads();
    // per design: its items' slots in item order, then one partial
    const int CQ = C * Q;
    for (int i = t; i < Gy * 2 * k; i += NTH) {
        const int bl = i / (2 * k);
        const int r = i - bl * 2 * k;
        const int which = r / k;
        const int l = r - which * k;
        double a = 0.0;
        for (int cq = 0; cq < CQ; ++cq) {
            const int itm = bl * CQ + cq;
            const int w = itm % WARPS, jj = itm / WARPS;
            a += sS[(((size_t)w * J + jj) * 2 + which) * N8 + l];
        }
        partial[(((size_t)(b0 + bl) * gridDim.x + blockIdx.x) * 2 + which)
                    * k
                + l] = a;
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

template <int NT>
cudaError_t launch_rows(const float* AQ, const float* BQ, const float* Ys,
                        const float* theta, int D, int B, int C, int k,
                        const Plan& p, double* partial, cudaStream_t s)
{
    cudaError_t rc = set_shared_limit(ritz_rows_kernel<NT>);
    if (rc != cudaSuccess) return rc;
    ritz_rows_kernel<NT><<<dim3(p.blocks, p.groups), warps_for(NT) * 32,
                           p.bytes, s>>>(AQ, BQ, Ys, theta, D, B, C, k, p,
                                         partial);
    return cudaGetLastError();
}

}  // namespace

// The partial array of pl_ritz_residual holds B times
// pl_ritz_residual_blocks(D, B, C, k) times 2 k doubles (0 if the shape
// is not taken).
extern "C" int pl_ritz_residual_blocks(int D, int B, int C, int k)
{
    Plan p;
    if (D < 1 || B < 1 || k < 1 || k > kMaxK || !make_plan(D, B, C, k, &p))
        return 0;
    return p.blocks;
}

extern "C" int pl_ritz_residual(
    const void* AQ, const void* BQ, const void* Ys, const void* theta,
    const void* cuts, int D, int B, int C, int k, int n_wanted,
    void* partial, void* res, void* gate, void* stream)
{
    Plan p;
    if (D < 1 || B < 1 || B > 65535 || (C != 1 && C != 3) || k < 1
        || k > kMaxK || (uintptr_t)AQ % 16 || (uintptr_t)BQ % 16
        || !make_plan(D, B, C, k, &p))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    const float* a = (const float*)AQ;
    const float* b = (const float*)BQ;
    const float* y = (const float*)Ys;
    const float* th = (const float*)theta;
    double* pp = (double*)partial;
    cudaError_t rc;
    switch (p.NT) {
    case 1: rc = launch_rows<1>(a, b, y, th, D, B, C, k, p, pp, s); break;
    case 2: rc = launch_rows<2>(a, b, y, th, D, B, C, k, p, pp, s); break;
    case 3: rc = launch_rows<3>(a, b, y, th, D, B, C, k, p, pp, s); break;
    case 4: rc = launch_rows<4>(a, b, y, th, D, B, C, k, p, pp, s); break;
    case 6: rc = launch_rows<6>(a, b, y, th, D, B, C, k, p, pp, s); break;
    case 8: rc = launch_rows<8>(a, b, y, th, D, B, C, k, p, pp, s); break;
    default: rc = launch_rows<12>(a, b, y, th, D, B, C, k, p, pp, s);
    }
    if (rc != cudaSuccess) return (int)rc;
    ritz_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
        pp, p.blocks, th, (const float*)cuts, B, k, n_wanted, (float*)res,
        (float*)gate);
    return (int)cudaGetLastError();
}
