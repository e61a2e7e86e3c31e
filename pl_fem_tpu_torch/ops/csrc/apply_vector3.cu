// K1: the packed A(beta_b) apply in one launch (fixed-beta curl-curl plus
// alpha * div penalty on P2 triangles), with its mask and park:
//
//     Y = m * sum_e A_e(beta_b) (m X)_e + park_b * (X - m X)
//
// Replaces pl_fem_tpu/ops/kernels.py _apply_vector3_fused (:453): the
// DOF gather, the q-loop of element math, _accumulate_fused and the
// epilogue, with no (E, 6, L) intermediate in device memory.
//
// Layout: X and Y are (D, L) with L = B * 3 * k lanes ordered (b, c, j),
// the JAX package's fused-lane layout; a (design, column) pair (b, j)
// owns the three lanes of its components c.
//
// Bound on the H100: operations. The function reads X once and writes Y
// once plus the element tables (~16 MB at B = 8, E = 30720), but every
// (element, pair) costs 233 f32 operations per quadrature point: values
// and gradients of the three components, the curl and divergence terms,
// the pull-back to the six nodes.
//
// Design: row-owned blocks with an element halo (the per-grid plan,
// ops/assembly.py apply_plan). Block (x, y) owns R rows of a Morton walk
// of the DOF coordinates (row block y) and the x-th lane chunk of
// kPairs pairs; the chunks vary fastest in the grid, so the blocks in
// flight cover a few row blocks whole and L2 reads and writes their
// rows' cache lines whole. A block evaluates every element with an
// entry among its rows, one thread per (element, pair) keeping the
// 6 x 3 gathered values and results in registers, and stores only the
// results of its own rows' entries into shared memory, at the entry's
// place in the block's entry list (numbered by row, then in
// transpose-table order). Each owned row then sums its consecutive
// entries in that order, as K2 does (no atomics, bitwise repeatable),
// applies mask and park and stores its lanes. Elements on block borders
// are evaluated once by each block they touch (the plan's
// ``recompute``, about 1.35 at R = 256 on the config-1 mesh); larger
// blocks cost shared memory.
//
// Latency: the block's prologue stages what its phases look up (the
// owned rows, their masks and entry offsets; each element's DOFs, their
// masks and entry slots) in shared memory, and asynchronous copies
// (cp.async) of the owned rows' X lanes that the epilogue reads land
// while the elements are evaluated. So an element's gather waits on one
// load and the row phase on none. The element tables are read from
// device memory as warp-uniform loads (half a warp per element), the
// gradients as float4: gp must start on 16 bytes.
//
// Padded elements carry w = 0 and contribute exactly 0; padded DOF rows
// have no entries and mask 0, so they return park_b * X.

#include <cuda_runtime.h>

#include "shared_limit.cuh"

namespace {

constexpr int kMaxQ = 16;
constexpr int kPairs = 16;                    // pairs per lane chunk
constexpr int kRowLanes = 3 * kPairs;         // lanes of a chunk

struct ApplyArgs {
    const float* X;            // (D, L)
    const int* elem_dofs;      // (E, 6)
    const float* gp;           // (E, Q, 6, 2)
    const float* w;            // (E, Q)
    const float* inv_eps;      // (B, E, Q)
    const float* betas;        // (B,)
    const float* Nref;         // (Q, 6)
    const float* mask;         // (D,)
    const float* parks;        // (B,)
    const int* order;          // (D,) the plan's row walk
    const int* row_ptr;        // (NB * R + 1,)
    const int* elems;          // (NB, HE)
    const int* n_elems;        // (NB,)
    const short* dst;          // (NB, HE, 6)
    float* Y;                  // (D, L)
    float alpha;
    int D, E, B, k, Q, R, HE, max_ent;
};

// dynamic shared memory of a block, in the order the kernel lays it out
// (ops/assembly.py apply_shared_bytes keeps the same count for the plan)
inline size_t shared_bytes(int R, int HE, int max_ent)
{
    return sizeof(float) * ((size_t)max_ent * kRowLanes   // s_ye
                            + (size_t)R * kRowLanes          // s_x
                            + R)                             // s_m
        + sizeof(int) * ((size_t)2 * R + 1                   // s_rp, s_row
                         + (size_t)HE * 7)                   // s_elem, s_dof
        + sizeof(float) * (size_t)HE * 6                     // s_em
        + sizeof(short) * (size_t)HE * 6;                    // s_dst
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src));
}

// m * acc + park * (x - x * m), rounded as the plain twin's separate ops
__device__ __forceinline__ float epilogue(float acc, float m, float x,
                                          float pk)
{
    return __fadd_rn(__fmul_rn(acc, m),
                     __fmul_rn(pk, __fsub_rn(x, __fmul_rn(x, m))));
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
apply_vector3_kernel(const ApplyArgs p)
{
    constexpr int kSlots = THREADS / kPairs;        // elements at once
    constexpr int kRowStep = THREADS / kRowLanes;   // rows summed at once
    extern __shared__ float4 smem4[];
    float* s_ye = reinterpret_cast<float*>(smem4);  // (max_ent, 3, kPairs)
    float* s_x = s_ye + (size_t)p.max_ent * kRowLanes;   // (R, 3, kPairs)
    float* s_m = s_x + (size_t)p.R * kRowLanes;     // (R,) owned rows' mask
    int* s_rp = reinterpret_cast<int*>(s_m + p.R);  // (R + 1,) entry offsets
    int* s_row = s_rp + p.R + 1;                    // (R,) owned rows
    int* s_elem = s_row + p.R;                      // (HE,) elements
    int* s_dof = s_elem + p.HE;                     // (HE, 6) their DOFs
    float* s_em = reinterpret_cast<float*>(s_dof + 6 * p.HE);  // masks
    short* s_dst = reinterpret_cast<short*>(s_em + 6 * p.HE);  // entries
    __shared__ float sN[kMaxQ * 6];

    const int tid = threadIdx.x;
    const int blk = blockIdx.y;
    const int npairs = p.B * p.k;
    const int pair0 = blockIdx.x * kPairs;
    const size_t L = (size_t)3 * npairs;
    const int p0 = blk * p.R;
    const int rows = min(p.R, p.D - p0);
    const int nel = p.n_elems[blk];

    // -- prologue: stage the lookups --------------------------------------
    for (int i = tid; i < p.Q * 6; i += THREADS) sN[i] = p.Nref[i];
    for (int r = tid; r <= rows; r += THREADS) s_rp[r] = p.row_ptr[p0 + r];
    for (int r = tid; r < rows; r += THREADS) {
        const int d = p.order[p0 + r];
        s_row[r] = d;
        s_m[r] = p.mask[d];
    }
    for (int s = tid; s < nel; s += THREADS)
        s_elem[s] = p.elems[(size_t)blk * p.HE + s];
    for (int t = tid; t < 6 * nel; t += THREADS) {
        const int s = t / 6;
        const int d = p.elem_dofs[(size_t)p.elems[(size_t)blk * p.HE + s] * 6
                                  + (t - 6 * s)];
        s_dof[t] = d;
        s_em[t] = p.mask[d];
        s_dst[t] = p.dst[(size_t)blk * p.HE * 6 + t];
    }
    __syncthreads();

    // a thread's lane of the chunk in the copy and row phases (threads
    // past kRowStep * kRowLanes have none)
    const int lam = tid % kRowLanes;               // c * kPairs + offset
    const int lc = lam / kPairs;
    const int rpair = pair0 + lam - lc * kPairs;
    const bool rlive = tid < kRowStep * kRowLanes && rpair < npairs;
    const int rb = rlive ? rpair / p.k : 0;
    const size_t l = (size_t)rb * 3 * p.k + (size_t)lc * p.k
                     + (rpair - rb * p.k);
    // the owned rows' X lanes for the epilogue, landing while the
    // elements are evaluated
    if (rlive) {
        for (int r = tid / kRowLanes; r < rows; r += kRowStep)
            cp_async4(s_x + r * kRowLanes + lam,
                      p.X + (size_t)s_row[r] * L + l);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    // -- element phase: thread (slot, pair) ------------------------------
    const int pp = tid % kPairs;
    const int pair = pair0 + pp;
    if (pair < npairs) {
        const int b = pair / p.k;
        const size_t off = (size_t)b * 3 * p.k + (pair - b * p.k);
        const float beta = p.betas[b];
        for (int s = tid / kPairs; s < nel; s += kSlots) {
            const int e = s_elem[s];
            float u[6][3];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                const float m = s_em[6 * s + i];
                const float* xr = p.X + (size_t)s_dof[6 * s + i] * L + off;
                u[i][0] = __fmul_rn(__ldg(xr), m);
                u[i][1] = __fmul_rn(__ldg(xr + p.k), m);
                u[i][2] = __fmul_rn(__ldg(xr + 2 * p.k), m);
            }
            float y[6][3];
#pragma unroll
            for (int i = 0; i < 6; ++i)
                y[i][0] = y[i][1] = y[i][2] = 0.0f;

            const float* ie = p.inv_eps + ((size_t)b * p.E + e) * p.Q;
            const float4* ge = reinterpret_cast<const float4*>(
                p.gp + (size_t)e * p.Q * 12);
            const float* we = p.w + (size_t)e * p.Q;
#pragma unroll 2
            for (int q = 0; q < p.Q; ++q) {
                const float* Nq = sN + q * 6;
                float g[12];              // (6, 2): dx, dy per node
#pragma unroll
                for (int t = 0; t < 3; ++t) {
                    const float4 z = __ldg(ge + 3 * q + t);
                    g[4 * t] = z.x;
                    g[4 * t + 1] = z.y;
                    g[4 * t + 2] = z.z;
                    g[4 * t + 3] = z.w;
                }
                float V[3], Gx[3], Gy[3];
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    float v = 0.0f, gx = 0.0f, gy = 0.0f;
#pragma unroll
                    for (int i = 0; i < 6; ++i) {
                        v = fmaf(Nq[i], u[i][c], v);
                        gx = fmaf(g[2 * i], u[i][c], gx);
                        gy = fmaf(g[2 * i + 1], u[i][c], gy);
                    }
                    V[c] = v; Gx[c] = gx; Gy[c] = gy;
                }
                const float c1 = Gy[2] - beta * V[1];      // dy hz - b hy
                const float c2 = beta * V[0] - Gx[2];      // b hx - dx hz
                const float c3 = Gx[1] - Gy[0];            // dx hy - dy hx
                const float dv = Gx[0] + Gy[1] - beta * V[2];
                const float wq = __ldg(we + q);
                const float wi = wq * __ldg(ie + q);
                const float wa = wq * p.alpha;
                const float c1h = wi * c1, c2h = wi * c2, c3h = wi * c3;
                const float dvh = wa * dv;
                // value channel S and gradient channels Tx, Ty
                const float S[3] = {beta * c2h, -beta * c1h,
                                    -beta * dvh};
                const float Tx[3] = {dvh, c3h, -c2h};
                const float Ty[3] = {-c3h, dvh, c1h};
#pragma unroll
                for (int i = 0; i < 6; ++i) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        y[i][c] = fmaf(Nq[i], S[c], y[i][c]);
                        y[i][c] = fmaf(g[2 * i], Tx[c], y[i][c]);
                        y[i][c] = fmaf(g[2 * i + 1], Ty[c], y[i][c]);
                    }
                }
            }
            // keep the results of this block's own entries
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                const int t = s_dst[6 * s + i];
                if (t >= 0) {
#pragma unroll
                    for (int c = 0; c < 3; ++c)
                        s_ye[(t * 3 + c) * kPairs + pp] = y[i][c];
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // -- row phase: thread (row, lane of the chunk) ----------------------
    if (rlive) {
        const float pk = p.parks[rb];
        const int e_base = s_rp[0];
        for (int r = tid / kRowLanes; r < rows; r += kRowStep) {
            const int t1 = s_rp[r + 1] - e_base;
            float acc = 0.0f;
            for (int t = s_rp[r] - e_base; t < t1; ++t)
                acc = __fadd_rn(acc, s_ye[t * kRowLanes + lam]);
            p.Y[(size_t)s_row[r] * L + l] =
                epilogue(acc, s_m[r], s_x[r * kRowLanes + lam], pk);
        }
    }
}

template <int THREADS>
cudaError_t launch(const ApplyArgs& p, cudaStream_t stream)
{
    const size_t shmem = shared_bytes(p.R, p.HE, p.max_ent);
    const cudaError_t err = set_shared_limit(
        apply_vector3_kernel<THREADS>);
    if (err != cudaSuccess) return err;
    // the chunks of a row block vary fastest: the blocks in flight share
    // their rows' cache lines, which L2 then reads and writes whole
    const dim3 grid((p.B * p.k + kPairs - 1) / kPairs,
                    (p.D + p.R - 1) / p.R);
    apply_vector3_kernel<THREADS><<<grid, THREADS, shmem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Rows per block R, element-halo width HE and the most entries a block
// holds (max_ent) come from the plan. Blocks of 256 rows or more take
// 512 threads, one block per SM; smaller ones 256, two per SM.
extern "C" int pl_apply_vector3(
    const void* X, const void* elem_dofs, const void* gp, const void* w,
    const void* inv_eps, const void* betas, const void* Nref,
    const void* mask, const void* parks, const void* order,
    const void* row_ptr, const void* elems, const void* n_elems,
    const void* dst, float alpha, int D, int E, int B, int k, int Q, int R,
    int HE, int max_ent, void* Y, void* stream)
{
    if (D < 1 || E < 1 || B < 1 || k < 1 || Q < 1 || Q > kMaxQ || R < 1
        || HE < 1 || max_ent < 1 || max_ent > 32767
        || shared_bytes(R, HE, max_ent) > kMaxShared
        || reinterpret_cast<size_t>(gp) % 16)
        return (int)cudaErrorInvalidValue;
    ApplyArgs p;
    p.X = (const float*)X;
    p.elem_dofs = (const int*)elem_dofs;
    p.gp = (const float*)gp;
    p.w = (const float*)w;
    p.inv_eps = (const float*)inv_eps;
    p.betas = (const float*)betas;
    p.Nref = (const float*)Nref;
    p.mask = (const float*)mask;
    p.parks = (const float*)parks;
    p.order = (const int*)order;
    p.row_ptr = (const int*)row_ptr;
    p.elems = (const int*)elems;
    p.n_elems = (const int*)n_elems;
    p.dst = (const short*)dst;
    p.Y = (float*)Y;
    p.alpha = alpha;
    p.D = D;
    p.E = E;
    p.B = B;
    p.k = k;
    p.Q = Q;
    p.R = R;
    p.HE = HE;
    p.max_ent = max_ent;
    const cudaStream_t s = (cudaStream_t)stream;
    if (R >= 256) return (int)launch<512>(p, s);
    return (int)launch<256>(p, s);
}
