// K5: the stacked-block operator apply in one launch, for C = 1 (the
// scalar Helmholtz pencil) and C = 3 (the fixed-beta vectorial operator
// from its assembled (E, 18, 18) blocks):
//
//     Y = m * sum_e A_e (m X)_e + park * (X - m X)
//
// Replaces pl_fem_tpu/ops/kernels.py _apply_stacked (:74) together with
// its _accumulate (:53): the DOF gather, the per-element product (the
// einsum "eij,ejk->eik" at Precision.HIGHEST), the element -> DOF sum and
// the mask / park epilogue, with no (C, E, 6, k) intermediate in device
// memory.
//
// Layout: X and Y are the stacked component-major blocks (C * D, k); row
// c * D + d is component c of DOF d. The mask (D,) is the same for every
// component, park (k,) is one value per column (lane).
//
// Bound on the H100: bytes. The function reads the blocks (36 C^2 E
// floats), X, the mask, park and the plan's tables once and writes Y
// once; its 36 C^2 FMAs per (element, column) are far under the f32 roof.
//
// Design: K1's (apply_vector3.cu), on the same per-grid plan
// (ops/assembly.py apply_plan). Block (x, y) owns the R rows of row block
// y of a Morton walk of the DOF coordinates, for all C components, and
// lane chunk x of LC = min(k, 48 / C) columns: at C = 1 and k <= 48 one
// chunk holds whole rows, so a block gathers and stores whole row
// segments and the chunk grid is one wide. The block evaluates every
// element with an entry among its rows (its element halo). A thread owns
// V lanes of one element (4 at C = 1, 2 at C = 3), spaced so that the
// threads of an element gather contiguous row segments; it holds the
// element's 6C masked inputs for them in registers, so each entry of the
// element block it reads and each lookup serves V columns. Each result
// row is a chain of plain f32 FMAs over j = 0 .. 6C - 1 in order (no
// TF32, no tensor cores; all 36 C^2 entries are read, the symmetry is
// not used). At C = 1 the entries come through L1 (the threads of an
// element read the same addresses), so a block's shared memory (the
// entries' lanes, ~100 KB at k = 27) leaves room for two blocks per SM;
// at C = 3 each 18 x 18 block is staged in shared memory once per block,
// in batches of ``nb``.
// Only the results of the block's own entries are kept, in shared memory
// at the entry's place in the block's entry list (numbered by row, then
// in transpose-table order). Each owned row then sums its consecutive
// entries in that order, as K2 does (no atomics, bitwise repeatable),
// applies mask and park and stores its lanes. Elements on block borders
// are evaluated once by each block they touch (the plan's
// ``recompute``).
//
// Padded DOF rows have no entries and mask 0, so they return park * X.

#include <cuda_runtime.h>

#include "shared_limit.cuh"

namespace {

constexpr int kChunkFloats = 48;              // C * LC: floats per entry

// rows a thread loads at once in the row phase
constexpr int kStage = 4;

// lanes a thread evaluates of one element: the element's entries and
// lookups are read once for all of them
constexpr int lanes_per_thread(int C) { return C == 1 ? 4 : 2; }

struct StackedArgs {
    const float* X;            // (C D, k)
    const float* Abig;         // (E, 6C, 6C)
    const float* mask;         // (D,)
    const float* park;         // (k,)
    const int* order;          // (D,) the plan's row walk
    const int* row_ptr;        // (NB * R + 1,)
    const int* elems;          // (NB, HE)
    const int* n_elems;        // (NB,)
    const short* dst;          // (NB, HE, 6)
    const int* dofs;           // (NB, HE, 6)
    float* Y;                  // (C D, k)
    int D, k, R, HE, max_ent, LC, nb;
};

// dynamic shared memory of a block, in the order the kernel lays it out
// (nb = 0 at C = 1: no staged element blocks)
inline size_t shared_bytes(int C, int R, int HE, int max_ent, int LC,
                           int nb)
{
    return sizeof(float) * ((size_t)nb * 36 * C * C       // s_A
                            + (size_t)max_ent * C * LC)   // s_ye
        + sizeof(int) * ((size_t)2 * R + 1                // s_rp, s_row
                         + (size_t)HE * 7)                // s_elem, s_dof
        + sizeof(short) * (size_t)HE * 6;                 // s_dst
}

// m * acc + park * (x - x * m), rounded as the plain twin's separate ops
__device__ __forceinline__ float epilogue(float acc, float m, float x,
                                          float pk)
{
    return __fadd_rn(__fmul_rn(acc, m),
                     __fmul_rn(pk, __fsub_rn(x, __fmul_rn(x, m))));
}

template <int C, int THREADS, int V>
__global__ void __launch_bounds__(THREADS, C == 1 ? 1024 / THREADS : 1)
apply_stacked_kernel(const StackedArgs p)
{
    constexpr int R6 = 6 * C;                     // rows of an element block
    constexpr int RR = R6 * R6;
    extern __shared__ float4 smem4[];
    const int W = C * p.LC;                       // floats per entry or row
    float* s_A = reinterpret_cast<float*>(smem4);           // (nb, R6, R6)
    float* s_ye = s_A + (size_t)p.nb * RR;                   // (max_ent, W)
    int* s_rp =                                     // (R + 1,) entry offsets
        reinterpret_cast<int*>(s_ye + (size_t)p.max_ent * W);
    int* s_row = s_rp + p.R + 1;                    // (R,) owned rows
    int* s_elem = s_row + p.R;                      // (HE,) elements
    int* s_dof = s_elem + p.HE;                     // (HE, 6) their DOFs
    short* s_dst = reinterpret_cast<short*>(s_dof + 6 * p.HE);  // entries

    const int tid = threadIdx.x;
    const int blk = blockIdx.y;
    const int lane0 = blockIdx.x * p.LC;
    const int nl = min(p.LC, p.k - lane0);        // live lanes of the chunk
    const int p0 = blk * p.R;
    const int rows = min(p.R, p.D - p0);
    const int nel = p.n_elems[blk];

    // -- prologue: stage the lookups --------------------------------------
    // the plan's tables only: no load waits on another (the masks are read
    // beside the rows that need them)
    for (int r = tid; r <= rows; r += THREADS) s_rp[r] = p.row_ptr[p0 + r];
    for (int r = tid; r < rows; r += THREADS) s_row[r] = p.order[p0 + r];
    for (int s = tid; s < nel; s += THREADS)
        s_elem[s] = p.elems[(size_t)blk * p.HE + s];
    for (int t = tid; t < 6 * nel; t += THREADS) {
        s_dof[t] = p.dofs[(size_t)blk * p.HE * 6 + t];
        s_dst[t] = p.dst[(size_t)blk * p.HE * 6 + t];
    }

    // -- element phase: thread (slot, lane group) --------------------------
    // A thread owns V lanes of one element, lb, lb + TPE, ..., so that
    // every entry of the element block it reads, and every lookup, serves
    // V columns; TPE threads cover an element's lanes and SPI elements are
    // evaluated at once. C = 1 reads its 36 entries through L1, which
    // leaves shared memory for two blocks per SM; C = 3 stages its 324 in
    // batches of nb elements.
    const int tpe = (nl + V - 1) / V;
    const int spi = THREADS / tpe;
    const int so = tid / tpe;
    const int lb = tid - so * tpe;
    const int batch = C == 1 ? max(nel, 1) : p.nb;
    for (int s0 = 0; s0 < nel; s0 += batch) {
        const int ns = min(batch, nel - s0);
        __syncthreads();          // the lookups, or the last batch's blocks
        if constexpr (C != 1) {
            for (int t = tid; t < ns * RR; t += THREADS) {
                const int s = t / RR;
                s_A[t] = __ldg(p.Abig + (size_t)s_elem[s0 + s] * RR
                               + (t - s * RR));
            }
            __syncthreads();
        }
        if (so >= spi) continue;
        for (int sl = s0 + so; sl < s0 + ns; sl += spi) {
            float m[6], u[R6][V];
#pragma unroll
            for (int i = 0; i < 6; ++i)
                m[i] = __ldg(p.mask + s_dof[6 * sl + i]);
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
                for (int i = 0; i < 6; ++i) {
                    const float* xr = p.X + ((size_t)c * p.D
                                             + s_dof[6 * sl + i]) * p.k
                                      + lane0 + lb;
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        u[6 * c + i][v] = lb + v * tpe < nl
                            ? __fmul_rn(__ldg(xr + v * tpe), m[i]) : 0.0f;
                }
            }
            const float* A = C == 1 ? p.Abig + (size_t)s_elem[sl] * RR
                                    : s_A + (size_t)(sl - s0) * RR;
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                const int t = s_dst[6 * sl + i];
                if (t < 0) continue;              // another block's row
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    const int r = 6 * c + i;
                    float acc[V];
#pragma unroll
                    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
#pragma unroll
                    for (int j = 0; j < R6; ++j) {
                        const float a = C == 1 ? __ldg(A + r * R6 + j)
                                               : A[r * R6 + j];
#pragma unroll
                        for (int v = 0; v < V; ++v)
                            acc[v] = fmaf(a, u[j][v], acc[v]);
                    }
                    float* ye = s_ye + t * W + c * p.LC + lb;
#pragma unroll
                    for (int v = 0; v < V; ++v)
                        if (lb + v * tpe < nl) ye[v * tpe] = acc[v];
                }
            }
        }
    }
    __syncthreads();

    // -- row phase: thread (row, component, lane), kStage rows at once ---
    // a thread keeps its component and lane; rpi rows are summed at once
    const int wl = C * nl;
    const int rpi = THREADS / wl;
    const int rq = tid / wl;
    if (rq >= rpi) return;
    const int col = tid - rq * wl;
    const int c = col / nl;
    const int l = col - c * nl;
    const int sc = c * p.LC + l;                  // the lane's shared column
    const float pk = __ldg(p.park + lane0 + l);
    const float* xc = p.X + (size_t)c * p.D * p.k + lane0 + l;
    float* yc = p.Y + (size_t)c * p.D * p.k + lane0 + l;
    const int e_base = s_rp[0];
    for (int r0 = rq; r0 < rows; r0 += kStage * rpi) {
        float x[kStage], m[kStage];
        size_t off[kStage];
#pragma unroll
        for (int h = 0; h < kStage; ++h) {        // all rows' loads first
            const int d = s_row[min(r0 + h * rpi, rows - 1)];
            off[h] = (size_t)d * p.k;
            x[h] = __ldg(xc + off[h]);
            m[h] = __ldg(p.mask + d);
        }
#pragma unroll
        for (int h = 0; h < kStage; ++h) {
            const int r = r0 + h * rpi;
            if (r >= rows) continue;
            const int t1 = s_rp[r + 1] - e_base;
            float acc = 0.0f;
            for (int t = s_rp[r] - e_base; t < t1; ++t)
                acc = __fadd_rn(acc, s_ye[t * W + sc]);
            yc[off[h]] = epilogue(acc, m[h], x[h], pk);
        }
    }
}

template <int C, int THREADS>
cudaError_t launch(const StackedArgs& p, size_t shmem, cudaStream_t stream)
{
    const cudaError_t err = set_shared_limit(
        apply_stacked_kernel<C, THREADS, lanes_per_thread(C)>);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.k + p.LC - 1) / p.LC, (p.D + p.R - 1) / p.R);
    apply_stacked_kernel<C, THREADS, lanes_per_thread(C)>
        <<<grid, THREADS, shmem, stream>>>(p);
    return cudaGetLastError();
}

template <int C>
cudaError_t launch_c(StackedArgs p, cudaStream_t stream)
{
    p.LC = p.k < kChunkFloats / C ? p.k : kChunkFloats / C;
    const int threads = p.R >= 256 ? 512 : 256;
    // C = 3 stages its element blocks in batches of at most one block per
    // slot of a pass, as many as fit; C = 1 stages none
    p.nb = 0;
    const size_t base = shared_bytes(C, p.R, p.HE, p.max_ent, p.LC, 0);
    if (base > kMaxShared) return cudaErrorInvalidValue;
    if (C != 1) {
        const int fit =
            (int)((kMaxShared - base) / (sizeof(float) * 36 * C * C));
        // one batch per pass of the element phase
        int nb = threads / ((p.LC + lanes_per_thread(C) - 1)
                            / lanes_per_thread(C));
        nb = nb < p.HE ? nb : p.HE;
        p.nb = nb < fit ? nb : fit;
        if (p.nb < 1) return cudaErrorInvalidValue;
    }
    const size_t shmem = shared_bytes(C, p.R, p.HE, p.max_ent, p.LC, p.nb);
    if (threads == 512) return launch<C, 512>(p, shmem, stream);
    return launch<C, 256>(p, shmem, stream);
}

}  // namespace

// Rows per block R, element-halo width HE and the most entries a block
// holds (max_ent) come from the plan. Blocks of 256 rows or more take 512
// threads, smaller ones 256.
extern "C" int pl_apply_stacked(
    const void* X, const void* Abig, const void* mask, const void* park,
    const void* order, const void* row_ptr, const void* elems,
    const void* n_elems, const void* dst, const void* dofs, int D, int k,
    int C, int R, int HE, int max_ent, void* Y, void* stream)
{
    if (D < 1 || k < 1 || (C != 1 && C != 3) || R < 1 || HE < 1
        || max_ent < 1 || max_ent > 32767)
        return (int)cudaErrorInvalidValue;
    StackedArgs p;
    p.X = (const float*)X;
    p.Abig = (const float*)Abig;
    p.mask = (const float*)mask;
    p.park = (const float*)park;
    p.order = (const int*)order;
    p.row_ptr = (const int*)row_ptr;
    p.elems = (const int*)elems;
    p.n_elems = (const int*)n_elems;
    p.dst = (const short*)dst;
    p.dofs = (const int*)dofs;
    p.Y = (float*)Y;
    p.D = D;
    p.k = k;
    p.R = R;
    p.HE = HE;
    p.max_ent = max_ent;
    p.LC = p.nb = 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (C == 1) return (int)launch_c<1>(p, s);
    return (int)launch_c<3>(p, s);
}
