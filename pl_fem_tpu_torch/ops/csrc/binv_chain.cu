// K12: the Chebyshev B^{-1} semi-iteration of degree >= 2 in one
// cooperative launch: K3's step chain (csrc/mass_apply.cu in step mode,
// one launch per degree step) with the same arithmetic row by row.
//
// Step i of degree d (s the Jacobi scale, m the mask, V the step's
// input block):
//     V  = i == 0 ? (s * W) / theta : Dd        (R0 = s W, Z0 = 0)
//     R' = R - s * M~(s * V)
//     Z' = Z + V
//     Dd' = a_i * V + b_i * R'
//     i == d - 1 ? out = s * (Z' + Dd') : (R = R', Z = Z', Dd = Dd')
// M~(s V) at a row sums, over the row's entries (e, i) in table order,
// sum_j C_ij(e) U(dof(e, j)) with U = m * (s * V), K3's gathered operand.
//
// Design. The grid is what the card holds at once (cudaLaunchCooperative
// Kernel, sized by the occupancy API). CTA c owns a fixed contiguous
// range of the mass plan's 32-row Morton blocks (assembly.mass_plan) for
// all d steps, and a grid barrier (cooperative_groups grid sync)
// precedes every step. Each row's owner forms U of its own row, K3's
// operand rounding done once at the source: U_0 before the first
// barrier, U_{i+1} beside Dd' in step i. U is the only block other rows
// read, through the plan's halos; it ping-pongs between two device
// buffers of rows padded to a multiple of 4 lanes, so a CTA stages a
// halo row's lanes with 16-byte asynchronous copies (cp.async.cg, from
// L2) and, double-buffered, stages the next (block, lane chunk) item
// while the current one sums. Dd, R and Z are read and written by their
// own rows alone: Dd in place in a device buffer; R and Z in shared
// memory from the first step to the last where a layout holds them (the
// on-chip regime), otherwise in two device buffers, in the same single
// launch. The host wrapper makes that choice (cuda_kernels.binv_on_chip,
// a pure function of D, L, the SM count and what pl_binv_chain_limits
// says one CTA alone on its SM has left for R and Z) and passes it.
//
// A block's tables (its rows' entry offsets, DOFs, masks and Jacobi
// scales; its halo rows; every entry's six coefficients C_ij = sum_q
// N_qi N_qj w_eq and halo slots) form one record in shared memory,
// staged once for the chain for as many of the CTA's blocks as fit, and
// once per step, into one spare record, for the rest. Each owned row
// sums its entries from the staged halo and runs the step's update with
// K3's arithmetic: the same operand rounding, entry order and R, Z and
// Dd updates, so the result equals the K3 chain bit for bit.
//
// Bound on the H100: at L = 22 on the config-1 mesh a step reads U
// through the halos (~2.6 rows per owned row, from L2) and writes U and
// Dd once; R and Z never reach device memory. A step's floor is the
// shared-memory reads of the gathered rows (18 a row).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>

#include "shared_limit.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 32;            // DOF rows per plan block (kRows of K3)
constexpr int kThreads = 256;
constexpr int kChunk = 64;           // lanes staged per item, at most
constexpr int kLanes = 4;            // lanes a thread sums
constexpr int kMaxQ = 16;
constexpr int kMaxDegree = 64;
constexpr int kMaxCtasPerSm = 2048 / kThreads;

// A block's record, in 32-bit words: entry offsets (kRows + 1), DOFs,
// masks and scales of the rows (kRows each), the halo's size (1) and
// rows (H), then from an even word the entries' coefficients (6 an
// entry, read as 3 float2) and halo slots (6 16-bit slots an entry, read
// as 3 words).
constexpr int kPtr = 0;
constexpr int kDof = kPtr + kRows + 1;
constexpr int kMd = kDof + kRows;
constexpr int kSd = kMd + kRows;
constexpr int kNh = kSd + kRows;
constexpr int kHalo = kNh + 1;

__host__ __device__ inline int coef_word(int H)
{
    return (kHalo + H + 1) & ~1;
}

__host__ __device__ inline int record_words(int H, int max_ent)
{
    return (coef_word(H) + 9 * max_ent + 3) & ~3;
}

struct ChainArgs {
    const float* W;            // (D, L) the input
    const float* w;            // (E, Q)
    const float* Nref;         // (Q, 6)
    const int* order;          // (D,) the plan's row walk
    const int* halo;           // (NB, H), -1 past a block's halo
    const int* n_halo;         // (NB,)
    const int* row_ptr;        // (NB * kRows + 1,)
    const int* ent;            // (n_entries,) flat e * 6 + i
    const short* loc;          // (n_entries, 6) halo slots
    const float* mask;         // (D,)
    const float* ds;           // (D,)
    float* U[2];               // (D, Lp) U of even / odd steps
    float* Dd;                 // (D, Lp) own rows, in place
    float* out;                // (D, L)
    float* R;                  // (D, L) by plan position, device regime
    float* Z;
    float a[kMaxDegree], b[kMaxDegree];
    float theta;
    int D, NB, H, max_ent, Q, L, degree;
    int Lp;                    // L rounded up to 4 lanes
    int Lc;                    // lanes of a staged chunk
    int bpc;                   // most blocks a CTA owns
    int nres;                  // blocks whose record stays staged
    int rec_words;
    bool on_chip;
};

struct Record {
    int* ptr;
    int* dof;
    float* md;
    float* sd;
    int* nh;
    int* hg;
    float* c;
    unsigned short* slot;
};

__device__ __forceinline__ Record record_in(const ChainArgs& p,
                                           float* s_rec, int slot)
{
    float* base = s_rec + (size_t)slot * p.rec_words;
    int* wd = reinterpret_cast<int*>(base);
    Record r;
    r.ptr = wd + kPtr;
    r.dof = wd + kDof;
    r.md = base + kMd;
    r.sd = base + kSd;
    r.nh = wd + kNh;
    r.hg = wd + kHalo;
    r.c = base + coef_word(p.H);
    r.slot = reinterpret_cast<unsigned short*>(base + coef_word(p.H)
                                               + 6 * p.max_ent);
    return r;
}

// VEC-vectors of a (rows, L) block: the input W through the read-only
// path (NC), or R and Z (shared or device memory, read and written by
// this thread alone) through a generic pointer.
template <int VEC, bool NC>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[VEC])
{
    if constexpr (VEC == 4) {
        const float4 t = NC ? __ldg(reinterpret_cast<const float4*>(p))
                            : *reinterpret_cast<const float4*>(p);
        r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
    } else if constexpr (VEC == 2) {
        const float2 t = NC ? __ldg(reinterpret_cast<const float2*>(p))
                            : *reinterpret_cast<const float2*>(p);
        r[0] = t.x; r[1] = t.y;
    } else {
        r[0] = NC ? __ldg(p) : *p;
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

// A thread's kLanes consecutive lanes of a row of L lanes at p (lane
// l), as kLanes / VEC VEC-vectors; vectors at or past lane1 read as 0
// and are not stored.
template <int VEC, bool NC>
__device__ __forceinline__ void load_lanes(const float* p, int l, int lane1,
                                           float (&r)[kLanes])
{
#pragma unroll
    for (int m = 0; m < kLanes / VEC; ++m) {
        float t[VEC];
        if (l + m * VEC < lane1) {
            load_vec<VEC, NC>(p + m * VEC, t);
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

// K3's operand of a row with mask m and Jacobi scale s: OP 1 a step's
// m (s Dd), OP 2 the first step's m (s (s W / theta)).
template <int OP>
__device__ __forceinline__ float operand(float x, float m, float s,
                                         float inv_theta)
{
    if constexpr (OP == 1) x = __fmul_rn(s, x);
    if constexpr (OP == 2)
        x = __fmul_rn(s, __fmul_rn(__fmul_rn(s, x), inv_theta));
    return __fmul_rn(x, m);
}

// The records of the n blocks from block b into the record slots from
// slot, by all threads; ends in a barrier. Each phase covers all n
// records, so their loads are in flight together.
__device__ __forceinline__ void stage_records(const ChainArgs& p,
                                              float* s_rec, int b, int n,
                                              int slot)
{
    const int tid = threadIdx.x;
    for (int t = tid; t < n * (kRows + 1); t += kThreads) {
        const int j = t / (kRows + 1);
        const int i = t - j * (kRows + 1);
        const int p0 = (b + j) * kRows;
        const Record r = record_in(p, s_rec, slot + j);
        r.ptr[i] = p.row_ptr[p0 + i];
        if (i < kRows) {
            const int d = p0 + i < p.D ? p.order[p0 + i] : 0;
            r.dof[i] = d;
            r.md[i] = p.mask[d];
            r.sd[i] = p.ds[d];
        } else {
            *r.nh = p.n_halo[b + j];
        }
    }
    for (int t = tid; t < n * p.H; t += kThreads) {
        const int j = t / p.H;
        const int h = t - j * p.H;
        record_in(p, s_rec, slot + j).hg[h] =
            p.halo[(size_t)(b + j) * p.H + h];
    }
    __syncthreads();
    const int per = 6 * p.max_ent;
    for (int t = tid; t < n * per; t += kThreads) {
        const int j = t / per;
        const int u = t - j * per;
        const Record r = record_in(p, s_rec, slot + j);
        const int e0 = r.ptr[0];
        if (u >= 6 * (r.ptr[kRows] - e0)) continue;
        const int k = u / 6;
        const int jj = u - 6 * k;
        const int f = p.ent[e0 + k];
        const int e = f / 6;
        const int i = f - 6 * e;
        float c = 0.0f;
        for (int q = 0; q < p.Q; ++q)
            c = fmaf(p.Nref[q * 6 + i] * p.Nref[q * 6 + jj],
                     p.w[(size_t)e * p.Q + q], c);
        r.c[u] = c;
        r.slot[u] = (unsigned short)p.loc[(size_t)e0 * 6 + u];
    }
    __syncthreads();
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Item it's halo lanes of U into the staging area s_x (nh, Lc), by all
// threads, as one group of asynchronous copies.
__device__ __forceinline__ void stage_item(const ChainArgs& p,
                                           const float* U, float* s_rec,
                                           int it, int nchunk, float* s_x)
{
    const int j = it / nchunk;
    const int c0 = (it - j * nchunk) * p.Lc;
    const int cpr = (min(p.Lp, c0 + p.Lc) - c0) / 4;  // copies a row
    const Record r = record_in(p, s_rec, min(j, p.nres));
    const int nh = *r.nh;
    // a row's copies by a group of 8 or 16 threads
    const int sh = cpr <= 8 ? 3 : 4;
    const int q = threadIdx.x & ((1 << sh) - 1);
    if (q < cpr) {
        for (int h = threadIdx.x >> sh; h < nh; h += kThreads >> sh)
            cp_async16(s_x + h * p.Lc + 4 * q,
                       U + (size_t)r.hg[h] * p.Lp + c0 + 4 * q);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// U_0 of the CTA's own rows (blocks [b0, b0 + nb)): K3's first-step
// operand of W, pad lanes 0.
template <int VEC>
__device__ __forceinline__ void first_operand(const ChainArgs& p, int b0,
                                              int nb)
{
    const float inv_theta = 1.0f / p.theta;   // as torch's x / theta
    const int G4 = p.Lp / 4;
    for (int t = threadIdx.x; t < nb * kRows * G4; t += kThreads) {
        const int r = t / G4;
        const int l = 4 * (t - r * G4);
        const int pos = b0 * kRows + r;
        if (pos >= p.D) break;
        const int d = p.order[pos];
        const float m = p.mask[d], s = p.ds[d];
        float x[kLanes];
        load_lanes<VEC, true>(p.W + (size_t)d * p.L + l, l, p.L, x);
#pragma unroll
        for (int q = 0; q < kLanes; ++q)
            x[q] = l + q < p.L ? operand<2>(x[q], m, s, inv_theta) : 0.0f;
        *reinterpret_cast<float4*>(p.U[0] + (size_t)d * p.Lp + l) =
            make_float4(x[0], x[1], x[2], x[3]);
    }
}

// A row's own operand lanes: W at OP 2, else Dd.
template <int VEC, int OP>
__device__ __forceinline__ void own_operand(const ChainArgs& p, int d,
                                            int l, int lane1,
                                            float (&xo)[kLanes])
{
    if constexpr (OP == 2) {
        load_lanes<VEC, true>(p.W + (size_t)d * p.L + l, l, lane1, xo);
    } else {
        const float4 t = __ldcg(reinterpret_cast<const float4*>(
            p.Dd + (size_t)d * p.Lp + l));
        xo[0] = t.x; xo[1] = t.y; xo[2] = t.z; xo[3] = t.w;
    }
}

// Item it's own operand of this thread's first row, where it sums one.
template <int VEC, int OP>
__device__ __forceinline__ void item_operand(const ChainArgs& p,
                                             float* s_rec, int b0, int it,
                                             int nchunk, int rr0, int v,
                                             float (&xo)[kLanes])
{
    const int j = it / nchunk;
    const int c0 = (it - j * nchunk) * p.Lc;
    const int l = c0 + v * kLanes;
    if (rr0 < kRows && (b0 + j) * kRows + rr0 < p.D
        && l < min(p.Lp, c0 + p.Lc))
        own_operand<VEC, OP>(
            p, record_in(p, s_rec, min(j, p.nres)).dof[rr0], l,
            min(p.L, c0 + p.Lc), xo);
}

// Step i over the CTA's blocks [b0, b0 + nb). Work items are (block,
// lane chunk) pairs; the next item's halo is copied into the other
// staging buffer, and each thread's first own operand of it loaded,
// while this one's rows sum, where its record is staged. R and Z live
// in shared memory (ON_CHIP) or in device memory.
template <int VEC, int OP, bool ON_CHIP>
__device__ __forceinline__ void chain_step(
    const ChainArgs& p, int i, int b0, int nb, float* s_x0, float* s_x1,
    float* s_rec, float* s_R, float* s_Z)
{
    const int tid = threadIdx.x;
    const int L = p.L;
    const int Lc = p.Lc;
    // a row's Lc / kLanes summing threads, in a group of whole quarter
    // warps: the 8 threads of a quarter warp read 16-byte words of one
    // staged row, which lie in distinct banks (threads past Lc / kLanes
    // sum nothing)
    const int GS = Lc <= 8 * kLanes ? 8 : 16;
    const int RPP = kThreads / GS;            // rows summed per pass
    const int rr0 = tid / GS;
    const int v = tid % GS;
    const float inv_theta = 1.0f / p.theta;   // as torch's x / theta
    const float a = p.a[i], b = p.b[i];
    const bool last = i == p.degree - 1;
    const float* U = p.U[i & 1];
    float* Un = p.U[(i + 1) & 1];
    const int nchunk = (p.Lp + Lc - 1) / Lc;
    const int items = nb * nchunk;
    if (p.nres == 0) stage_records(p, s_rec, b0, 1, 0);
    stage_item(p, U, s_rec, 0, nchunk, s_x0);
    float xn[kLanes];               // the next item's first own operand
    item_operand<VEC, OP>(p, s_rec, b0, 0, nchunk, rr0, v, xn);
    for (int it = 0; it < items; ++it) {
        const int j = it / nchunk;
        const int c0 = (it - j * nchunk) * Lc;
        const int lane1 = min(L, c0 + Lc);        // lanes of (D, L) rows
        const int lanep = min(p.Lp, c0 + Lc);     // lanes of (D, Lp) rows
        const int p0 = (b0 + j) * kRows;
        const Record r = record_in(p, s_rec, min(j, p.nres));
        const int e0 = r.ptr[0];
        float* s_x = it & 1 ? s_x1 : s_x0;
        const int jn = (it + 1) / nchunk;
        const bool ahead = it + 1 < items && (jn == j || jn < p.nres);
        float x0[kLanes];               // this item's first own operand
#pragma unroll
        for (int q = 0; q < kLanes; ++q) x0[q] = xn[q];
        if (ahead) {
            stage_item(p, U, s_rec, it + 1, nchunk, it & 1 ? s_x0 : s_x1);
            item_operand<VEC, OP>(p, s_rec, b0, it + 1, nchunk, rr0, v, xn);
            asm volatile("cp.async.wait_group 1;\n" ::: "memory");
        } else {
            asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        }
        __syncthreads();        // item it's halo is staged

        const int l = c0 + v * kLanes;
        for (int rr = rr0; rr < kRows && l < lanep; rr += RPP) {
            if (p0 + rr >= p.D) break;
            const int d = r.dof[rr];
            float* Rp = ON_CHIP ? s_R + (size_t)(j * kRows + rr) * L + l
                                : p.R + (size_t)(p0 + rr) * L + l;
            float* Zp = ON_CHIP ? s_Z + (size_t)(j * kRows + rr) * L + l
                                : p.Z + (size_t)(p0 + rr) * L + l;
            float* Dp = p.Dd + (size_t)d * p.Lp + l;
            // the epilogue's own-row operands, issued before the sum
            float xo[kLanes], rv[kLanes], zz[kLanes];
            if (rr == rr0) {
#pragma unroll
                for (int q = 0; q < kLanes; ++q) xo[q] = x0[q];
            } else {
                own_operand<VEC, OP>(p, d, l, lane1, xo);
            }
            if constexpr (OP == 1) {
                load_lanes<VEC, false>(Rp, l, lane1, rv);
                load_lanes<VEC, false>(Zp, l, lane1, zz);
            }
            float acc[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
            for (int k = r.ptr[rr] - e0; k < r.ptr[rr + 1] - e0; ++k) {
                const float2* ck = reinterpret_cast<const float2*>(r.c)
                                   + 3 * k;
                const unsigned* sk = reinterpret_cast<const unsigned*>(
                    r.slot) + 3 * k;
                float ye[kLanes] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
                for (int jj = 0; jj < 3; ++jj) {
                    const float2 c2 = ck[jj];         // j = 2jj, 2jj + 1
                    const unsigned s2 = sk[jj];
                    const float4 u0 = *reinterpret_cast<const float4*>(
                        s_x + (s2 & 0xffffu) * Lc + v * kLanes);
                    const float4 u1 = *reinterpret_cast<const float4*>(
                        s_x + (s2 >> 16) * Lc + v * kLanes);
                    ye[0] = fmaf(c2.x, u0.x, ye[0]);
                    ye[1] = fmaf(c2.x, u0.y, ye[1]);
                    ye[2] = fmaf(c2.x, u0.z, ye[2]);
                    ye[3] = fmaf(c2.x, u0.w, ye[3]);
                    ye[0] = fmaf(c2.y, u1.x, ye[0]);
                    ye[1] = fmaf(c2.y, u1.y, ye[1]);
                    ye[2] = fmaf(c2.y, u1.z, ye[2]);
                    ye[3] = fmaf(c2.y, u1.w, ye[3]);
                }
#pragma unroll
                for (int q = 0; q < kLanes; ++q)
                    acc[q] = __fadd_rn(acc[q], ye[q]);
            }

            const float md = r.md[rr];
            const float sd = r.sd[rr];
            float V[kLanes], y[kLanes];
            if constexpr (OP == 2) {
#pragma unroll
                for (int q = 0; q < kLanes; ++q) {
                    rv[q] = __fmul_rn(sd, xo[q]);
                    V[q] = __fmul_rn(rv[q], inv_theta);
                    zz[q] = 0.0f;
                }
            } else {
#pragma unroll
                for (int q = 0; q < kLanes; ++q) V[q] = xo[q];
            }
#pragma unroll
            for (int q = 0; q < kLanes; ++q) {
                const float vs = __fmul_rn(sd, V[q]);
                const float my = __fadd_rn(
                    __fmul_rn(acc[q], md),
                    __fsub_rn(vs, __fmul_rn(vs, md)));
                rv[q] = __fsub_rn(rv[q], __fmul_rn(sd, my));
                zz[q] = __fadd_rn(zz[q], V[q]);
                y[q] = __fadd_rn(__fmul_rn(a, V[q]), __fmul_rn(b, rv[q]));
            }
            if (last) {
#pragma unroll
                for (int q = 0; q < kLanes; ++q)
                    y[q] = __fmul_rn(sd, __fadd_rn(zz[q], y[q]));
                store_lanes<VEC>(p.out + (size_t)d * L + l, l, lane1, y);
            } else {
                store_lanes<VEC>(Rp, l, lane1, rv);
                store_lanes<VEC>(Zp, l, lane1, zz);
                *reinterpret_cast<float4*>(Dp) =
                    make_float4(y[0], y[1], y[2], y[3]);
                float u[kLanes];
#pragma unroll
                for (int q = 0; q < kLanes; ++q)
                    u[q] = operand<1>(y[q], md, sd, inv_theta);
                *reinterpret_cast<float4*>(Un + (size_t)d * p.Lp + l) =
                    make_float4(u[0], u[1], u[2], u[3]);
            }
        }
        __syncthreads();        // item it's staging buffer is free
        if (it + 1 < items && !ahead) {
            // the next block's record goes into the spare, then its halo
            stage_records(p, s_rec, b0 + jn, 1, p.nres);
            stage_item(p, U, s_rec, it + 1, nchunk, it & 1 ? s_x0 : s_x1);
            item_operand<VEC, OP>(p, s_rec, b0, it + 1, nchunk, rr0, v, xn);
        }
    }
}

template <int VEC, bool ON_CHIP>
__global__ void __launch_bounds__(kThreads, 3)
binv_chain_kernel(const ChainArgs p)
{
    extern __shared__ float4 smem4[];
    float* s_x0 = reinterpret_cast<float*>(smem4);           // (H, Lc)
    float* s_x1 = s_x0 + p.H * p.Lc;
    float* s_rec = s_x1 + p.H * p.Lc;                         // records
    const int spare = p.nres < p.bpc ? 1 : 0;
    float* s_R = s_rec + (size_t)(p.nres + spare) * p.rec_words;
    float* s_Z = s_R + (size_t)p.bpc * kRows * p.L;

    const int G = gridDim.x;
    const int b0 = (int)((long long)blockIdx.x * p.NB / G);
    const int nb = (int)((long long)(blockIdx.x + 1) * p.NB / G) - b0;
    first_operand<VEC>(p, b0, nb);
    stage_records(p, s_rec, b0, min(nb, p.nres), 0);

    cg::grid_group grid = cg::this_grid();
    for (int i = 0; i < p.degree; ++i) {
        grid.sync();            // every row's U of step i is written
        if (i == 0)
            chain_step<VEC, 2, ON_CHIP>(p, i, b0, nb, s_x0, s_x1, s_rec, s_R,
                                        s_Z);
        else
            chain_step<VEC, 1, ON_CHIP>(p, i, b0, nb, s_x0, s_x1, s_rec, s_R,
                                        s_Z);
    }
}

// The launch's layout: CTAs an SM (k), blocks a CTA, resident records
// and dynamic shared memory. The most CTAs an SM (at least two) whose
// records all stay staged; else the most CTAs an SM that fit with R and
// Z (on chip), the staging buffers and a spare record, each CTA keeping
// as many records staged as its share of the SM's shared memory holds.
//
// On chip, k = 1 fits exactly where R and Z of ceil(NB / n_sm) blocks,
// 8 * ceil(NB / n_sm) * kRows * L bytes, take at most what
// pl_binv_chain_limits reports: the rule the host decides by, so a
// launch it sends on chip always finds a layout. No k > 1 fits where
// k = 1 does not: the CTAs of an SM own at least ceil(NB / n_sm) blocks
// between them, each stages its own halo and record, and two or more
// have per_sm - 2048 bytes at most, which on sm_90 is kMaxShared.
struct Layout {
    int grid, bpc, nres;
    size_t shmem;
};

// Bytes of a CTA's two halo staging buffers and of one block record.
inline size_t stage_bytes(int H, int Lc)
{
    return 2 * 4 * (size_t)H * Lc;
}

inline size_t record_bytes(int H, int max_ent)
{
    return 4 * (size_t)record_words(H, max_ent);
}

// The shared memory one CTA alone on an SM of per_sm bytes may use.
inline size_t cta_budget(int per_sm)
{
    return std::min(kMaxShared, (size_t)per_sm - 1024);
}

// The layout follows from the shape and the card alone; its occupancy
// queries would cost host time at every launch, so the last 16 layouts
// are kept (two sweep threads launch at once: under a lock).
struct CachedLayout {
    const void* kernel;
    int dev, NB, H, max_ent, L, on_chip;
    Layout lay;
};

std::mutex g_cache_lock;
CachedLayout g_cache[16];
int g_cache_n = 0;

template <typename Kernel>
cudaError_t make_layout(Kernel kernel, int dev, const ChainArgs& p,
                        Layout* out)
{
    {
        std::lock_guard<std::mutex> g(g_cache_lock);
        for (int i = 0; i < g_cache_n; ++i) {
            const CachedLayout& c = g_cache[i];
            if (c.kernel == (const void*)kernel && c.dev == dev
                && c.NB == p.NB && c.H == p.H && c.max_ent == p.max_ent
                && c.L == p.L && c.on_chip == (int)p.on_chip) {
                *out = c.lay;
                return cudaSuccess;
            }
        }
    }
    int n_sm = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return err;
    const size_t rec = record_bytes(p.H, p.max_ent);
    const size_t stage = stage_bytes(p.H, p.Lc);
    Layout lay{0, 0, 0, 0};
    bool found = false;
    for (int pass = 0; pass < 2 && !found; ++pass) {
        for (int k = kMaxCtasPerSm; k >= 2 - pass && !found; --k) {
            const int G = std::min(p.NB, n_sm * k);
            const int bpc = (p.NB + G - 1) / G;
            const int per_cta = (G + n_sm - 1) / n_sm;
            const size_t fixed = stage
                + (p.on_chip ? 8 * (size_t)bpc * kRows * p.L : 0);
            // a CTA's share of the SM, less the 1 KB the card reserves
            const size_t share = cta_budget(per_sm / per_cta);
            int nres = bpc;
            if (pass == 1 && fixed + bpc * rec > share) {
                if (fixed + rec > share) continue;
                nres = (int)std::min((size_t)bpc - 1,
                                     (share - fixed - rec) / rec);
            }
            const size_t shmem = fixed + (nres + (nres < bpc)) * rec;
            if (shmem > share) continue;
            int occ = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &occ, kernel, kThreads, shmem);
            if (err != cudaSuccess) return err;
            if (occ >= per_cta) {
                lay = Layout{G, bpc, nres, shmem};
                found = true;
            }
        }
    }
    if (!found) return cudaErrorInvalidValue;
    std::lock_guard<std::mutex> g(g_cache_lock);
    CachedLayout c{(const void*)kernel, dev, p.NB, p.H, p.max_ent, p.L,
                   (int)p.on_chip, lay};
    g_cache[g_cache_n % 16] = c;
    if (g_cache_n < 16) ++g_cache_n;
    *out = lay;
    return cudaSuccess;
}

template <int VEC, bool ON_CHIP>
cudaError_t launch(ChainArgs& p, cudaStream_t stream)
{
    auto kernel = binv_chain_kernel<VEC, ON_CHIP>;
    cudaError_t err = set_shared_limit(kernel);
    if (err != cudaSuccess) return err;
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    Layout lay;
    err = make_layout(kernel, dev, p, &lay);
    if (err != cudaSuccess) return err;
    p.bpc = lay.bpc;
    p.nres = lay.nres;
    void* args[] = {&p};
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3(lay.grid),
                                       dim3(kThreads), args, lay.shmem,
                                       stream);
}

}  // namespace

// What cuda_kernels.binv_on_chip decides from, for a chain of L lanes
// on a plan of H halo rows and max_ent entries a block on device dev:
// the SM count, and the shared memory one CTA alone on its SM has left
// for R and Z once its halo staging and one block record are in (< 0
// where even those do not fit).
extern "C" int pl_binv_chain_limits(int dev, int H, int max_ent, int L,
                                    int* n_sm, long long* shared)
{
    int per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err != cudaSuccess) return (int)err;
    if (H < 1 || max_ent < 1 || L < 1) return (int)cudaErrorInvalidValue;
    const int Lc = std::min(kChunk, (L + 3) / 4 * 4);
    *shared = (long long)cta_budget(per_sm)
              - (long long)(stage_bytes(H, Lc) + record_bytes(H, max_ent));
    return (int)cudaSuccess;
}

// U0, U1 and Dd are (D, Lp) scratch blocks with Lp = L rounded up to a
// multiple of 4, on 16 bytes; R and Z (D, L) scratch in the device
// regime (on_chip 0), else null.
extern "C" int pl_binv_chain(
    const void* W, const void* w, const void* Nref,
    const void* order, const void* halo, const void* n_halo,
    const void* row_ptr, const void* ent, const void* loc, const void* mask,
    const void* ds, void* U0, void* U1, void* Dd, void* out, void* R,
    void* Z, const float* a, const float* b, float theta, int D, int H,
    int max_ent, int Q, int L, int degree, int on_chip, void* stream)
{
    if (D < 1 || L < 1 || Q < 1 || Q > kMaxQ || H < 1 || H > 32767
        || max_ent < 1 || degree < 2 || degree > kMaxDegree
        || (uintptr_t)U0 % 16 || (uintptr_t)U1 % 16 || (uintptr_t)Dd % 16
        || (!on_chip && (R == nullptr || Z == nullptr)))
        return (int)cudaErrorInvalidValue;
    ChainArgs p;
    p.W = (const float*)W;
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
    p.U[0] = (float*)U0;
    p.U[1] = (float*)U1;
    p.Dd = (float*)Dd;
    p.out = (float*)out;
    p.R = (float*)R;
    p.Z = (float*)Z;
    for (int i = 0; i < kMaxDegree; ++i) {
        p.a[i] = i < degree ? a[i] : 0.0f;
        p.b[i] = i < degree ? b[i] : 0.0f;
    }
    p.theta = theta;
    p.D = D;
    p.NB = (D + kRows - 1) / kRows;
    p.H = H;
    p.max_ent = max_ent;
    p.Q = Q;
    p.L = L;
    p.degree = degree;
    p.Lp = (L + 3) / 4 * 4;
    p.Lc = std::min(kChunk, p.Lp);
    p.rec_words = record_words(H, max_ent);
    p.on_chip = on_chip != 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (p.on_chip) {
        if (L % 4 == 0) return (int)launch<4, true>(p, s);
        if (L % 2 == 0) return (int)launch<2, true>(p, s);
        return (int)launch<1, true>(p, s);
    }
    if (L % 4 == 0) return (int)launch<4, false>(p, s);
    if (L % 2 == 0) return (int)launch<2, false>(p, s);
    return (int)launch<1, false>(p, s);
}
