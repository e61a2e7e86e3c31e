// K2: element -> DOF accumulate through the bounded-valence transpose
// tables, with the optional mask/park epilogue of the operator applies.
//
// Replaces the gather branch of pl_fem_tpu/ops/kernels.py
// _accumulate_fused and the epilogue Y * m + park * (X - X * m) of
// _apply_vector3_fused / _apply_mass_fused.
//
// Ye is (E * 6, L); DOF rows [0, split) sum up to Wv entries of idx_v,
// rows [split, D) up to 2 entries of idx_e (P2 edge midpoints). Each
// thread owns one (row, lane) and sums its row's valid entries in table
// order, so the result is deterministic and needs no atomics.
//
// Bound on the H100: bytes. It reads Ye once (E * 6 * L floats, in
// whole contiguous rows of L lanes) and writes Y (D * L floats), plus X
// when the epilogue is on. Threads of a block walk the lanes of one
// DOF row, so every gathered Ye row and every store is a contiguous,
// coalesced segment; the index tables are read once per block.

#include <cuda_runtime.h>

namespace {

__global__ void accumulate_kernel(
    const float* __restrict__ Ye,          // (E * 6, L)
    const int* __restrict__ idx_v,         // (split, Wv)
    const unsigned char* __restrict__ valid_v,
    const int* __restrict__ idx_e,         // (D - split, 2)
    const unsigned char* __restrict__ valid_e,
    const float* __restrict__ X,           // (D, L) or null: no epilogue
    const float* __restrict__ mask,        // (D,)
    const float* __restrict__ park,        // (L,)
    int split, int Wv, int L,
    float* __restrict__ Y)                 // (D, L)
{
    const int d = blockIdx.x;
    const int l = blockIdx.y * blockDim.x + threadIdx.x;
    if (l >= L) return;
    const int* idx;
    const unsigned char* valid;
    int W;
    if (d < split) {
        idx = idx_v + (size_t)d * Wv;
        valid = valid_v + (size_t)d * Wv;
        W = Wv;
    } else {
        idx = idx_e + (size_t)(d - split) * 2;
        valid = valid_e + (size_t)(d - split) * 2;
        W = 2;
    }
    float acc = 0.0f;
    for (int t = 0; t < W; ++t)
        if (valid[t]) acc += Ye[(size_t)idx[t] * L + l];
    const size_t o = (size_t)d * L + l;
    if (X != nullptr) {
        const float m = mask[d];
        const float x = X[o];
        acc = acc * m + park[l] * (x - x * m);
    }
    Y[o] = acc;
}

}  // namespace

extern "C" int pl_accumulate(
    const void* Ye, const void* idx_v, const void* valid_v,
    const void* idx_e, const void* valid_e, const void* X,
    const void* mask, const void* park, int D, int split, int Wv, int L,
    void* Y, void* stream)
{
    if (D < 1 || L < 1 || split < 0 || split > D || Wv < 0)
        return (int)cudaErrorInvalidValue;
    // split L into the fewest blocks of <= 256 lanes, evenly
    const int nb = (L + 255) / 256;
    const int threads = (((L + nb - 1) / nb + 31) / 32) * 32;
    dim3 grid(D, nb);
    accumulate_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)Ye, (const int*)idx_v, (const unsigned char*)valid_v,
        (const int*)idx_e, (const unsigned char*)valid_e, (const float*)X,
        (const float*)mask, (const float*)park, split, Wv, L, (float*)Y);
    return (int)cudaGetLastError();
}
