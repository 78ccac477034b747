// Descriptor matcher: for every query descriptor, the index of the best valid
// reference and the top-1 and top-2 dot-product similarities.
//
// Replaces tpu3drec/ops/matcher.py::_matcher_kernel (called through
// topk2_scores) and ::_matcher_kernel_batched (called through
// topk2_scores_batched): both Pallas TPU kernels compute the same function,
// the second over a pair dimension, and one __global__ with a pair
// dimension serves both here. What it keeps exactly:
//   * invalid references score -3.0 (similarities of unit vectors lie in
//     [-1, 1]), not -inf;
//   * the running state starts at (index 0, -3, -3), so a query whose
//     references are all invalid gets index 0 and -3 / -3, as the TPU's
//     padded tile gives;
//   * the best index is the first one among equal scores, and a score equal
//     to s1 lifts s2 to s1 (a duplicated maximum, as _tile_top2 gives it);
//   * each score is the sum over d = 0 .. D-1, in that order, of
//     a[d] * b[d], starting from 0, each product and each sum rounded on its
//     own (the build's -fmad=false keeps nvcc from fusing them). The plain
//     PyTorch version, topk2_scores_plain, sums in the same order, so the two
//     agree bit for bit. No TF32 and no tensor cores anywhere.
//
// What bounds it: fp32 arithmetic. 2 * P * Ka * Kb * D operations against
// (P * (Ka + Kb) * D + P * Kb) * 4 bytes in and P * Ka * 12 bytes out; at
// P = 8, K = 4096, D = 128 that is 34.4 GFLOP against ~34 MB, so the
// operations bound it (0.513 ms at 67 TFLOP/s). Without fused multiply-adds
// the CUDA cores issue a multiply and an add per term, so this kernel can
// reach at most half of that peak: an issue floor of ~1.03 ms there.
//
// Design.
//   * A block of 256 threads owns (pair, 128 queries, one split of the
//     references) and walks the split in tiles of 128 references. Each
//     thread accumulates an 8 x 8 block of scores in registers: queries
//     4 ty + i and 64 + 4 ty + i, references 4 tx + j and 64 + 4 tx + j
//     (ty = tid / 16, tx = tid % 16, i, j < 4). Per dimension it reads them
//     with four float4 loads from shared memory (two of them broadcasts),
//     so 4 loads feed 64 multiply-add pairs.
//   * Both tiles are staged 32 dimensions at a time, transposed ([d][row],
//     rows padded to 132 floats) by 4-byte cp.async copies, in two stages:
//     the copy of the next slice runs while this one is summed. A warp
//     copies 8 dimensions of 4 rows, which is 32-byte runs of device memory
//     and 32 distinct banks. Rows and dimensions past the edge are filled
//     with +0; a product 0 * 0 added to a sum that started at +0 leaves it
//     unchanged, so a ragged D needs no other care. The stages live in
//     dynamic shared memory (90 KB with the states below), two blocks to an
//     SM.
//   * After each reference tile a thread folds its 64 scores into the
//     (best, s1, s2) states of its 8 queries, which wait in shared memory
//     (one word per thread, no bank conflicts) so that they hold no
//     registers during the sums. At the end the 16 threads of a query
//     (lanes of one half warp) merge their states with shuffles.
//   * The references are cut into splits so that the grid fills the card
//     (ops/matcher.py::split_plan picks the count from the SM count and
//     the occupancy this build reports). With one split the block writes
//     the answer; with more, each split writes its state and a second small
//     __global__ merges them. The merge rule (larger s1, the lower index on
//     equal s1, s2 = max(min(s1a, s1b), s2a, s2b)) gives the unsplit answer
//     in any order, and a split of only invalid references gives the start
//     state (0, -3, -3), which the merge leaves out.
// The Ka x Kb score matrix never exists in device memory. There is no
// interpret mode: the CPU runs topk2_scores_plain instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 128;  // queries per block
constexpr int kTileR = 128;  // references per tile
constexpr int kSliceD = 32;  // dimensions staged per pass
constexpr int kThreads = 256;
constexpr int kPer = 8;                              // queries and references per thread
constexpr int kLd = 132;                             // floats per staged dimension row
constexpr int kStageFloats = 2 * kSliceD * kLd;      // the A and the B slice
constexpr int kStateWords = kPer * kThreads;         // per state field
constexpr size_t kSmemBytes =
    (2 * kStageFloats + 3 * kStateWords) * sizeof(float);
constexpr float kInvalid = -3.0f;

struct Top2 {
  int i1;
  float s1, s2;
};

__device__ __forceinline__ void push(Top2& st, float s, int j) {
  if (s > st.s1) {
    st.s2 = st.s1;
    st.s1 = s;
    st.i1 = j;
  } else {
    st.s2 = fmaxf(st.s2, s);
  }
}

// Union of two disjoint candidate sets: the larger s1 wins, the lower index
// on equal scores; the runner-up is the best of everything else.
__device__ __forceinline__ Top2 merge(const Top2& a, const Top2& b) {
  Top2 m;
  const bool take_b = b.s1 > a.s1 || (b.s1 == a.s1 && b.i1 < a.i1);
  m.i1 = take_b ? b.i1 : a.i1;
  m.s1 = fmaxf(a.s1, b.s1);
  m.s2 = fmaxf(fminf(a.s1, b.s1), fmaxf(a.s2, b.s2));
  return m;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  const int bytes = full ? 4 : 0;  // 0: fill with zeros, read nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage dimensions [d0, d0 + 32) of rows [row0, row0 + 128) of `src` (rows
// of d floats, nrows in all) transposed into dst[dd * kLd + row]. Thread
// tid copies rows rt + 32 k and dimensions dt + 8 m (k, m < 4), so a warp
// copies 8 dimensions of 4 rows at each step.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int row0,
                                      int nrows, int d0, int d, int tid) {
  const int rt = (tid >> 5) * 4 + ((tid & 31) >> 3), dt = tid & 7;
  const float* p = src + static_cast<size_t>(row0 + rt) * d + d0 + dt;
  float* q = dst + dt * kLd + rt;
#pragma unroll
  for (int m = 0; m < kSliceD / 8; ++m) {
    const bool dim_in = d0 + dt + 8 * m < d;
#pragma unroll
    for (int k = 0; k < kTileQ / 32; ++k) {
      const bool full = dim_in && row0 + rt + 32 * k < nrows;
      cp_async4(q + 8 * m * kLd + 32 * k, full ? p + static_cast<size_t>(32 * k) * d + 8 * m : src,
                full);
    }
  }
}

// Two blocks an SM, so at most 128 registers a thread; ptxas then keeps the
// 64 sums, the 16 operands and the addresses without a spill. (Given only the
// thread count, ptxas capped the earlier 4 x 8 version at 64 and spilled.)
__global__ void __launch_bounds__(kThreads, 2)
matcher_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const unsigned char* __restrict__ valid_b, int ka, int kb, int d,
               int split_refs, int* __restrict__ best, float* __restrict__ top2) {
  extern __shared__ __align__(16) float smem[];
  int* st_i = reinterpret_cast<int*>(smem + 2 * kStageFloats);
  float* st_s1 = smem + 2 * kStageFloats + kStateWords;
  float* st_s2 = smem + 2 * kStageFloats + 2 * kStateWords;

  const int pair = blockIdx.z;
  const int split = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float* ap = a + static_cast<size_t>(pair) * ka * d;
  const float* bp = b + static_cast<size_t>(pair) * kb * d;
  const unsigned char* vp = valid_b + static_cast<size_t>(pair) * kb;
  const int r_begin = split * split_refs;
  const int r_end = min(kb, r_begin + split_refs);
  const int tiles = r_end > r_begin ? (r_end - r_begin + kTileR - 1) / kTileR : 0;
  const int slices = (d + kSliceD - 1) / kSliceD;
  const int steps = tiles * slices;

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    st_i[i * kThreads + tid] = 0;
    st_s1[i * kThreads + tid] = kInvalid;
    st_s2[i * kThreads + tid] = kInvalid;
  }

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
  if (steps > 0) {
    stage(smem, ap, q0, ka, 0, d, tid);
    stage(smem + kSliceD * kLd, bp, r_begin, r_end, 0, d, tid);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    const int t = step / slices, sl = step % slices;
    const int r0 = r_begin + t * kTileR;
    if (step + 1 < steps) {  // the next slice, into the other stage
      const int tn = (step + 1) / slices, sn = (step + 1) % slices;
      float* nxt = smem + ((step + 1) & 1) * kStageFloats;
      stage(nxt, ap, q0, ka, sn * kSliceD, d, tid);
      stage(nxt + kSliceD * kLd, bp, r_begin + tn * kTileR, r_end, sn * kSliceD, d, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this slice has landed for every thread
    const float* as = smem + (step & 1) * kStageFloats;
    const float* bs = as + kSliceD * kLd;
    // not unrolled: unrolled, ptxas spills a word at the 128-register cap
#pragma unroll 1
    for (int dd = 0; dd < kSliceD; ++dd) {  // fixed order over d
      const float4 a0 = *reinterpret_cast<const float4*>(as + dd * kLd + 4 * ty);
      const float4 a1 = *reinterpret_cast<const float4*>(as + dd * kLd + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + dd * kLd + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + dd * kLd + 64 + 4 * tx);
      const float av[kPer] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kPer] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
    }
    if (sl == slices - 1) {  // the tile's scores are complete: fold them in
      unsigned int in_range = 0, ok = 0;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int r = r0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (r < r_end) {
          in_range |= 1u << j;
          ok |= (vp[r] != 0 ? 1u : 0u) << j;
        }
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        Top2 st = {st_i[i * kThreads + tid], st_s1[i * kThreads + tid],
                   st_s2[i * kThreads + tid]};
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int r = r0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
          if (in_range & (1u << j)) push(st, (ok & (1u << j)) ? acc[i][j] : kInvalid, r);
        }
        st_i[i * kThreads + tid] = st.i1;
        st_s1[i * kThreads + tid] = st.s1;
        st_s2[i * kThreads + tid] = st.s2;
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  // the 16 threads of a query are lanes 16h .. 16h + 15 of one warp
  const size_t slot = static_cast<size_t>(split) * gridDim.z + pair;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    Top2 st = {st_i[i * kThreads + tid], st_s1[i * kThreads + tid], st_s2[i * kThreads + tid]};
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) {
      Top2 o;
      o.i1 = __shfl_xor_sync(0xffffffffu, st.i1, off);
      o.s1 = __shfl_xor_sync(0xffffffffu, st.s1, off);
      o.s2 = __shfl_xor_sync(0xffffffffu, st.s2, off);
      st = merge(st, o);
    }
    const int q = q0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (tx == 0 && q < ka) {
      const size_t o = slot * ka + q;
      best[o] = st.i1;
      top2[2 * o] = st.s1;
      top2[2 * o + 1] = st.s2;
    }
  }
}

// Fold the per-split states (splits, p * ka) into the answer (p * ka).
__global__ void matcher_merge(const int* __restrict__ part_i, const float* __restrict__ part_s,
                              int splits, int n, int* __restrict__ best,
                              float* __restrict__ top2) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= n) return;
  Top2 st = {part_i[o], part_s[2 * o], part_s[2 * o + 1]};
  for (int s = 1; s < splits; ++s) {
    const size_t k = static_cast<size_t>(s) * n + o;
    st = merge(st, Top2{part_i[k], part_s[2 * k], part_s[2 * k + 1]});
  }
  best[o] = st.i1;
  top2[2 * o] = st.s1;
  top2[2 * o + 1] = st.s2;
}

cudaError_t allow_smem() {
  return cudaFuncSetAttribute(matcher_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(kSmemBytes));
}

}  // namespace

// Blocks of matcher_kernel that one SM holds at once, for the wrapper's
// split plan. Returns the CUDA error code.
extern "C" int tpu3drec_matcher_blocks_per_sm(int* blocks) {
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, matcher_kernel, kThreads, kSmemBytes));
}

// a: (p, ka, d), b: (p, kb, d) row-major float32; valid_b: (p, kb) bytes
// (0 = invalid); best: (p, ka) int32; top2: (p, ka, 2) float32. References
// [s * split_refs, (s + 1) * split_refs) go to split s < splits (split_refs
// a multiple of 128). With splits > 1, part_i (splits, p, ka) int32 and
// part_s (splits, p, ka, 2) float32 hold the splits' states for the merge.
// Launches on `stream` and returns cudaGetLastError() after the launches.
extern "C" int tpu3drec_matcher(const float* a, const float* b, const unsigned char* valid_b,
                                int p, int ka, int kb, int d, int splits, int split_refs,
                                int* part_i, float* part_s, int* best, float* top2,
                                void* stream) {
  if (p <= 0 || ka <= 0) return static_cast<int>(cudaSuccess);
  const long long first_of_last = static_cast<long long>(splits - 1) * split_refs;
  if (p > 65535 || splits <= 0 || splits > 65535 || split_refs <= 0 ||
      split_refs % kTileR != 0 || first_of_last >= (kb > 0 ? kb : 1) ||
      first_of_last + split_refs < kb || (splits > 1 && (!part_i || !part_s))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((ka + kTileQ - 1) / kTileQ, splits, p);
  matcher_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      a, b, valid_b, ka, kb, d, split_refs, splits > 1 ? part_i : best,
      splits > 1 ? part_s : top2);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int n = p * ka;
  matcher_merge<<<(n + 255) / 256, 256, 0, s>>>(part_i, part_s, splits, n, best, top2);
  return static_cast<int>(cudaGetLastError());
}
