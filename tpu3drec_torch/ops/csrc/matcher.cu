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
// reach at most half of that peak.
//
// Design: a classic register-tiled fp32 product. A block of 256 threads owns
// one pair and 128 queries; it walks the references in tiles of 64, staging
// the query tile and the reference tile through shared memory 32 dimensions
// at a time (transposed and padded by one column so that neither the stores
// nor the loads conflict on banks). Each thread accumulates a 4 x 8 block of
// scores (queries qg + 32 i, references rg + 8 j) in registers, then folds its
// eight scores of each query into that query's running (best, s1, s2). After
// the last tile the eight threads that share a query (neighbouring lanes of
// one warp) merge their states with shuffles. The Ka x Kb score matrix never
// exists in device memory; nothing is carried between blocks, and the ragged
// edges in Ka, Kb and D are cut by count, with no padding. There is no
// interpret mode: the CPU runs topk2_scores_plain instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 128;  // queries per block
constexpr int kTileR = 64;   // references per tile
constexpr int kTileD = 32;   // dimensions staged per pass
constexpr int kThreads = 256;
constexpr int kQPer = 4;     // queries per thread: qg + 32 i
constexpr int kRPer = 8;     // references per thread: rg + 8 j
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

__global__ void __launch_bounds__(kThreads)
matcher_kernel(const float* __restrict__ a, const float* __restrict__ b,
               const unsigned char* __restrict__ valid_b, int ka, int kb, int d,
               int* __restrict__ best, float* __restrict__ top2) {
  __shared__ float as[kTileD][kTileQ + 1];
  __shared__ float bs[kTileD][kTileR + 1];

  const int pair = blockIdx.y;
  const int q0 = blockIdx.x * kTileQ;
  const int tid = threadIdx.x;
  const int qg = tid / kRPer;  // 0 .. 31
  const int rg = tid % kRPer;  // 0 .. 7
  const float* ap = a + static_cast<size_t>(pair) * ka * d;
  const float* bp = b + static_cast<size_t>(pair) * kb * d;
  const unsigned char* vp = valid_b + static_cast<size_t>(pair) * kb;
  const int nq = min(kTileQ, ka - q0);

  Top2 st[kQPer];
#pragma unroll
  for (int i = 0; i < kQPer; ++i) st[i] = {0, kInvalid, kInvalid};

  for (int r0 = 0; r0 < kb; r0 += kTileR) {
    const int nr = min(kTileR, kb - r0);
    float acc[kQPer][kRPer];
#pragma unroll
    for (int i = 0; i < kQPer; ++i)
#pragma unroll
      for (int j = 0; j < kRPer; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += kTileD) {
      const int nd = min(kTileD, d - d0);
      __syncthreads();  // the previous slices have been read
      // consecutive threads read consecutive dimensions of one row
      for (int e = tid; e < kTileQ * kTileD; e += kThreads) {
        const int q = e / kTileD, dd = e % kTileD;
        as[dd][q] = (q < nq && dd < nd) ? ap[static_cast<size_t>(q0 + q) * d + d0 + dd] : 0.f;
      }
      for (int e = tid; e < kTileR * kTileD; e += kThreads) {
        const int r = e / kTileD, dd = e % kTileD;
        bs[dd][r] = (r < nr && dd < nd) ? bp[static_cast<size_t>(r0 + r) * d + d0 + dd] : 0.f;
      }
      __syncthreads();
      for (int dd = 0; dd < nd; ++dd) {  // fixed order over d
        float av[kQPer], bv[kRPer];
#pragma unroll
        for (int i = 0; i < kQPer; ++i) av[i] = as[dd][qg + 32 * i];
#pragma unroll
        for (int j = 0; j < kRPer; ++j) bv[j] = bs[dd][rg + 8 * j];
#pragma unroll
        for (int i = 0; i < kQPer; ++i)
#pragma unroll
          for (int j = 0; j < kRPer; ++j)
            acc[i][j] = __fadd_rn(acc[i][j], __fmul_rn(av[i], bv[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < kRPer; ++j) {
      const int r = rg + 8 * j;
      if (r < nr) {
        const bool ok = vp[r0 + r] != 0;
#pragma unroll
        for (int i = 0; i < kQPer; ++i) push(st[i], ok ? acc[i][j] : kInvalid, r0 + r);
      }
    }
  }

  // the eight threads of a query are lanes 8k .. 8k+7 of one warp
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
#pragma unroll
    for (int off = 1; off < kRPer; off <<= 1) {
      Top2 o;
      o.i1 = __shfl_xor_sync(0xffffffffu, st[i].i1, off);
      o.s1 = __shfl_xor_sync(0xffffffffu, st[i].s1, off);
      o.s2 = __shfl_xor_sync(0xffffffffu, st[i].s2, off);
      st[i] = merge(st[i], o);
    }
    const int q = qg + 32 * i;
    if (rg == 0 && q < nq) {
      const size_t o = static_cast<size_t>(pair) * ka + q0 + q;
      best[o] = st[i].i1;
      top2[2 * o] = st[i].s1;
      top2[2 * o + 1] = st[i].s2;
    }
  }
}

}  // namespace

// a: (p, ka, d), b: (p, kb, d) row-major float32; valid_b: (p, kb) bytes
// (0 = invalid); best: (p, ka) int32; top2: (p, ka, 2) float32. Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int tpu3drec_matcher(const float* a, const float* b, const unsigned char* valid_b,
                                int p, int ka, int kb, int d, int* best, float* top2,
                                void* stream) {
  if (p <= 0 || ka <= 0) return static_cast<int>(cudaSuccess);
  if (p > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ka + kTileQ - 1) / kTileQ, p);
  matcher_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, valid_b, ka, kb, d, best, top2);
  return static_cast<int>(cudaGetLastError());
}
