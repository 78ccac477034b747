// Nearest neighbour of every query point among the reference points, for ICP.
//
// Replaces tpu3drec/ops/icp_nn.py::_nn_kernel (the Pallas TPU kernel called
// through nearest_neighbors_pallas). For each query it returns the index and
// the squared distance of the nearest reference point:
//   * distances by direct differences, dx*dx + dy*dy + dz*dz, each product
//     and sum rounded on its own (__fmul_rn/__fadd_rn, so no fused
//     multiply-add), which is what the plain PyTorch version computes;
//   * ties go to the lowest reference index (strict < while j increases);
//   * the running minimum starts at 1e30 with index 0, as in the TPU kernel.
//
// What bounds it: fp32 arithmetic on the CUDA cores. The JAX package counts
// 9 flop per query/reference pair (icp_nn.py:108); at 67 TFLOP/s fp32 that
// is the bound. Bytes are negligible: (Nq + Nr) * 12 in, Nq * 8 out.
//
// Design: one thread per query keeps (x, y, z) and its running (best_d,
// best_i) in registers. A block of 128 queries walks the whole reference set
// in tiles of 1024 points. The wrapper passes the references transposed,
// (3, Nr), the layout the TPU wrapper built too; the block stages each tile
// into shared memory as one float4 per point, so a thread reads a point with
// one load, and every thread of the block reads the same point at each step,
// a broadcast without bank conflicts. 128-query blocks give 600 blocks at
// the slice's 76,800 queries, which spread over 132 SMs more evenly than 300
// blocks of 256 (PERF.md records the block shapes that were tried).
// The TPU kernel's sequential grid axis over reference blocks is the loop
// inside the block; nothing is carried between blocks, and the Nq x Nr
// distance matrix never exists in device memory. The ragged last tile is cut
// by count, with no padding. There is no interpret mode: the CPU runs
// nearest_neighbors_plain instead.

#include <cuda_runtime.h>

namespace {

constexpr int kTileQ = 128;   // queries per block, one per thread
constexpr int kTileR = 1024;  // reference points staged per pass

__global__ void __launch_bounds__(kTileQ)
icp_nn_kernel(const float* __restrict__ q, const float* __restrict__ rt,
              int nq, int nr, int* __restrict__ idx, float* __restrict__ d2) {
  __shared__ float4 tile[kTileR];  // (x, y, z, unused) per reference point

  const int i = blockIdx.x * kTileQ + threadIdx.x;
  const bool live = i < nq;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best_d = 1e30f;
  int best_i = 0;

  for (int base = 0; base < nr; base += kTileR) {
    const int n = min(kTileR, nr - base);
    __syncthreads();  // the previous tile has been read by every thread
    for (int k = threadIdx.x; k < n; k += kTileQ) {
      tile[k] = make_float4(rt[base + k], rt[nr + base + k], rt[2 * nr + base + k], 0.f);
    }
    __syncthreads();
    if (live) {
#pragma unroll 4
      for (int k = 0; k < n; ++k) {
        const float4 r = tile[k];
        const float dx = __fsub_rn(qx, r.x);
        const float dy = __fsub_rn(qy, r.y);
        const float dz = __fsub_rn(qz, r.z);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        if (d < best_d) {
          best_d = d;
          best_i = base + k;
        }
      }
    }
  }
  if (live) {
    idx[i] = best_i;
    d2[i] = best_d;
  }
}

}  // namespace

// q: (nq, 3) row-major; rt: (3, nr) row-major; idx, d2: (nq,). Launches on
// `stream` and returns cudaGetLastError() after the launch.
extern "C" int tpu3drec_icp_nn(const float* q, const float* rt, int nq, int nr,
                               int* idx, float* d2, void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (nq + kTileQ - 1) / kTileQ;
  icp_nn_kernel<<<blocks, kTileQ, 0, static_cast<cudaStream_t>(stream)>>>(
      q, rt, nq, nr, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
