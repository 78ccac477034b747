// Nearest neighbour of every query point among the reference points, for ICP.
//
// Replaces tpu3drec/ops/icp_nn.py::_nn_kernel (the Pallas TPU kernel called
// through nearest_neighbors_pallas). For each query it returns the index and
// the squared distance of the nearest reference point:
//   * distances by direct differences, dx*dx + dy*dy + dz*dz, each product
//     and sum rounded on its own (__fmul_rn/__fadd_rn, so no fused
//     multiply-add), which is what the plain PyTorch version computes;
//   * ties go to the lowest reference index;
//   * the running minimum starts at 1e30 with index 0, as in the TPU kernel.
//
// What bounds it: fp32 arithmetic on the CUDA cores. The JAX package counts
// 9 flop per query/reference pair (icp_nn.py:108); at 67 TFLOP/s fp32 that
// is the bound, 0.792 ms at 76,800 x 76,800. Without fused multiply-adds a
// pair costs 3 subtractions, 3 multiplies, 2 adds and a share of a min, ~9
// issued instructions, so 132 SMs x 128 lanes at ~1.98 GHz cannot go below
// ~1.6 ms there: that issue floor, not the bound, is the target. Bytes are
// negligible: (Nq + Nr) * 12 in, Nq * 8 out.
//
// Design.
//   * A thread holds four queries, (x, y, z, best_d, best_i) each in
//     registers, so every reference read from shared memory serves four
//     pairs. A block of 128 threads owns 512 queries.
//   * References are staged in tiles of 1024 as three coordinate planes
//     (the wrapper passes them transposed, (3, Nr)), padded to a group of 8
//     with +inf, which never beats the 1e30 start. A group's 8 points are six
//     float4 loads, the same address in every thread: a broadcast.
//   * The index is off the per-pair chain: a query takes the 8 distances of
//     a group and their minimum m (fminf, exact, and like `d < best` it
//     ignores NaN). Only when m < best_d does it look for the first j with
//     d_j == m. Groups are visited in increasing index, so this is the
//     strict `<` scan of the TPU kernel.
//   * The references are cut into contiguous splits, one per blockIdx.y, so
//     that the grid fills the card evenly (the wrapper picks the count from
//     the SM count and the occupancy this build reports, ops/icp_nn.py::
//     split_plan). Each split's answer is merged into one 64-bit key per
//     query by atomicMin: key = bits(d) << 32 | idx. For d >= 0 the float's
//     bits order like an unsigned integer, so the smallest key is the
//     smallest d and then the lowest index: the unsplit answer, in any order
//     of arrival. The wrapper starts the keys at key(1e30, 0), the TPU
//     kernel's start state; a second small __global__ unpacks idx and d2.
// The Nq x Nr distance matrix never exists in device memory. There is no
// interpret mode: the CPU runs nearest_neighbors_plain instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kQPer = 4;                   // queries per thread: t + 128 i
constexpr int kQBlock = kThreads * kQPer;  // queries per block
constexpr int kGroup = 8;                  // references per min-then-scan group
constexpr int kTileR = 1024;               // references staged per pass

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float rx, float ry,
                                       float rz) {
  const float dx = __fsub_rn(qx, rx);
  const float dy = __fsub_rn(qy, ry);
  const float dz = __fsub_rn(qz, rz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(kThreads)
icp_nn_kernel(const float* __restrict__ q, const float* __restrict__ rt, int nq, int nr,
              int chunk, unsigned long long* __restrict__ keys) {
  __shared__ __align__(16) float xs[kTileR];
  __shared__ __align__(16) float ys[kTileR];
  __shared__ __align__(16) float zs[kTileR];

  const int r_begin = blockIdx.y * chunk;
  const int r_end = min(nr, r_begin + chunk);
  const int q0 = blockIdx.x * kQBlock + threadIdx.x;
  float qx[kQPer], qy[kQPer], qz[kQPer], best_d[kQPer];
  int best_i[kQPer];
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int qi = min(q0 + i * kThreads, nq - 1);  // a dead slot repeats the last query
    qx[i] = q[3 * qi];
    qy[i] = q[3 * qi + 1];
    qz[i] = q[3 * qi + 2];
    best_d[i] = 1e30f;
    best_i[i] = 0;
  }
  const float inf = __int_as_float(0x7f800000);

  for (int base = r_begin; base < r_end; base += kTileR) {
    const int n = min(kTileR, r_end - base);
    const int groups = (n + kGroup - 1) / kGroup;
    __syncthreads();  // the previous tile has been read by every thread
    for (int k = threadIdx.x; k < groups * kGroup; k += kThreads) {
      const bool in = k < n;
      xs[k] = in ? rt[base + k] : inf;
      ys[k] = in ? rt[nr + base + k] : inf;
      zs[k] = in ? rt[2 * nr + base + k] : inf;
    }
    __syncthreads();
    for (int g = 0; g < groups; ++g) {
      const float4 x0 = *reinterpret_cast<const float4*>(&xs[g * kGroup]);
      const float4 x1 = *reinterpret_cast<const float4*>(&xs[g * kGroup + 4]);
      const float4 y0 = *reinterpret_cast<const float4*>(&ys[g * kGroup]);
      const float4 y1 = *reinterpret_cast<const float4*>(&ys[g * kGroup + 4]);
      const float4 z0 = *reinterpret_cast<const float4*>(&zs[g * kGroup]);
      const float4 z1 = *reinterpret_cast<const float4*>(&zs[g * kGroup + 4]);
      const float rx[kGroup] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      const float ry[kGroup] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
      const float rz[kGroup] = {z0.x, z0.y, z0.z, z0.w, z1.x, z1.y, z1.z, z1.w};
#pragma unroll
      for (int i = 0; i < kQPer; ++i) {
        float d[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) d[j] = dist2(qx[i], qy[i], qz[i], rx[j], ry[j], rz[j]);
        const float m = fminf(fminf(fminf(d[0], d[1]), fminf(d[2], d[3])),
                              fminf(fminf(d[4], d[5]), fminf(d[6], d[7])));
        if (m < best_d[i]) {
          int first = kGroup - 1;
#pragma unroll
          for (int j = kGroup - 2; j >= 0; --j) first = d[j] == m ? j : first;
          best_d[i] = m;
          best_i[i] = base + g * kGroup + first;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kQPer; ++i) {
    const int qi = q0 + i * kThreads;
    if (qi < nq && best_d[i] < 1e30f) {  // an unchanged 1e30 is the start key already
      const unsigned long long key =
          (static_cast<unsigned long long>(__float_as_uint(best_d[i])) << 32) |
          static_cast<unsigned int>(best_i[i]);
      atomicMin(&keys[qi], key);
    }
  }
}

__global__ void icp_nn_unpack(const unsigned long long* __restrict__ keys, int nq,
                              int* __restrict__ idx, float* __restrict__ d2) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nq) {
    const unsigned long long key = keys[i];
    idx[i] = static_cast<int>(static_cast<unsigned int>(key & 0xffffffffull));
    d2[i] = __uint_as_float(static_cast<unsigned int>(key >> 32));
  }
}

}  // namespace

// Blocks of icp_nn_kernel that one SM holds at once, for the wrapper's
// split plan. Returns the CUDA error code.
extern "C" int tpu3drec_icp_nn_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, icp_nn_kernel, kThreads, 0));
}

// q: (nq, 3) row-major; rt: (3, nr) row-major; keys: (nq,) set to
// key(1e30, 0) by the caller; idx, d2: (nq,). References [s * chunk,
// (s + 1) * chunk) go to split s < splits. Launches the search and the
// unpacking on `stream` and returns cudaGetLastError() after them.
extern "C" int tpu3drec_icp_nn(const float* q, const float* rt, int nq, int nr, int splits,
                               int chunk, unsigned long long* keys, int* idx, float* d2,
                               void* stream) {
  if (nq <= 0) return static_cast<int>(cudaSuccess);
  if (nr <= 0 || splits <= 0 || splits > 65535 || chunk <= 0 ||
      static_cast<long long>(splits - 1) * chunk >= nr ||
      static_cast<long long>(splits) * chunk < nr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kQBlock - 1) / kQBlock, splits);
  icp_nn_kernel<<<grid, kThreads, 0, s>>>(q, rt, nq, nr, chunk, keys);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  icp_nn_unpack<<<(nq + 255) / 256, 256, 0, s>>>(keys, nq, idx, d2);
  return static_cast<int>(cudaGetLastError());
}
