// Bundle-adjustment block assembly: per observation, the reprojection
// residual, the closed-form Jacobians in the local (left-multiplicative)
// se(3) parameterisation and the weighted normal-equation blocks.
//
// Replaces tpu3drec/ops/ba_blocks.py::_ba_blocks_kernel (the Pallas TPU
// kernel called through ba_blocks). For observation o, with Xc = R X + t the
// camera-frame point, z clamped to 1e-9 where |z| < 1e-9:
//   res = [fx x/z + cx - u, fy y/z + cy - v]
//   J_cam (2x6) = dproj/dXc [-[Xc]_x | I],  J_pt (2x3) = dproj/dXc R
//   U = w Jc^T Jc (6x6), V = w Jp^T Jp (3x3), W = w Jc^T Jp (6x3),
//   bc = -w Jc^T r (6), bp = -w Jp^T r (3), and the raw rows Jc, Jp.
// Every expression is evaluated in the order the TPU kernel writes it, each
// product, sum and the one division rounded on its own (the build's
// -fmad=false keeps nvcc from fusing them), which is what the plain PyTorch
// version ba_blocks_plain computes; the two agree bit for bit. Only the data
// movement below is this card's own.
//
// What bounds it: bytes. Per observation it reads 15 floats (Xc 3, R 9,
// uv 2, w 1) and writes 92 (res 2, U 36, V 9, W 18, bc 6, bp 3, Jc 12,
// Jp 6): 428 bytes against ~250 flops, far below the card's ~20 flop/byte
// balance point. At O = 262,144 that is 112 MB, 0.0335 ms at 3.35 TB/s.
//
// Design: a streaming kernel whose every device-memory access is a warp's
// run of consecutive 16-byte words. One thread per observation would store
// each output row on its own: a warp's 32 rows of U lie 144 B apart, so one
// store instruction touches 32 sectors and a warp's 92 outputs take ~2,900
// partial-sector writes where 368 full ones do. So each warp takes a tile of
// 32 observations, whose rows of every array are one contiguous span:
//   * Inputs: the warp copies the tile's spans of xc (96 floats), rmat (288),
//     uv (64) and w (32) into its input stage by cp.async, 16 bytes a copy
//     (4 when a caller's input is not 16-byte aligned), then each thread
//     reads its own row there: strides 3 and 9 are odd, so 32 lanes hit 32
//     banks, and uv's stride 2 is read as one float2. As soon as every lane
//     has read its row, the copies of the warp's next tile start, and they
//     land while this tile's outputs are written.
//   * Outputs: each thread keeps the 21 values the outputs are built from
//     (Ju, Jv, Pu, Pv, ru, rv, w) in registers and writes one output array
//     at a time into its output stage, row-major as in device memory; the
//     warp then stores that array's span, 32 rows x k floats, as 16-byte
//     stores. The stage holds one array at a time (at most 36 x 32 floats,
//     4.6 KB a warp; 6.4 KB with the input stage), so shared memory stays
//     small.
//   * Banks: neither padding nor a swizzle is needed. A thread writes its
//     row with the widest access its width allows: float4 for U (36) and Jc
//     (12), float2 for W (18), bc (6), Jp (6) and res (2), scalars for V (9)
//     and bp (3). A float4 access is served 8 lanes at a time, and
//     36 x lane and 12 x lane (mod 32) put 8 lanes on 8 distinct groups of
//     4 banks; a float2 access 16 lanes at a time, and 18, 6 and 2 x lane
//     (mod 32) put 16 lanes on 16 distinct bank pairs; odd strides hit
//     distinct banks. The span's read-out is consecutive float4s.
//   * Ragged tail: the last tile has n - 32 t observations; its spans are
//     cut there (16-byte words, then single floats), so nothing is read or
//     written past n. Lanes past the tail compute on stale stage rows that
//     are never stored.
//   * Grid: blocks of 4 warps loop over the tiles with a grid stride. The
//     wrapper launches one block for every 4 tiles, at most two waves of the
//     blocks the card holds at once (the occupancy query below): on the
//     H100 two waves beat one persistent wave and one block for every 4
//     tiles alike (tools/time_ba_blocks.py).
//   * Offsets are 64-bit: spans start at k x 32 t floats, past 2^31 for
//     large n; n itself is an int.
// Every output region is 16-byte aligned (the wrapper lays the eight arrays
// out in one buffer so); the launch refuses a misaligned one. There is no
// interpret mode: the CPU runs ba_blocks_plain instead.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                // observations a warp takes at a time
constexpr int kWarps = 4;                // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kIn = 15 * kTile;          // floats of a warp's input stage
constexpr int kOut = 36 * kTile;         // floats of its output stage: the widest output

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// `count` floats from device memory at `src` into the stage at `dst`, the
// warp's lanes on consecutive words, as asynchronous copies: 16-byte words
// when kVec (src 16-byte aligned), then the remaining floats.
template <bool kVec>
__device__ __forceinline__ void load_span(float* dst, const float* __restrict__ src, int count,
                                          int lane) {
  int i0 = 0;
  if (kVec) {
    const int quads = count >> 2;
    for (int i = lane; i < quads; i += 32) cp_async16(dst + 4 * i, src + 4 * i);
    i0 = quads << 2;
  }
  for (int i = i0 + lane; i < count; i += 32) cp_async4(dst + i, src + i);
}

// Start the copies of tile t's inputs into the input stage: xc at [0, 96),
// rmat [96, 384), uv [384, 448), w [448, 480).
template <bool kVec>
__device__ __forceinline__ void load_tile(float* si, const float* __restrict__ xc,
                                          const float* __restrict__ rmat,
                                          const float* __restrict__ uv,
                                          const float* __restrict__ wt, int t, int n, int lane) {
  const long long o0 = static_cast<long long>(t) * kTile;
  const int nt = min(kTile, n - static_cast<int>(o0));
  load_span<kVec>(si, xc + 3 * o0, 3 * nt, lane);
  load_span<kVec>(si + 3 * kTile, rmat + 9 * o0, 9 * nt, lane);
  load_span<kVec>(si + 12 * kTile, uv + 2 * o0, 2 * nt, lane);
  load_span<kVec>(si + 14 * kTile, wt + o0, nt, lane);
  asm volatile("cp.async.commit_group;\n" ::);
}

// `count` floats of the stage at `src` to device memory at `dst` (16-byte
// aligned), as consecutive 16-byte words, then the remaining floats.
__device__ __forceinline__ void store_span(float* __restrict__ dst, const float* src, int count,
                                           int lane) {
  const int quads = count >> 2;
  for (int i = lane; i < quads; i += 32)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
  for (int i = (quads << 2) + lane; i < count; i += 32) dst[i] = src[i];
}

// One thread's row of K floats into the stage at row `lane`, with the widest
// access K allows (see the bank note at the head of the file).
template <int K>
__device__ __forceinline__ void stage_row(float* stage, int lane, const float (&v)[K]) {
  float* row = stage + K * lane;
  if constexpr (K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q)
      reinterpret_cast<float4*>(row)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                      v[4 * q + 3]);
  } else if constexpr (K % 2 == 0) {
#pragma unroll
    for (int q = 0; q < K / 2; ++q)
      reinterpret_cast<float2*>(row)[q] = make_float2(v[2 * q], v[2 * q + 1]);
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) row[q] = v[q];
  }
}

// Stage one output array of K floats a row and store the tile's span of it.
template <int K>
__device__ __forceinline__ void put(float* __restrict__ out, long long o0, int nt, float* stage,
                                    int lane, const float (&v)[K]) {
  __syncwarp();  // the stage's previous contents are read by every lane
  stage_row<K>(stage, lane, v);
  __syncwarp();
  store_span(out + K * o0, stage, K * nt, lane);
}

template <bool kVecIn>
__global__ void __launch_bounds__(kThreads)
ba_blocks_kernel(const float* __restrict__ xc, const float* __restrict__ rmat,
                 const float* __restrict__ uv, const float* __restrict__ wt, int n,
                 float fx, float fy, float cx, float cy,
                 float* __restrict__ res, float* __restrict__ U, float* __restrict__ V,
                 float* __restrict__ W, float* __restrict__ bc, float* __restrict__ bp,
                 float* __restrict__ Jc, float* __restrict__ Jp) {
  __shared__ __align__(16) float in_stages[kWarps][kIn];
  __shared__ __align__(16) float out_stages[kWarps][kOut];
  const int lane = threadIdx.x & 31;
  float* si = in_stages[threadIdx.x >> 5];
  float* s = out_stages[threadIdx.x >> 5];
  const int tiles = (n - 1) / kTile + 1;
  const int stride = gridDim.x * kWarps;
  int t = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (t < tiles) load_tile<kVecIn>(si, xc, rmat, uv, wt, t, n, lane);
  for (; t < tiles; t += stride) {
    const long long o0 = static_cast<long long>(t) * kTile;
    const int nt = min(kTile, n - static_cast<int>(o0));

    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncwarp();  // every lane's copies of this tile have landed
    const float x = si[3 * lane], y = si[3 * lane + 1];
    const float zr = si[3 * lane + 2];
    const float* r = si + 3 * kTile + 9 * lane;
    const float r0 = r[0], r1 = r[1], r2 = r[2], r3 = r[3], r4 = r[4], r5 = r[5];
    const float r6 = r[6], r7 = r[7], r8 = r[8];
    const float2 m = reinterpret_cast<const float2*>(si + 12 * kTile)[lane];
    const float w = si[14 * kTile + lane];
    __syncwarp();  // every lane has read its row: the next tile's inputs may land
    if (t + stride < tiles) load_tile<kVecIn>(si, xc, rmat, uv, wt, t + stride, n, lane);

    const float z = fabsf(zr) < 1e-9f ? 1e-9f : zr;
    const float inv_z = 1.0f / z;
    const float inv_z2 = inv_z * inv_z;
    const float ru = fx * x * inv_z + cx - m.x;
    const float rv = fy * y * inv_z + cy - m.y;

    // dproj/dXc rows: a = [fx/z, 0, -fx x/z^2], b = [0, fy/z, -fy y/z^2]
    const float a0 = fx * inv_z;
    const float a2 = -fx * x * inv_z2;
    const float b1 = fy * inv_z;
    const float b2 = -fy * y * inv_z2;

    // J_cam columns: rotation part dproj/dXc (-[Xc]_x), then the identity
    const float Ju[6] = {a2 * y, a0 * z - a2 * x, -a0 * y, a0, 0.f, a2};
    const float Jv[6] = {-b1 * z + b2 * y, -b2 * x, b1 * x, 0.f, b1, b2};
    const float Pu[3] = {a0 * r0 + a2 * r6, a0 * r1 + a2 * r7, a0 * r2 + a2 * r8};
    const float Pv[3] = {b1 * r3 + b2 * r6, b1 * r4 + b2 * r7, b1 * r5 + b2 * r8};

    {
      const float v[2] = {ru, rv};
      put<2>(res, o0, nt, s, lane, v);
    }
    {
      float v[36];
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b) v[6 * a + b] = w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
      put<36>(U, o0, nt, s, lane, v);
    }
    {
      float v[9];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) v[3 * a + b] = w * (Pu[a] * Pu[b] + Pv[a] * Pv[b]);
      put<9>(V, o0, nt, s, lane, v);
    }
    {
      float v[18];
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) v[3 * a + b] = w * (Ju[a] * Pu[b] + Jv[a] * Pv[b]);
      put<18>(W, o0, nt, s, lane, v);
    }
    const float nw = -w;
    {
      float v[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) v[a] = nw * (Ju[a] * ru + Jv[a] * rv);
      put<6>(bc, o0, nt, s, lane, v);
    }
    {
      float v[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) v[a] = nw * (Pu[a] * ru + Pv[a] * rv);
      put<3>(bp, o0, nt, s, lane, v);
    }
    // raw rows for the matrix-free Schur products: Jc = [Ju; Jv], Jp = [Pu; Pv]
    {
      const float v[12] = {Ju[0], Ju[1], Ju[2], Ju[3], Ju[4], Ju[5],
                           Jv[0], Jv[1], Jv[2], Jv[3], Jv[4], Jv[5]};
      put<12>(Jc, o0, nt, s, lane, v);
    }
    {
      const float v[6] = {Pu[0], Pu[1], Pu[2], Pv[0], Pv[1], Pv[2]};
      put<6>(Jp, o0, nt, s, lane, v);
    }
  }
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

}  // namespace

// Blocks of the kernel one SM holds at once (the wrapper's grid is at most
// twice this times the SM count).
extern "C" int tpu3drec_ba_blocks_blocks_per_sm(int* blocks) {
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, ba_blocks_kernel<true>, kThreads, 0));
}

// xc: (n, 3), rmat: (n, 9), uv: (n, 2), w: (n,) float32 row-major; outputs
// res (n, 2), U (n, 36), V (n, 9), W (n, 18), bc (n, 6), bp (n, 3), Jc (n, 12),
// Jp (n, 6), each 16-byte aligned. Launches `blocks` blocks on `stream` and
// returns cudaGetLastError() (cudaErrorMisalignedAddress for a misaligned
// output, cudaErrorInvalidValue for no blocks).
extern "C" int tpu3drec_ba_blocks(const float* xc, const float* rmat, const float* uv,
                                  const float* w, int n, float fx, float fy, float cx,
                                  float cy, float* res, float* U, float* V, float* W,
                                  float* bc, float* bp, float* Jc, float* Jp, int blocks,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const float* outs[8] = {res, U, V, W, bc, bp, Jc, Jp};
  for (const float* p : outs)
    if (misaligned(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (misaligned(xc) || misaligned(rmat) || misaligned(uv) || misaligned(w))
    ba_blocks_kernel<false><<<blocks, kThreads, 0, s>>>(xc, rmat, uv, w, n, fx, fy, cx, cy, res,
                                                       U, V, W, bc, bp, Jc, Jp);
  else
    ba_blocks_kernel<true><<<blocks, kThreads, 0, s>>>(xc, rmat, uv, w, n, fx, fy, cx, cy, res,
                                                      U, V, W, bc, bp, Jc, Jp);
  return static_cast<int>(cudaGetLastError());
}
