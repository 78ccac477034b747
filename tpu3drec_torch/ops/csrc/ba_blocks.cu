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
// version ba_blocks_plain computes; the two agree bit for bit.
//
// What bounds it: bytes. Per observation it reads 15 floats (Xc 3, R 9,
// uv 2, w 1) and writes 92 (res 2, U 36, V 9, W 18, bc 6, bp 3, Jc 12,
// Jp 6): 428 bytes against ~250 flops, far below the card's ~20 flop/byte
// balance point. At O = 65,536 that is 28.0 MB, 0.0084 ms at 3.35 TB/s.
//
// Design: purely elementwise, one thread per observation, as the TPU
// kernel's tiles of 512 rows were. Each thread reads its row, keeps the
// Jacobian rows in registers and writes the outputs row-major. The
// intrinsics arrive as four scalars. The ragged end is cut by count (the TPU
// wrapper padded to a tile of 512). There is no interpret mode: the CPU runs
// ba_blocks_plain instead.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ba_blocks_kernel(const float* __restrict__ xc, const float* __restrict__ rmat,
                 const float* __restrict__ uv, const float* __restrict__ wt, int n,
                 float fx, float fy, float cx, float cy,
                 float* __restrict__ res, float* __restrict__ U, float* __restrict__ V,
                 float* __restrict__ W, float* __restrict__ bc, float* __restrict__ bp,
                 float* __restrict__ Jc, float* __restrict__ Jp) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= n) return;
  const float x = xc[3 * o], y = xc[3 * o + 1];
  const float zr = xc[3 * o + 2];
  const float z = fabsf(zr) < 1e-9f ? 1e-9f : zr;
  const float inv_z = 1.0f / z;
  const float inv_z2 = inv_z * inv_z;
  const float w = wt[o];

  const float ru = fx * x * inv_z + cx - uv[2 * o];
  const float rv = fy * y * inv_z + cy - uv[2 * o + 1];
  res[2 * o] = ru;
  res[2 * o + 1] = rv;

  // dproj/dXc rows: a = [fx/z, 0, -fx x/z^2], b = [0, fy/z, -fy y/z^2]
  const float a0 = fx * inv_z;
  const float a2 = -fx * x * inv_z2;
  const float b1 = fy * inv_z;
  const float b2 = -fy * y * inv_z2;

  // J_cam columns: rotation part dproj/dXc (-[Xc]_x), then the identity
  const float Ju[6] = {a2 * y, a0 * z - a2 * x, -a0 * y, a0, 0.f, a2};
  const float Jv[6] = {-b1 * z + b2 * y, -b2 * x, b1 * x, 0.f, b1, b2};
  const float* r = rmat + 9 * o;
  const float Pu[3] = {a0 * r[0] + a2 * r[6], a0 * r[1] + a2 * r[7], a0 * r[2] + a2 * r[8]};
  const float Pv[3] = {b1 * r[3] + b2 * r[6], b1 * r[4] + b2 * r[7], b1 * r[5] + b2 * r[8]};

  float* Uo = U + 36 * o;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) Uo[6 * a + b] = w * (Ju[a] * Ju[b] + Jv[a] * Jv[b]);
  float* Vo = V + 9 * o;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) Vo[3 * a + b] = w * (Pu[a] * Pu[b] + Pv[a] * Pv[b]);
  float* Wo = W + 18 * o;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) Wo[3 * a + b] = w * (Ju[a] * Pu[b] + Jv[a] * Pv[b]);
  const float nw = -w;
#pragma unroll
  for (int a = 0; a < 6; ++a) bc[6 * o + a] = nw * (Ju[a] * ru + Jv[a] * rv);
#pragma unroll
  for (int a = 0; a < 3; ++a) bp[3 * o + a] = nw * (Pu[a] * ru + Pv[a] * rv);
  // raw rows for the matrix-free Schur products: Jc = [Ju; Jv], Jp = [Pu; Pv]
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    Jc[12 * o + a] = Ju[a];
    Jc[12 * o + 6 + a] = Jv[a];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    Jp[6 * o + a] = Pu[a];
    Jp[6 * o + 3 + a] = Pv[a];
  }
}

}  // namespace

// xc: (n, 3), rmat: (n, 9), uv: (n, 2), w: (n,) float32 row-major; outputs
// res (n, 2), U (n, 36), V (n, 9), W (n, 18), bc (n, 6), bp (n, 3), Jc (n, 12),
// Jp (n, 6). Launches on `stream` and returns cudaGetLastError().
extern "C" int tpu3drec_ba_blocks(const float* xc, const float* rmat, const float* uv,
                                  const float* w, int n, float fx, float fy, float cx,
                                  float cy, float* res, float* U, float* V, float* W,
                                  float* bc, float* bp, float* Jc, float* Jp, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kThreads - 1) / kThreads;
  ba_blocks_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      xc, rmat, uv, w, n, fx, fy, cx, cy, res, U, V, W, bc, bp, Jc, Jp);
  return static_cast<int>(cudaGetLastError());
}
