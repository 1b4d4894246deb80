// Per-server minimum normalized virtual dominant share (Eq. 16).
//
// Replaces the TPU kernel repro/kernels/psdsf_vds/kernel.py::_vds_kernel
// (entry vds_argmin). For every server i:
//     min_i    = min_n x_over_phi[n] / gamma[n, i]   (gamma <= 0 reads 3e38)
//     argmin_i = the lowest row n attaining min_i
// in float32, as the TPU kernel computes it.
//
// What bounds it on an H100: one read of gamma, N*K*4 bytes, plus N*4 for
// x_over_phi; about one operation per byte, so it is bound by device memory.
//
// Design. The TPU kernel walks the user axis in order and carries the
// running (min, argmin) in VMEM scratch. Here each block owns a tile of TK
// neighbouring server columns, so the row-major loads of gamma coalesce,
// and threadIdx.y splits the user axis into WN lanes. Each thread scans its
// rows in ascending order with a strict "<", which keeps its lowest row on
// ties; lanes are combined by warp shuffles and warps through shared
// memory, both with the rule "smaller value, or equal value and lower row".
// Ragged N and K are masked, never padded. With TK = 8 a 256-server cluster
// gives 32 blocks, which is below what fills 132 SMs: a later change may
// split the user axis across blocks as well.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TK = 8;          // server columns per block (threadIdx.x)
constexpr int WN = 128;        // user lanes per block (threadIdx.y)
constexpr int NT = TK * WN;
constexpr int NWARP = NT / 32;
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ void take(float& m, int& a, float m2, int a2) {
  if (m2 < m || (m2 == m && a2 < a)) {
    m = m2;
    a = a2;
  }
}

__global__ void __launch_bounds__(NT) vds_kernel(
    const float* __restrict__ xphi, const float* __restrict__ gamma,
    float* __restrict__ min_out, int* __restrict__ arg_out, int n, int k) {
  __shared__ float s_m[NWARP][TK];
  __shared__ int s_a[NWARP][TK];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = tx + TK * ty;
  const int lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * TK + tx;

  float m = BIG;
  int a = INT_MAX;
  if (col < k) {
#pragma unroll 4
    for (int row = ty; row < n; row += WN) {
      const float g = gamma[(size_t)row * k + col];
      const float v = g > 0.f ? xphi[row] / g : BIG;
      take(m, a, v, row);
    }
  }
  // lanes holding the same column differ by multiples of TK
  for (int off = TK; off < 32; off <<= 1)
    take(m, a, __shfl_xor_sync(0xffffffffu, m, off),
         __shfl_xor_sync(0xffffffffu, a, off));
  if (lane < TK) {
    s_m[warp][tx] = m;
    s_a[warp][tx] = a;
  }
  __syncthreads();
  if (ty == 0 && col < k) {
    for (int w = 1; w < NWARP; ++w) take(m, a, s_m[w][tx], s_a[w][tx]);
    min_out[col] = m;
    arg_out[col] = a;
  }
}

}  // namespace

extern "C" int psdsf_vds_f32(const float* xphi, const float* gamma,
                             float* min_out, int* arg_out, int n, int k,
                             void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const dim3 block(TK, WN);
  const dim3 grid((k + TK - 1) / TK);
  vds_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xphi, gamma, min_out, arg_out, n, k);
  return (int)cudaGetLastError();
}
