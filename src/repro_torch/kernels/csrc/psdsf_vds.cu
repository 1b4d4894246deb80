// Per-server minimum normalized virtual dominant share (Eq. 16).
//
// Replaces the TPU kernel repro/kernels/psdsf_vds/kernel.py::_vds_kernel
// (entry vds_argmin). For every server i:
//     min_i    = min_n x_over_phi[n] / gamma[n, i]   (gamma <= 0 reads 3e38)
//     argmin_i = the lowest row n attaining min_i
// in float32, as the TPU kernel computes it, with IEEE division (no
// fast-math reciprocal), so the minima equal the plain version's bit for bit.
//
// What bounds it on an H100: one read of gamma, N*K*4 bytes, plus N*4 for
// x_over_phi; about one operation per byte, so it is bound by device memory
// (20.5 MB at 20,000 x 256: about 6 us).
//
// Design. The TPU kernel walks the user axis in order and carries the
// running (min, argmin) in VMEM scratch. Here the grid splits both axes:
// blockIdx.x takes a tile of CT = 128 server columns, blockIdx.y a slab of
// user rows, about four blocks an SM in all (the wrapper sizes the slabs).
// Within a block each warp takes every NW-th row of the slab, a lane four
// neighbouring columns with one 16-byte load (`float4`; a scalar path takes
// the columns 32 apart when K % 4 != 0 or gamma is not 16-byte aligned),
// UNROLL rows in flight. A thread scans its rows in ascending order; warps
// are merged through shared memory and the slabs by a second kernel, both
// by the rule "smaller value, or equal value and lower row", a total order,
// so the result does not depend on the grid. A single slab writes the
// outputs itself. Ragged N and K are masked, never padded.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int CT = 128;        // server columns per block: 32 lanes x 4
constexpr int NW = 8;          // warps per block, each on its own rows
constexpr int NT = 32 * NW;
constexpr int UNROLL = 4;      // rows a warp has in flight
constexpr int MW = 8;          // merge kernel: slab lanes per column
constexpr float BIG = 3.0e38f;

__device__ __forceinline__ void take(float& m, int& a, float m2, int a2) {
  if (m2 < m || (m2 == m && a2 < a)) {
    m = m2;
    a = a2;
  }
}

// (min, argmin) of server columns over one slab of rows, per column
template <bool VEC>
__global__ void __launch_bounds__(NT) vds_slab_kernel(
    const float* __restrict__ xphi, const float* __restrict__ gamma,
    float* __restrict__ part_min, int* __restrict__ part_arg, int n, int k,
    int rows) {
  __shared__ float s_m[NW][CT];
  __shared__ int s_a[NW][CT];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * CT;
  const int r0 = blockIdx.y * rows;
  const int r1 = min(n, r0 + rows);
  // the tile-local column of this lane's c-th value
  auto local = [&](int c) { return VEC ? lane * 4 + c : c * 32 + lane; };

  float m[4];
  int a[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    m[c] = BIG;
    a[c] = INT_MAX;
  }
  for (int base = r0 + warp; base < r1; base += NW * UNROLL) {
    float g[UNROLL][4], x[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = base + u * NW;
      const float* gr = gamma + (size_t)row * k + c0;
      x[u] = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) g[u][c] = 0.f;
      if (row < r1) {
        x[u] = xphi[row];
        if constexpr (VEC) {
          if (c0 + local(0) < k) {        // K % 4 == 0: all four or none
            const float4 v = __ldg(reinterpret_cast<const float4*>(
                gr + local(0)));
            g[u][0] = v.x;
            g[u][1] = v.y;
            g[u][2] = v.z;
            g[u][3] = v.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c0 + local(c) < k) g[u][c] = __ldg(gr + local(c));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int row = base + u * NW;
      if (row < r1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float v = g[u][c] > 0.f ? __fdiv_rn(x[u], g[u][c]) : BIG;
          take(m[c], a[c], v, row);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    s_m[warp][local(c)] = m[c];
    s_a[warp][local(c)] = a[c];
  }
  __syncthreads();
  if (threadIdx.x < CT && c0 + threadIdx.x < k) {
    const int lc = threadIdx.x;
    float mm = s_m[0][lc];
    int aa = s_a[0][lc];
    for (int w = 1; w < NW; ++w) take(mm, aa, s_m[w][lc], s_a[w][lc]);
    const size_t o = (size_t)blockIdx.y * k + c0 + lc;
    part_min[o] = mm;
    part_arg[o] = aa;
  }
}

// merges the slabs' partials (slabs, K) into the outputs, per column
__global__ void __launch_bounds__(32 * MW) vds_merge_kernel(
    const float* __restrict__ part_min, const int* __restrict__ part_arg,
    float* __restrict__ min_out, int* __restrict__ arg_out, int slabs,
    int k) {
  __shared__ float s_m[MW][32];
  __shared__ int s_a[MW][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float m = BIG;
  int a = INT_MAX;
  if (col < k) {
#pragma unroll 4
    for (int s = ty; s < slabs; s += MW) {
      const size_t o = (size_t)s * k + col;
      take(m, a, part_min[o], part_arg[o]);
    }
  }
  s_m[ty][tx] = m;
  s_a[ty][tx] = a;
  __syncthreads();
  if (ty == 0 && col < k) {
    for (int w = 1; w < MW; ++w) take(m, a, s_m[w][tx], s_a[w][tx]);
    min_out[col] = m;
    arg_out[col] = a;
  }
}

int merge(const float* part_min, const int* part_arg, float* min_out,
          int* arg_out, int slabs, int k, cudaStream_t s) {
  vds_merge_kernel<<<(k + 31) / 32, dim3(32, MW), 0, s>>>(
      part_min, part_arg, min_out, arg_out, slabs, k);
  return (int)cudaGetLastError();
}

}  // namespace

// slabs of `rows` user rows (the last one ragged); with one slab the
// outputs are written directly and part_min / part_arg are not touched
extern "C" int psdsf_vds_f32(const float* xphi, const float* gamma,
                             float* part_min, int* part_arg, float* min_out,
                             int* arg_out, int n, int k, int rows,
                             void* stream) {
  if (n <= 0 || k <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const int slabs = (n + rows - 1) / rows;
  if (slabs > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((k + CT - 1) / CT, slabs);
  float* pm = slabs == 1 ? min_out : part_min;
  int* pa = slabs == 1 ? arg_out : part_arg;
  const bool vec = k % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(gamma) % 16 == 0;
  if (vec)
    vds_slab_kernel<true><<<grid, NT, 0, s>>>(xphi, gamma, pm, pa, n, k,
                                              rows);
  else
    vds_slab_kernel<false><<<grid, NT, 0, s>>>(xphi, gamma, pm, pa, n, k,
                                               rows);
  const int err = (int)cudaGetLastError();
  if (err || slabs == 1) return err;
  return merge(part_min, part_arg, min_out, arg_out, slabs, k, s);
}

// the merge kernel alone, on partials the slab kernel wrote (for timing)
extern "C" int psdsf_vds_merge_f32(const float* part_min, const int* part_arg,
                                   float* min_out, int* arg_out, int slabs,
                                   int k, void* stream) {
  if (slabs <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  return merge(part_min, part_arg, min_out, arg_out, slabs, k,
               static_cast<cudaStream_t>(stream));
}
