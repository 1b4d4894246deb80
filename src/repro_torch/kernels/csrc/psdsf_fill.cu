// One saturation event of the PS-DSF bisection fill for every server.
//
// Replaces the TPU kernel repro/kernels/psdsf_fill/kernel.py::_fill_kernel
// (entry fill_event_levels). For every server i it finds the first level L
// at which some non-saturated resource r of i reaches its capacity, where
// the usage is the monotone piecewise-linear
//     U_{i,r}(L) = frozen[i,r] + sum_n d[n,r] rate[n,i] max(0, L - f[n,i]),
// by a fixed number of bisection steps, and returns the level, the usage
// and the local slope there, and the total slope. Semantics kept exactly:
// BIG = 3e38, TOL = 1e-9, level = max(hi, level_in) with no segment root,
// a collapsed bracket (hi = lo) when no resource of the server can bind.
//
// What bounds it on an H100: per event the function must read floors and
// rate (2*N*K values) and demands (N*R) once, and do (steps+3)*N*K*(2R+3)
// operations; by those counts it is bound by operations (ratio about 40
// flop/byte in float32). This simple design re-reads floors and rate once
// per pass (steps+3 passes) from L2 or device memory instead, and at K=256
// its tiles of 8 servers make only 32 blocks for 132 SMs, so in practice it
// is bound by those re-reads at low occupancy. Making it fast is later work.
//
// Design. On the TPU the (phase, user tile) grid axes run in order and
// carry the bracket in VMEM scratch. Blocks here run in no order, so each
// block owns a tile of TK servers and runs the whole phase sequence (slope
// pass, bracket pass, `steps` bisection passes, output pass) as a loop.
// threadIdx.x walks neighbouring servers, so the row-major (N, K) loads of
// floors and rate coalesce; threadIdx.y splits the user axis into WN lanes.
// demands[n, :R] is staged in shared memory a chunk of users at a time.
// Each pass is a per-server sum over users: a warp-shuffle sum over the
// lanes of one server, then a shared-memory sum over warps, after which one
// thread per server takes the bisection decision and publishes the next
// evaluation level. Ragged N and K are masked, never padded. R is a template
// parameter (1..8) so every per-resource array lives in registers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TK = 8;             // servers per block (threadIdx.x)
constexpr int WN = 64;            // user lanes per block (threadIdx.y)
constexpr int NT = TK * WN;       // threads per block
constexpr int NWARP = NT / 32;
constexpr int CH = 256;           // users staged in shared memory at once
constexpr int MAX_R = 8;          // R template cases: 1..MAX_R

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 3.0e38f; }
template <> __device__ __forceinline__ double big<double>() { return 3.0e38; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// sum over the 4 lanes of a warp that hold the same server (lane % TK)
template <typename T>
__device__ __forceinline__ T lane_sum(T v) {
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

template <typename T>
__device__ __forceinline__ T lane_max(T v) {
  v = tmax(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = tmax(v, __shfl_xor_sync(0xffffffffu, v, 16));
  return v;
}

template <typename T, int R>
__global__ void __launch_bounds__(NT) fill_event_kernel(
    const T* __restrict__ floors, const T* __restrict__ rate,
    const T* __restrict__ dem, const T* __restrict__ caps,
    const T* __restrict__ frozen, const uint8_t* __restrict__ sat,
    const T* __restrict__ level, T* __restrict__ lvl_out,
    T* __restrict__ u_out, T* __restrict__ lsl_out, T* __restrict__ slope_out,
    int n, int k, int steps) {
  __shared__ T s_dem[CH * R];
  __shared__ T s_red[NWARP][TK][R];
  __shared__ T s_red2[NWARP][TK][R];
  __shared__ T s_fmax[NWARP][TK];
  __shared__ T s_pt[TK];

  const T TOL = T(1e-9);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = tx + TK * ty;
  const int lane = tid & 31, warp = tid >> 5;
  const int col = blockIdx.x * TK + tx;
  const bool live = col < k;
  const bool owner = live && ty == 0;   // holds this server's bracket

  T slope[R], cap[R], frz[R];
  bool canb[R];
  T lo = T(0), hi = T(0), hi0 = T(0), lvl_in = T(0);
  if (owner) {
    lvl_in = level[col];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      cap[q] = caps[(size_t)col * R + q];
      frz[q] = frozen[(size_t)col * R + q];
      canb[q] = sat[(size_t)col * R + q] == 0;   // refined after pass 0
      slope[q] = T(0);
    }
  }

  const int passes = steps + 3;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    const T pt = p == 0 ? T(0) : s_pt[tx];
    T acc[R], acc2[R];
#pragma unroll
    for (int q = 0; q < R; ++q) { acc[q] = T(0); acc2[q] = T(0); }
    T fmx = T(0);

    for (int c0 = 0; c0 < n; c0 += CH) {
      const int cn = min(CH, n - c0);
      __syncthreads();
      for (int i = tid; i < cn * R; i += NT) s_dem[i] = dem[(size_t)c0 * R + i];
      __syncthreads();
      if (!live) continue;
#pragma unroll 4
      for (int j = ty; j < cn; j += WN) {
        const size_t idx = (size_t)(c0 + j) * k + col;
        const T f = floors[idx];
        const T rt = rate[idx];
        const T* d = s_dem + j * R;
        if (p == 0) {
          if (rt > T(0)) fmx = tmax(fmx, f);
#pragma unroll
          for (int q = 0; q < R; ++q) acc[q] += rt * d[q];
        } else {
          const T t = rt * tmax(pt - f, T(0));
#pragma unroll
          for (int q = 0; q < R; ++q) acc[q] += t * d[q];
          if (last) {
            const T t2 = f <= pt ? rt : T(0);
#pragma unroll
            for (int q = 0; q < R; ++q) acc2[q] += t2 * d[q];
          }
        }
      }
    }

#pragma unroll
    for (int q = 0; q < R; ++q) {
      acc[q] = lane_sum(acc[q]);
      acc2[q] = lane_sum(acc2[q]);
    }
    fmx = lane_max(fmx);
    if (lane < TK) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        s_red[warp][tx][q] = acc[q];
        s_red2[warp][tx][q] = acc2[q];
      }
      s_fmax[warp][tx] = fmx;
    }
    __syncthreads();

    if (owner) {
      T tot[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        tot[q] = T(0);
        for (int w = 0; w < NWARP; ++w) tot[q] += s_red[w][tx][q];
      }
      T next = T(0);
      if (p == 0) {                       // slope pass: total slope, bracket base
        T fm = T(0);
        for (int w = 0; w < NWARP; ++w) fm = tmax(fm, s_fmax[w][tx]);
#pragma unroll
        for (int q = 0; q < R; ++q) {
          slope[q] = tot[q];
          canb[q] = canb[q] && slope[q] > TOL;
        }
        hi0 = tmax(fm, lvl_in);
        lo = lvl_in;
        next = hi0;
      } else if (p == 1) {                // bracket pass: tightest headroom step
        T step_up = big<T>();
        bool has = false;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (!canb[q]) continue;
          has = true;
          const T head = tmax(cap[q] - frz[q] - tot[q], T(0));
          const T s = head / tmax(slope[q], TOL);
          step_up = s < step_up ? s : step_up;
        }
        // no resource can bind: collapse the bracket, the event is a no-op
        hi = has ? hi0 + step_up : lo;
        next = steps > 0 ? T(0.5) * (lo + hi) : tmax(hi, lvl_in);
      } else if (!last) {                 // bisection pass at mid = pt
        bool crossed = false;
#pragma unroll
        for (int q = 0; q < R; ++q)
          crossed = crossed || (canb[q] && frz[q] + tot[q] >= cap[q]);
        const T mid = T(0.5) * (lo + hi);
        lo = crossed ? lo : mid;
        hi = crossed ? mid : hi;
        next = p + 1 < passes - 1 ? T(0.5) * (lo + hi) : tmax(hi, lvl_in);
      } else {                            // output pass at the event level
        lvl_out[col] = pt;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          T t2 = T(0);
          for (int w = 0; w < NWARP; ++w) t2 += s_red2[w][tx][q];
          u_out[(size_t)col * R + q] = frz[q] + tot[q];
          lsl_out[(size_t)col * R + q] = t2;
          slope_out[(size_t)col * R + q] = slope[q];
        }
      }
      s_pt[tx] = next;
    }
    __syncthreads();
  }
}

template <typename T, int R>
int launch(const T* floors, const T* rate, const T* dem, const T* caps,
           const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
           T* u_out, T* lsl_out, T* slope_out, int n, int k, int steps,
           cudaStream_t stream) {
  const dim3 block(TK, WN);
  const dim3 grid((k + TK - 1) / TK);
  fill_event_kernel<T, R><<<grid, block, 0, stream>>>(
      floors, rate, dem, caps, frozen, sat, level, lvl_out, u_out, lsl_out,
      slope_out, n, k, steps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* floors, const T* rate, const T* dem, const T* caps,
             const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
             T* u_out, T* lsl_out, T* slope_out, int n, int k, int r,
             int steps, void* stream) {
  if (n < 0 || k <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PSDSF_FILL_CASE(RR)                                                  \
  case RR:                                                                   \
    return launch<T, RR>(floors, rate, dem, caps, frozen, sat, level,        \
                         lvl_out, u_out, lsl_out, slope_out, n, k, steps, s);
  switch (r) {
    PSDSF_FILL_CASE(1)
    PSDSF_FILL_CASE(2)
    PSDSF_FILL_CASE(3)
    PSDSF_FILL_CASE(4)
    PSDSF_FILL_CASE(5)
    PSDSF_FILL_CASE(6)
    PSDSF_FILL_CASE(7)
    PSDSF_FILL_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PSDSF_FILL_CASE
}

}  // namespace

extern "C" int psdsf_fill_f32(const float* floors, const float* rate,
                              const float* dem, const float* caps,
                              const float* frozen, const uint8_t* sat,
                              const float* level, float* lvl_out,
                              float* u_out, float* lsl_out, float* slope_out,
                              int n, int k, int r, int steps, void* stream) {
  return dispatch<float>(floors, rate, dem, caps, frozen, sat, level,
                         lvl_out, u_out, lsl_out, slope_out, n, k, r, steps,
                         stream);
}

extern "C" int psdsf_fill_f64(const double* floors, const double* rate,
                              const double* dem, const double* caps,
                              const double* frozen, const uint8_t* sat,
                              const double* level, double* lvl_out,
                              double* u_out, double* lsl_out,
                              double* slope_out, int n, int k, int r,
                              int steps, void* stream) {
  return dispatch<double>(floors, rate, dem, caps, frozen, sat, level,
                          lvl_out, u_out, lsl_out, slope_out, n, k, r, steps,
                          stream);
}
