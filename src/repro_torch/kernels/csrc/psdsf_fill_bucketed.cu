// One saturation event of the PS-DSF bisection fill for every server, on
// per-server eligibility buckets.
//
// Replaces the TPU kernel
// repro/kernels/psdsf_fill_bucketed/kernel.py::_fill_bucketed_kernel (entry
// fill_event_levels_bucketed). Server i sees only its bucket: Bmax slots of
// floors f[i,b], rates rate[i,b] and gathered demand rows d[i,b,:R] (padded,
// frozen and ineligible slots have rate 0 and are inert). For every server it
// finds the first level L at which some non-saturated resource r reaches its
// capacity, where the usage is the monotone piecewise-linear
//     U_{i,r}(L) = frozen[i,r] + sum_b d[i,b,r] rate[i,b] max(0, L - f[i,b]),
// by a fixed number of bisection steps, and returns the level, the usage
// and the local slope there, and the total slope. Semantics kept exactly:
// BIG = 3e38, TOL = 1e-9, level = max(hi, level_in) with no segment root,
// a collapsed bracket (hi = lo) when no resource of the server can bind.
//
// What bounds it on an H100: per event the function must read floors, rate
// and the demand rows once, K*Bmax*(R+2) values, and do
// (steps+3)*K*Bmax*(2R+3) operations. At the 20,000 x 256 pin in float64
// (Bmax 692, R 4, 48 steps) that is 8.5 MB against 99 MFLOP: bound by
// operations, about 3 us; at 20,000 x 1,024 in float32 (26 steps) bound by
// bytes, about 5 us.
//
// Design. The TPU grid carries the bisection bracket across a sequential
// (phase, bucket tile) axis in VMEM scratch. Here one thread block owns one
// server: it stages the server's floors, rates and demand rows in dynamic
// shared memory once (Bmax*(R+2) values; up to about 4,700 slots at R=4 in
// float64) and then runs the slope pass, the bracket pass, `steps` bisection
// passes and the output pass from there, so device memory is read once per
// event. Each pass is a per-server sum over the bucket: every thread sums a
// strided share of the slots, a warp-shuffle sum per warp, then the warps'
// partials in shared memory (double-buffered by pass parity, so one barrier
// per pass). Every thread then sums the same partials in the same order and
// takes the same bisection decision, so no thread has to publish the next
// evaluation level. A bucket too wide for shared memory is read from device
// memory (L2) in every pass instead (`stage` = 0), with the same arithmetic.
// Ragged K and Bmax are masked, never padded. R is a template parameter
// (1..8) so every per-resource array lives in registers. Making it fast
// (TMA staging, several servers per block, clusters) is later work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;           // threads per block (one server)
constexpr int NWARP = NT / 32;

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 3.0e38f; }
template <> __device__ __forceinline__ double big<double>() { return 3.0e38; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = tmax(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int R>
__global__ void __launch_bounds__(NT) fill_bucketed_kernel(
    const T* __restrict__ floors, const T* __restrict__ rate,
    const T* __restrict__ dem, const T* __restrict__ caps,
    const T* __restrict__ frozen, const uint8_t* __restrict__ sat,
    const T* __restrict__ level, T* __restrict__ lvl_out,
    T* __restrict__ u_out, T* __restrict__ lsl_out, T* __restrict__ slope_out,
    int bmax, int steps, int stage) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // per pass and warp: R usage sums, R local-slope sums, the max floor
  __shared__ T s_part[2][NWARP][2 * R + 1];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)i * bmax;
  const T* f = floors + row;
  const T* rt = rate + row;
  const T* d = dem + row * R;
  if (stage) {
    T* sd = reinterpret_cast<T*>(smem_raw);
    T* sf = sd + (size_t)bmax * R;
    T* sr = sf + bmax;
    for (int j = tid; j < bmax * R; j += NT) sd[j] = d[j];
    for (int j = tid; j < bmax; j += NT) {
      sf[j] = f[j];
      sr[j] = rt[j];
    }
    __syncthreads();
    f = sf;
    rt = sr;
    d = sd;
  }

  const T TOL = T(1e-9);
  const T lvl_in = level[i];
  T slope[R], cap[R], frz[R];
  bool canb[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cap[q] = caps[(size_t)i * R + q];
    frz[q] = frozen[(size_t)i * R + q];
    canb[q] = sat[(size_t)i * R + q] == 0;     // refined after pass 0
    slope[q] = T(0);
  }
  T lo = lvl_in, hi = T(0), hi0 = T(0);

  const int passes = steps + 3;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    // the level this pass evaluates the usage at (pass 0 sums slopes)
    const T pt = p == 1 ? hi0 : (last ? tmax(hi, lvl_in) : T(0.5) * (lo + hi));
    T acc[R], acc2[R];
#pragma unroll
    for (int q = 0; q < R; ++q) { acc[q] = T(0); acc2[q] = T(0); }
    T fmx = T(0);

#pragma unroll 2
    for (int j = tid; j < bmax; j += NT) {
      const T fj = f[j];
      const T rj = rt[j];
      const T* dj = d + (size_t)j * R;
      if (p == 0) {
        if (rj > T(0)) fmx = tmax(fmx, fj);
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] += rj * dj[q];
      } else {
        const T t = rj * tmax(pt - fj, T(0));
#pragma unroll
        for (int q = 0; q < R; ++q) acc[q] += t * dj[q];
        if (last) {
          const T t2 = fj <= pt ? rj : T(0);
#pragma unroll
          for (int q = 0; q < R; ++q) acc2[q] += t2 * dj[q];
        }
      }
    }

    const int buf = p & 1;
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = warp_sum(acc[q]);
    if (last) {
#pragma unroll
      for (int q = 0; q < R; ++q) acc2[q] = warp_sum(acc2[q]);
    }
    if (p == 0) fmx = warp_max(fmx);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        s_part[buf][warp][q] = acc[q];
        s_part[buf][warp][R + q] = acc2[q];
      }
      s_part[buf][warp][2 * R] = fmx;
    }
    __syncthreads();

    // every thread reduces the same partials in the same order
    T tot[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      tot[q] = T(0);
      for (int w = 0; w < NWARP; ++w) tot[q] += s_part[buf][w][q];
    }
    if (p == 0) {                         // slope pass: total slope, base
      T fm = T(0);
      for (int w = 0; w < NWARP; ++w) fm = tmax(fm, s_part[buf][w][2 * R]);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        slope[q] = tot[q];
        canb[q] = canb[q] && slope[q] > TOL;
      }
      hi0 = tmax(fm, lvl_in);
    } else if (p == 1) {                  // bracket pass: tightest step
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
    } else if (!last) {                   // bisection pass at mid = pt
      bool crossed = false;
#pragma unroll
      for (int q = 0; q < R; ++q)
        crossed = crossed || (canb[q] && frz[q] + tot[q] >= cap[q]);
      lo = crossed ? lo : pt;
      hi = crossed ? pt : hi;
    } else if (tid == 0) {                // output pass at the event level
      lvl_out[i] = pt;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        T t2 = T(0);
        for (int w = 0; w < NWARP; ++w) t2 += s_part[buf][w][R + q];
        u_out[(size_t)i * R + q] = frz[q] + tot[q];
        lsl_out[(size_t)i * R + q] = t2;
        slope_out[(size_t)i * R + q] = slope[q];
      }
    }
  }
}

template <typename T, int R>
int launch(const T* floors, const T* rate, const T* dem, const T* caps,
           const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
           T* u_out, T* lsl_out, T* slope_out, int k, int bmax, int steps,
           int stage, cudaStream_t stream) {
  const size_t smem = stage ? (size_t)bmax * (R + 2) * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fill_bucketed_kernel<T, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fill_bucketed_kernel<T, R><<<k, NT, smem, stream>>>(
      floors, rate, dem, caps, frozen, sat, level, lvl_out, u_out, lsl_out,
      slope_out, bmax, steps, stage);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* floors, const T* rate, const T* dem, const T* caps,
             const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
             T* u_out, T* lsl_out, T* slope_out, int k, int bmax, int r,
             int steps, int stage, void* stream) {
  if (k <= 0 || bmax < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PSDSF_FILL_BUCKETED_CASE(RR)                                         \
  case RR:                                                                   \
    return launch<T, RR>(floors, rate, dem, caps, frozen, sat, level,        \
                         lvl_out, u_out, lsl_out, slope_out, k, bmax, steps, \
                         stage, s);
  switch (r) {
    PSDSF_FILL_BUCKETED_CASE(1)
    PSDSF_FILL_BUCKETED_CASE(2)
    PSDSF_FILL_BUCKETED_CASE(3)
    PSDSF_FILL_BUCKETED_CASE(4)
    PSDSF_FILL_BUCKETED_CASE(5)
    PSDSF_FILL_BUCKETED_CASE(6)
    PSDSF_FILL_BUCKETED_CASE(7)
    PSDSF_FILL_BUCKETED_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PSDSF_FILL_BUCKETED_CASE
}

}  // namespace

extern "C" int psdsf_fill_bucketed_f32(
    const float* floors, const float* rate, const float* dem,
    const float* caps, const float* frozen, const uint8_t* sat,
    const float* level, float* lvl_out, float* u_out, float* lsl_out,
    float* slope_out, int k, int bmax, int r, int steps, int stage,
    void* stream) {
  return dispatch<float>(floors, rate, dem, caps, frozen, sat, level,
                         lvl_out, u_out, lsl_out, slope_out, k, bmax, r,
                         steps, stage, stream);
}

extern "C" int psdsf_fill_bucketed_f64(
    const double* floors, const double* rate, const double* dem,
    const double* caps, const double* frozen, const uint8_t* sat,
    const double* level, double* lvl_out, double* u_out, double* lsl_out,
    double* slope_out, int k, int bmax, int r, int steps, int stage,
    void* stream) {
  return dispatch<double>(floors, rate, dem, caps, frozen, sat, level,
                          lvl_out, u_out, lsl_out, slope_out, k, bmax, r,
                          steps, stage, stream);
}
