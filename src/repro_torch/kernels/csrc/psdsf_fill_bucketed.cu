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
// BIG = 3e38, TOL = 1e-9, the slope pass, the bracket pass at
// hi0 = max(max active floor, level_in), then exactly `steps` bisection
// decisions at mid = 0.5*(lo + hi), then the output at max(hi, level_in),
// with no segment root; a collapsed bracket (hi = lo) when no resource of
// the server can bind.
//
// What bounds it on an H100: per event the function must read floors, rate
// and the demand rows once, K*Bmax*(R+2) values, and do
// (steps+3)*K*Bmax*(2R+3) operations. At the 20,000 x 256 pin in float64
// (Bmax 692, R 4, 48 steps) that is 8.5 MB against 99 MFLOP: bound by
// operations, about 3 us; at 20,000 x 1,024 in float32 (26 steps) bound by
// bytes, about 5 us. What holds it back is the passes: each bisection
// decision needs the whole bucket's sums, so every pass ends in a block
// reduction and a barrier, and its instructions (the reduction's as much as
// the arithmetic's) are issued once per warp.
//
// Design. One block of NT threads owns one server: 128 in float64, 64 in
// float32 (fewer warps a server issue fewer reductions; these two were the
// fastest at the two main-path shapes). Slot j belongs to thread j mod NT,
// and each thread sums its slots in ascending order.
// - Slots live in registers for the whole event (`S` slots a thread, a
//   template parameter, at most REG_WORDS_MAX registers of them): each
//   thread loads its floors, rates and demand rows once, with coalesced
//   loads, and every pass reads registers. A wider bucket is staged once in
//   dynamic shared memory, demands as [R][Bmax] so that neighbouring threads
//   read neighbouring words (S = 0, `stage` = 1); one too wide for shared
//   memory is read from device memory (L2) in every pass (S = 0,
//   `stage` = 0). The three paths share the slot-to-thread map and the
//   reduction, so their outputs are bit-identical.
// - One bisection decision a pass, 3 + steps passes an event. Evaluating
//   the 2^m - 1 midpoints of m levels a pass (and walking the tree with
//   the decisions) is exact too, but on an H100 the extra points cost more
//   than the passes they save at both main-path shapes (PERF.md has the
//   readings).
// - One barrier a pass. Each warp reduce-scatters its R sums by shuffles
//   (recursive halving: a lane ends with one resource's warp sum, fewer
//   shuffles than R trees of 5), writes them to shared memory
//   (double-buffered by pass parity), and after the barrier every warp sums
//   the warps' partials in warp order and votes on the crossing, so every
//   thread takes the same decision: no thread publishes anything else.
// Ragged K and Bmax are masked, never padded. R (1..8) is a template
// parameter, so every per-resource array lives in registers.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// threads per block (one server): 128 in float64, 64 in float32, so that
// a thread holds about the same bytes of slots in either type
template <typename T> constexpr int NT = sizeof(T) == 8 ? 128 : 64;
template <typename T> constexpr int NWARP = NT<T> / 32;
// slot values (32-bit registers) a thread may hold on the register path
constexpr int REG_WORDS_MAX = 96;
constexpr unsigned FULL = 0xffffffffu;
// dynamic shared memory the staged path may take (the H100's 227 KB per
// block less the static partials); the wrapper's SMEM_STAGE_MAX matches
constexpr int SMEM_DYN_MAX = 220 * 1024;

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 3.0e38f; }
template <> __device__ __forceinline__ double big<double>() { return 3.0e38; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return a < b ? a : b; }

// a*b + c rounded once, the same in every path
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

__host__ __device__ constexpr int log2ceil(int v) {
  return v <= 1 ? 0 : 1 + log2ceil((v + 1) / 2);
}

// v[idx] for a runtime idx, without indexing a register array
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int idx) {
  T out = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) out = idx == c ? v[c] : out;
  return out;
}

// Sums V values over the block. Each warp reduce-scatters its lanes'
// values: lane l ends with the warp's sum of value l >> (5 - log2 VP)
// (VP = V rounded up to a power of two), lanes 32/VP apart holding the
// same; the first lane of each group writes it to `part`, and after the
// barrier every lane sums the warps' partials of its value in warp order.
// Returns that total (0 for a lane whose value index is >= V).
template <typename T, int V, int NW>
__device__ __forceinline__ T block_sum(T (&v)[V], T (*part)[32], int lane,
                                       int warp) {
  constexpr int LV = log2ceil(V);
  constexpr int VP = 1 << LV;
  T w[VP];
#pragma unroll
  for (int c = 0; c < VP; ++c) w[c] = c < V ? v[c] : T(0);
#pragma unroll
  for (int st = 0; st < LV; ++st) {       // recursive halving
    const int o = 16 >> st;
    const bool up = (lane & o) != 0;
    const int h = VP >> (st + 1);
#pragma unroll
    for (int c = 0; c < VP / 2; ++c) {
      if (c < h) {
        const T send = up ? w[c] : w[c + h];
        const T keep = up ? w[c + h] : w[c];
        w[c] = keep + __shfl_xor_sync(FULL, send, o);
      }
    }
  }
#pragma unroll
  for (int o = 16 >> LV; o > 0; o >>= 1)
    w[0] += __shfl_xor_sync(FULL, w[0], o);
  const int idx = lane >> (5 - LV);
  if ((lane & ((32 >> LV) - 1)) == 0 && idx < V) part[warp][idx] = w[0];
  __syncthreads();
  T tot = T(0);
  if (idx < V) {
#pragma unroll
    for (int q = 0; q < NW; ++q) tot += part[q][idx];
  }
  return tot;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

template <typename T, int R, int S>
__global__ void __launch_bounds__(NT<T>) fill_bucketed_kernel(
    const T* __restrict__ floors, const T* __restrict__ rate,
    const T* __restrict__ dem, const T* __restrict__ caps,
    const T* __restrict__ frozen, const uint8_t* __restrict__ sat,
    const T* __restrict__ level, T* __restrict__ lvl_out,
    T* __restrict__ u_out, T* __restrict__ lsl_out, T* __restrict__ slope_out,
    int bmax, int steps, int stage) {
  constexpr int SR = S > 0 ? S : 1;
  constexpr int NTH = NT<T>, NW = NWARP<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T s_part[2][NW][32];         // per pass parity, warp, value
  __shared__ T s_fmax[NW];

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)i * bmax;
  const T* f = floors + row;
  const T* rt = rate + row;
  const T* d = dem + row * R;

  // the slots: in registers (S > 0), staged as [R][Bmax] (stage), or read
  // from device memory in every pass
  T fr[SR], rr[SR], dr[SR][R];
  const T* sd = nullptr;
  const T* sf = nullptr;
  const T* sr = nullptr;
  if constexpr (S > 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int j = tid + s * NTH;
      const bool ok = j < bmax;
      fr[s] = ok ? f[j] : T(0);
      rr[s] = ok ? rt[j] : T(0);
#pragma unroll
      for (int q = 0; q < R; ++q) dr[s][q] = ok ? d[(size_t)j * R + q] : T(0);
    }
  } else if (stage) {
    T* wd = reinterpret_cast<T*>(smem_raw);
    T* wf = wd + (size_t)bmax * R;
    T* wr = wf + bmax;
    for (int e = tid; e < bmax * R; e += NTH) {
      const int j = e / R, q = e - j * R;
      wd[(size_t)q * bmax + j] = d[e];
    }
    for (int j = tid; j < bmax; j += NTH) {
      wf[j] = f[j];
      wr[j] = rt[j];
    }
    __syncthreads();
    sd = wd;
    sf = wf;
    sr = wr;
  }
  // calls body(f_j, rate_j, d_j[R]) for this thread's slots in order
  auto each_slot = [&](auto&& body) {
    if constexpr (S > 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (tid + s * NTH < bmax) body(fr[s], rr[s], dr[s]);
    } else if (sd != nullptr) {
#pragma unroll 2
      for (int j = tid; j < bmax; j += NTH) {
        T dj[R];
#pragma unroll
        for (int q = 0; q < R; ++q) dj[q] = sd[(size_t)q * bmax + j];
        body(sf[j], sr[j], dj);
      }
    } else {
#pragma unroll 2
      for (int j = tid; j < bmax; j += NTH) {
        T dj[R];
#pragma unroll
        for (int q = 0; q < R; ++q) dj[q] = d[(size_t)j * R + q];
        body(f[j], rt[j], dj);
      }
    }
  };

  const T TOL = T(1e-9);
  const T lvl_in = level[i];
  T cap[R], frz[R], slope[R];
  bool canb[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    cap[q] = caps[(size_t)i * R + q];
    frz[q] = frozen[(size_t)i * R + q];
    canb[q] = sat[(size_t)i * R + q] == 0;   // refined after the slope pass
  }
  int buf = 0;

  // slope pass: total slope per resource and the largest active floor
  T hi0;
  {
    T acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = T(0);
    T fmx = T(0);
    each_slot([&](T fj, T rj, const T (&dj)[R]) {
      if (rj > T(0)) fmx = tmax(fmx, fj);
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = fmadd(rj, dj[q], acc[q]);
    });
    fmx = warp_max(fmx);
    if (lane == 0) s_fmax[warp] = fmx;
    const T tot = block_sum<T, R, NW>(acc, s_part[buf], lane, warp);
    T fm = T(0);
#pragma unroll
    for (int q = 0; q < NW; ++q) fm = tmax(fm, s_fmax[q]);
    constexpr int SH = 5 - log2ceil(R);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      slope[q] = __shfl_sync(FULL, tot, q << SH);
      canb[q] = canb[q] && slope[q] > TOL;
    }
    hi0 = tmax(fm, lvl_in);
    buf ^= 1;
  }

  // bracket pass: the tightest step from hi0 to a capacity
  T lo = lvl_in, hi;
  {
    T acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) acc[q] = T(0);
    each_slot([&](T fj, T rj, const T (&dj)[R]) {
      const T t = rj * tmax(hi0 - fj, T(0));
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = fmadd(t, dj[q], acc[q]);
    });
    const T tot = block_sum<T, R, NW>(acc, s_part[buf], lane, warp);
    const int q = lane >> (5 - log2ceil(R));
    T s = big<T>();
    if (q < R && pick(canb, q)) {
      const T head = tmax(pick(cap, q) - pick(frz, q) - tot, T(0));
      s = head / tmax(pick(slope, q), TOL);
    }
    const T step_up = warp_min(s);
    bool has = false;
#pragma unroll
    for (int c = 0; c < R; ++c) has = has || canb[c];
    // no resource can bind: collapse the bracket, the event is a no-op
    hi = has ? hi0 + step_up : lo;
    buf ^= 1;
  }

  // bisection passes, one decision each; lane l holds resource
  // l >> (5 - log2 R)
  {
    const int q = lane >> (5 - log2ceil(R));
    const bool lane_canb = q < R && pick(canb, q);
    const T lane_cap = pick(cap, q), lane_frz = pick(frz, q);
    for (int st = 0; st < steps; ++st) {
      const T mid = T(0.5) * (lo + hi);
      T acc[R];
#pragma unroll
      for (int c = 0; c < R; ++c) acc[c] = T(0);
      each_slot([&](T fj, T rj, const T (&dj)[R]) {
        const T t = rj * tmax(mid - fj, T(0));
#pragma unroll
        for (int c = 0; c < R; ++c) acc[c] = fmadd(t, dj[c], acc[c]);
      });
      const T tot = block_sum<T, R, NW>(acc, s_part[buf], lane, warp);
      buf ^= 1;
      const bool crossed =
          __any_sync(FULL, lane_canb && lane_frz + tot >= lane_cap);
      lo = crossed ? lo : mid;
      hi = crossed ? mid : hi;
    }
  }

  // output pass at the event level: usage and local slope
  {
    const T lvl = tmax(hi, lvl_in);
    T acc[2 * R];
#pragma unroll
    for (int c = 0; c < 2 * R; ++c) acc[c] = T(0);
    each_slot([&](T fj, T rj, const T (&dj)[R]) {
      const T t = rj * tmax(lvl - fj, T(0));
      const T t2 = fj <= lvl ? rj : T(0);
#pragma unroll
      for (int c = 0; c < R; ++c) {
        acc[c] = fmadd(t, dj[c], acc[c]);
        acc[R + c] = fmadd(t2, dj[c], acc[R + c]);
      }
    });
    const T tot = block_sum<T, 2 * R, NW>(acc, s_part[buf], lane, warp);
    constexpr int SHO = 5 - log2ceil(2 * R);
    const int idx = lane >> SHO;
    if (warp == 0 && (lane & ((1 << SHO) - 1)) == 0 && idx < 2 * R) {
      if (idx < R)
        u_out[(size_t)i * R + idx] = pick(frz, idx) + tot;
      else
        lsl_out[(size_t)i * R + idx - R] = tot;
    }
    if (tid < R) slope_out[(size_t)i * R + tid] = pick(slope, tid);
    if (tid == 0) lvl_out[i] = lvl;
  }
}

template <typename T, int R, int S>
int launch(const T* floors, const T* rate, const T* dem, const T* caps,
           const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
           T* u_out, T* lsl_out, T* slope_out, int k, int bmax, int steps,
           int stage, cudaStream_t stream) {
  size_t smem = 0;
  if constexpr (S == 0) {
    smem = stage ? (size_t)bmax * (R + 2) * sizeof(T) : 0;
    if (smem > (size_t)SMEM_DYN_MAX) return (int)cudaErrorInvalidValue;
    // the shared-memory limit is raised once per device for each instance
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
      return (int)cudaErrorInvalidDevice;
    static bool raised[64] = {};
    if (smem > 48 * 1024 && !raised[dev]) {
      const cudaError_t e = cudaFuncSetAttribute(
          fill_bucketed_kernel<T, R, S>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN_MAX);
      if (e != cudaSuccess) return (int)e;
      raised[dev] = true;
    }
  } else {
    if (bmax > S * NT<T>) return (int)cudaErrorInvalidValue;
  }
  fill_bucketed_kernel<T, R, S><<<k, NT<T>, smem, stream>>>(
      floors, rate, dem, caps, frozen, sat, level, lvl_out, u_out, lsl_out,
      slope_out, bmax, steps, stage);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_r(const T* floors, const T* rate, const T* dem, const T* caps,
             const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
             T* u_out, T* lsl_out, T* slope_out, int k, int bmax, int steps,
             int slots, int stage, cudaStream_t s) {
  // the register path's slot counts, each within REG_WORDS_MAX
  switch (slots) {
#define PSDSF_FILL_BUCKETED_SLOTS(SS)                                         \
  case SS:                                                                    \
    if constexpr (SS * (R + 2) * (int)sizeof(T) / 4 > REG_WORDS_MAX) {        \
      return (int)cudaErrorInvalidValue;                                      \
    } else {                                                                  \
      return launch<T, R, SS>(floors, rate, dem, caps, frozen, sat, level,    \
                              lvl_out, u_out, lsl_out, slope_out, k, bmax,    \
                              steps, stage, s);                               \
    }
    PSDSF_FILL_BUCKETED_SLOTS(0)
    PSDSF_FILL_BUCKETED_SLOTS(1)
    PSDSF_FILL_BUCKETED_SLOTS(2)
    PSDSF_FILL_BUCKETED_SLOTS(4)
    PSDSF_FILL_BUCKETED_SLOTS(6)
    PSDSF_FILL_BUCKETED_SLOTS(8)
    PSDSF_FILL_BUCKETED_SLOTS(12)
    PSDSF_FILL_BUCKETED_SLOTS(16)
#undef PSDSF_FILL_BUCKETED_SLOTS
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(const T* floors, const T* rate, const T* dem, const T* caps,
             const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
             T* u_out, T* lsl_out, T* slope_out, int k, int bmax, int r,
             int steps, int slots, int stage, void* stream) {
  if (k <= 0 || bmax < 0 || steps < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PSDSF_FILL_BUCKETED_CASE(RR)                                         \
  case RR:                                                                   \
    return launch_r<T, RR>(floors, rate, dem, caps, frozen, sat, level,      \
                           lvl_out, u_out, lsl_out, slope_out, k, bmax,      \
                           steps, slots, stage, s);
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
    float* slope_out, int k, int bmax, int r, int steps, int slots,
    int stage, void* stream) {
  return dispatch<float>(floors, rate, dem, caps, frozen, sat, level,
                         lvl_out, u_out, lsl_out, slope_out, k, bmax, r,
                         steps, slots, stage, stream);
}

extern "C" int psdsf_fill_bucketed_f64(
    const double* floors, const double* rate, const double* dem,
    const double* caps, const double* frozen, const uint8_t* sat,
    const double* level, double* lvl_out, double* u_out, double* lsl_out,
    double* slope_out, int k, int bmax, int r, int steps, int slots,
    int stage, void* stream) {
  return dispatch<double>(floors, rate, dem, caps, frozen, sat, level,
                          lvl_out, u_out, lsl_out, slope_out, k, bmax, r,
                          steps, slots, stage, stream);
}
