// One saturation event of the PS-DSF bisection fill for every server.
//
// Replaces the TPU kernel repro/kernels/psdsf_fill/kernel.py::_fill_kernel
// (entry fill_event_levels). For every server i it finds the first level L
// at which some non-saturated resource r of i reaches its capacity, where
// the usage is the monotone piecewise-linear
//     U_{i,r}(L) = frozen[i,r] + sum_n d[n,r] rate[n,i] max(0, L - f[n,i]),
// by a fixed number of bisection steps, and returns the level, the usage
// and the local slope there, and the total slope. Semantics kept exactly:
// BIG = 3e38, TOL = 1e-9, the slope pass, the bracket pass, `steps`
// bisection passes at the midpoints 0.5 (lo + hi), the output pass,
// level = max(hi, level_in) with no segment root, and a collapsed bracket
// (hi = lo) when no resource of the server can bind.
//
// What bounds it on an H100: the function must read floors and rate (2 N K
// values) and demands (N R) once; its operations are (steps + 3) passes
// over the users that can move a server's usage, those with rate > 0 (an
// entry of rate 0 adds exactly 0 to every sum), (2R + 3) each. On the
// main path's data (3% eligibility) the bytes bound it. Its first design
// ran every pass over all N x K entries from device memory or L2, in tiles
// of 8 servers: 32 blocks at K = 256, and 4.2 GB moved per float64 event.
//
// Design. On the TPU the (phase, user tile) grid axes run in order and
// carry the bracket in VMEM scratch. Here a tile of TK servers (one
// 32-byte sector of a row: 4 float64 or 8 float32) goes to one thread-block
// cluster of CL blocks (1 to 8), and the cluster's blocks split the tile's
// users into CL slices: grid (CL, ceil(K / TK)), 256 blocks at K = 256 in
// float64 (CL 4) and at K = 1,024 in float32 (CL 2). threadIdx % TK walks
// the tile's servers, so the row-major (N, K) loads read whole sectors;
// the other 256 / TK thread lanes walk users. Each block reads its slice
// from device memory once per event, in the slope pass, and keeps in
// shared memory the rows that have a nonzero rate on some server of the
// tile (floors, rates and the user's demands), compacted in row order,
// deterministically, through a block prefix sum of per-warp ballots. All
// later passes run over that copy. A slice whose kept rows exceed the
// block's shared memory keeps the rows that fit and streams the rest of
// the slice from device memory in every pass, so any N is correct; the
// wrapper gives a block the whole slice's room when that fits, else 56 KB
// (three blocks per SM), which holds the main paths' kept rows. Each pass,
// each block reduces over its rows (warp shuffles, then shared memory) and
// stores its per-server partial sums into every block of the cluster
// through distributed shared memory (stores, which do not wait, rather than
// remote loads, which do); after one cluster barrier every block sums the
// CL partials from its own shared memory in rank order and takes the same
// bisection decision, so no second barrier is needed to hand it out (the
// partials are double-buffered by pass parity). The cluster is the
// smallest that keeps one block per SM, since each pass's reductions and
// barriers, not the event's bytes, set its time (a float64 event takes
// about 8x its bytes bound). Rank 0 writes the outputs. Ragged N and K are
// masked, never padded. R is a template parameter (1..8) so every
// per-resource sum lives in registers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per block
constexpr int NWARP = NT / 32;
constexpr int U = 4;              // slice rows per thread per load step
constexpr int MAX_CLUSTER = 8;
constexpr int MAX_SMEM = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T big();
template <> __device__ __forceinline__ float big<float>() { return 3.0e38f; }
template <> __device__ __forceinline__ double big<double>() { return 3.0e38; }

template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a > b ? a : b; }

// servers per tile: one 32-byte sector of a row
template <typename T>
__host__ __device__ constexpr int tile_servers() { return 32 / (int)sizeof(T); }

// sum (max) over the lanes of a warp that hold the same server (lane % TK)
template <typename T, int TK>
__device__ __forceinline__ T lane_sum(T v) {
#pragma unroll
  for (int off = TK; off < 32; off <<= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
template <typename T, int TK>
__device__ __forceinline__ T lane_max(T v) {
#pragma unroll
  for (int off = TK; off < 32; off <<= 1)
    v = tmax(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// one (user, server) entry's contribution at evaluation level pt
template <typename T, int R>
__device__ __forceinline__ void accumulate(T f, T rt, const T* d, T pt,
                                           bool last, T* acc, T* acc2) {
  const T t = rt * tmax(pt - f, T(0));
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] += t * d[q];
  if (last) {
    const T t2 = f <= pt ? rt : T(0);
#pragma unroll
    for (int q = 0; q < R; ++q) acc2[q] += t2 * d[q];
  }
}

template <typename T, int R>
struct Smem {
  static constexpr int TK = tile_servers<T>();
  static constexpr int NV = 2 * R + 1;      // sums, last-pass sums, max
  T red[NWARP][TK][NV];                     // per-warp partials
  T part[2][MAX_CLUSTER][TK][NV];           // every rank's, pushed to all
  T own[TK][3 * R];                         // slope, caps, frozen
  T pt[TK];                                 // next evaluation level
  bool canb[TK][R];
  int wcnt[2][NWARP];                       // kept rows per warp and step
};

// dynamic shared memory: `cap` kept rows of TK floors, TK rates, R demands
template <typename T, int R>
__global__ void __launch_bounds__(NT, R <= 4 ? 4 : 2) fill_event_kernel(
    const T* __restrict__ floors, const T* __restrict__ rate,
    const T* __restrict__ dem, const T* __restrict__ caps,
    const T* __restrict__ frozen, const uint8_t* __restrict__ sat,
    const T* __restrict__ level, T* __restrict__ lvl_out,
    T* __restrict__ u_out, T* __restrict__ lsl_out, T* __restrict__ slope_out,
    int n, int k, int steps, int slice, int cap) {
  constexpr int TK = tile_servers<T>();
  constexpr int WN = NT / TK;               // user lanes
  constexpr int NV = 2 * R + 1;
  __shared__ Smem<T, R> sm;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* s_f = reinterpret_cast<T*>(dyn);
  T* s_rt = s_f + (size_t)cap * TK;
  T* s_d = s_rt + (size_t)cap * TK;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ncl = (int)cluster.num_blocks();
  const T TOL = T(1e-9);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % TK, ty = tid / TK;
  const int col = blockIdx.y * TK + tx;
  const bool live = col < k;
  const bool owner = tid < TK && live;      // takes this server's decisions
  const int r0 = min(n, rank * slice), r1 = min(n, r0 + slice);

  T lo = T(0), hi = T(0), hi0 = T(0), lvl_in = T(0);
  if (tid < TK) sm.pt[tid] = T(0);
  if (owner) {
    lvl_in = level[col];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      sm.own[tx][R + q] = caps[(size_t)col * R + q];
      sm.own[tx][2 * R + q] = frozen[(size_t)col * R + q];
      sm.canb[tx][q] = sat[(size_t)col * R + q] == 0;   // refined in pass 0
    }
  }

  // load step and slope pass: read the slice once, keep its rows with a
  // nonzero rate in shared memory, sum rate * d and the largest floor
  T acc[R], acc2[R];
#pragma unroll
  for (int q = 0; q < R; ++q) acc[q] = acc2[q] = T(0);
  T fmx = T(0);
  int kept = 0;                 // rows stored (block-uniform)
  int stream_from = r1;         // rows from here on are read every pass
  bool storing = true;
  for (int s0 = r0, it = 0; s0 < r1; s0 += U * WN, ++it) {
    T f[U], rt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = s0 + u * WN + ty;
      const bool in = row < r1 && live;
      f[u] = in ? floors[(size_t)row * k + col] : T(0);
      rt[u] = in ? rate[(size_t)row * k + col] : T(0);
    }
    // a row is kept when some server of the tile has a nonzero rate;
    // kmask: one bit per kept row of the warp, at its first lane
    bool keep[U];
    unsigned kmask[U];
    int wc = 0;
    const int first = lane & ~(TK - 1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const unsigned bal = __ballot_sync(FULL, rt[u] > T(0));
      keep[u] = ((bal >> first) & ((1u << TK) - 1u)) != 0u;
      kmask[u] = __ballot_sync(FULL, keep[u] && tx == 0);
      wc += __popc(kmask[u]);
    }
    int pos = 0;
    bool store = false;
    if (storing) {                          // block-uniform
      if (lane == 0) sm.wcnt[it & 1][warp] = wc;
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < NWARP; ++w) {
        const int c = sm.wcnt[it & 1][w];
        total += c;
        before += w < warp ? c : 0;
      }
      if (kept + total <= cap) {
        pos = kept + before;
        kept += total;
        store = true;
      } else {
        storing = false;
        stream_from = s0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int at = pos + __popc(kmask[u] & ((1u << first) - 1u));
      pos += __popc(kmask[u]);
      if (!keep[u]) continue;
      const int row = s0 + u * WN + ty;
      T d[R];
#pragma unroll
      for (int q = 0; q < R; ++q) d[q] = dem[(size_t)row * R + q];
      if (rt[u] > T(0)) fmx = tmax(fmx, f[u]);
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] += rt[u] * d[q];
      if (store) {
        s_f[(size_t)at * TK + tx] = f[u];
        s_rt[(size_t)at * TK + tx] = rt[u];
        if (tx == 0)
#pragma unroll
          for (int q = 0; q < R; ++q) s_d[(size_t)at * R + q] = d[q];
      }
    }
  }

  const int passes = steps + 3;
  for (int p = 0; p < passes; ++p) {
    const bool last = p == passes - 1;
    if (p > 0) {
      const T pt = sm.pt[tx];
#pragma unroll
      for (int q = 0; q < R; ++q) acc[q] = acc2[q] = T(0);
      for (int j = ty; j < kept; j += WN)
        accumulate<T, R>(s_f[(size_t)j * TK + tx], s_rt[(size_t)j * TK + tx],
                         s_d + (size_t)j * R, pt, last, acc, acc2);
      if (live) {
#pragma unroll 4
        for (int row = stream_from + ty; row < r1; row += WN) {
          const T f = floors[(size_t)row * k + col];
          const T rt = rate[(size_t)row * k + col];
          if (rt > T(0))
            accumulate<T, R>(f, rt, dem + (size_t)row * R, pt, last, acc,
                             acc2);
        }
      }
    }

    // the block's per-server partials: shuffles, then shared memory
#pragma unroll
    for (int q = 0; q < R; ++q) {
      acc[q] = lane_sum<T, TK>(acc[q]);
      if (last) acc2[q] = lane_sum<T, TK>(acc2[q]);
    }
    if (p == 0) fmx = lane_max<T, TK>(fmx);
    if (lane < TK) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        sm.red[warp][tx][q] = acc[q];
        sm.red[warp][tx][R + q] = acc2[q];
      }
      sm.red[warp][tx][2 * R] = fmx;
    }
    __syncthreads();
    const int buf = p & 1;
    if (tid < TK * NV) {
      // the block's partial, stored into every block of the cluster (remote
      // stores do not wait; the barrier below publishes them)
      const int i = tid / NV, v = tid % NV;
      T s = T(0);
      for (int w = 0; w < NWARP; ++w)
        s = v == 2 * R ? tmax(s, sm.red[w][i][v]) : s + sm.red[w][i][v];
      for (int c = 0; c < ncl; ++c)
        cluster.map_shared_rank(&sm.part[buf][rank][i][v], c)[0] = s;
    }
    cluster.sync();           // every block holds every block's partials

    if (owner) {
      // the cluster's sums, in rank order: the same in every block
      T tot[R], t2[R], fm = T(0);
#pragma unroll
      for (int q = 0; q < R; ++q) tot[q] = t2[q] = T(0);
      for (int c = 0; c < ncl; ++c) {
        const T* pr = sm.part[buf][c][tx];
#pragma unroll
        for (int q = 0; q < R; ++q) {
          tot[q] += pr[q];
          t2[q] += pr[R + q];
        }
        fm = tmax(fm, pr[2 * R]);
      }
      const T pt = p == 0 ? T(0) : sm.pt[tx];
      T* slope = sm.own[tx];
      const T* cp = sm.own[tx] + R;
      const T* frz = sm.own[tx] + 2 * R;
      bool* canb = sm.canb[tx];
      T next = T(0);
      if (p == 0) {                         // slope pass: slope, bracket base
#pragma unroll
        for (int q = 0; q < R; ++q) {
          slope[q] = tot[q];
          canb[q] = canb[q] && slope[q] > TOL;
        }
        hi0 = tmax(fm, lvl_in);
        lo = lvl_in;
        next = hi0;
      } else if (p == 1) {                  // bracket pass: headroom step
        T step_up = big<T>();
        bool has = false;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          if (!canb[q]) continue;
          has = true;
          const T head = tmax(cp[q] - frz[q] - tot[q], T(0));
          const T s = head / tmax(slope[q], TOL);
          step_up = s < step_up ? s : step_up;
        }
        // no resource can bind: collapse the bracket, the event is a no-op
        hi = has ? hi0 + step_up : lo;
        next = steps > 0 ? T(0.5) * (lo + hi) : tmax(hi, lvl_in);
      } else if (!last) {                   // bisection pass at mid = pt
        bool crossed = false;
#pragma unroll
        for (int q = 0; q < R; ++q)
          crossed = crossed || (canb[q] && frz[q] + tot[q] >= cp[q]);
        const T mid = T(0.5) * (lo + hi);
        lo = crossed ? lo : mid;
        hi = crossed ? mid : hi;
        next = p + 1 < passes - 1 ? T(0.5) * (lo + hi) : tmax(hi, lvl_in);
      } else if (rank == 0) {               // output pass at the event level
        lvl_out[col] = pt;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          u_out[(size_t)col * R + q] = frz[q] + tot[q];
          lsl_out[(size_t)col * R + q] = t2[q];
          slope_out[(size_t)col * R + q] = slope[q];
        }
      }
      sm.pt[tx] = next;
    }
    __syncthreads();
  }
  cluster.sync();             // no block leaves while others store to it
}

template <typename T, int R>
int launch(const T* floors, const T* rate, const T* dem, const T* caps,
           const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
           T* u_out, T* lsl_out, T* slope_out, int n, int k, int steps,
           int cluster, int cap, cudaStream_t stream) {
  constexpr int TK = tile_servers<T>();
  const size_t dyn = (size_t)cap * (2 * TK + R) * sizeof(T);
  if (dyn + sizeof(Smem<T, R>) > (size_t)MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  auto kernel = fill_event_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  const int slice = (n + cluster - 1) / cluster;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (k + TK - 1) / TK);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, floors, rate, dem, caps, frozen, sat,
                           level, lvl_out, u_out, lsl_out, slope_out, n, k,
                           steps, slice, cap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const T* floors, const T* rate, const T* dem, const T* caps,
             const T* frozen, const uint8_t* sat, const T* level, T* lvl_out,
             T* u_out, T* lsl_out, T* slope_out, int n, int k, int r,
             int steps, int cluster, int cap, void* stream) {
  constexpr int TK = tile_servers<T>();
  if (n < 0 || k <= 0 || steps < 0 || cap < 0 || cluster < 1 ||
      cluster > MAX_CLUSTER || (cluster & (cluster - 1)) ||
      (k + TK - 1) / TK > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PSDSF_FILL_CASE(RR)                                                  \
  case RR:                                                                   \
    return launch<T, RR>(floors, rate, dem, caps, frozen, sat, level,        \
                         lvl_out, u_out, lsl_out, slope_out, n, k, steps,    \
                         cluster, cap, s);
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

// cluster: blocks per server tile (1, 2, 4 or 8), splitting the users;
// cap: rows each block may keep in shared memory (0: stream every pass)
extern "C" int psdsf_fill_f32(const float* floors, const float* rate,
                              const float* dem, const float* caps,
                              const float* frozen, const uint8_t* sat,
                              const float* level, float* lvl_out,
                              float* u_out, float* lsl_out, float* slope_out,
                              int n, int k, int r, int steps, int cluster,
                              int cap, void* stream) {
  return dispatch<float>(floors, rate, dem, caps, frozen, sat, level,
                         lvl_out, u_out, lsl_out, slope_out, n, k, r, steps,
                         cluster, cap, stream);
}

extern "C" int psdsf_fill_f64(const double* floors, const double* rate,
                              const double* dem, const double* caps,
                              const double* frozen, const uint8_t* sat,
                              const double* level, double* lvl_out,
                              double* u_out, double* lsl_out,
                              double* slope_out, int n, int k, int r,
                              int steps, int cluster, int cap, void* stream) {
  return dispatch<double>(floors, rate, dem, caps, frozen, sat, level,
                          lvl_out, u_out, lsl_out, slope_out, n, k, r, steps,
                          cluster, cap, stream);
}
