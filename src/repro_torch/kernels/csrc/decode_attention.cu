// One-token grouped-query attention over a KV cache, for decode.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// _decode_kernel (entry decode_attention_grouped). For q (B, Hq, D), the
// caches k, v (B, S_max, Hkv, D) and kv_len (B,) int32 on the device:
//     o[b, h] = sum_{j < L_b} softmax_j(scale * q[b, h] . k[b, j, hk]) v[b, j, hk]
// with hk = h / (Hq / Hkv) and L_b = kv_len[b] clamped to [0, S_max], in
// float32 with the output rounded once to q's type (float32 or bfloat16).
// The TPU kernel takes one scalar kv_len; one length per sequence is what
// the model's decode masks (repro/models/attention.py:316-317), and with
// equal lengths it is the TPU kernel's function. L_b = 0 gives zeros.
//
// What bounds it on an H100: reading the valid prefix of the cache once,
// 2 L_b Hkv D elements per sequence, against 4 L_b Hq D operations: about
// one operation per byte in bf16, so device memory (3.35 TB/s) bounds it.
// Reaching that rate takes many blocks and many bytes in flight: a grid of
// one block per (sequence, kv head) gives 64 blocks at 8 slots x 8 kv
// heads, under the 132 SMs, and left the card at a tenth of its rate.
//
// Design (split-KV). The TPU grid walks kv blocks sequentially with the
// running statistics in VMEM scratch. Here each (sequence, kv head)'s rows
// are cut into chunks of `chunk` rows and the grid is (chunks, Hkv, B),
// sized from S_max because L_b stays on the device (no host sync): a block
// whose chunk starts at or past L_b exits at once. The wrapper picks the
// chunk (a power of two of 64 rows or more) for about four blocks per SM:
// 512 blocks of 256 rows at 8 slots x 2,048 rows x 8 kv heads, 512 of 512
// rows for one sequence of 32,768. A block of 4 warps reads
// its chunk in the cache's native (B, S_max, Hkv, D) layout through
// strides, 16 bytes a lane (8 bf16 or 4 float32 columns; 8 bytes for query
// groups of 8 or more, for registers): LPR lanes cover one row, so a warp
// reads 32 / LPR rows a load and keeps U loads of K and of V in flight per
// lane. Each lane keeps the running max, sum and accumulator of its row
// group's rows for the Hq / Hkv query heads that share the kv head (scores
// in log2 units, q prescaled by scale * log2 e, so each weight is one
// exp2). The row groups of a warp merge by shuffles, the warps through
// shared memory, and the block writes one float32 partial (max, sum,
// unnormalised (rep, D) accumulator) to scratch the wrapper allocates.
// A second small kernel merges each (sequence, kv head)'s partials by
// their log-sum-exp and rounds once to q's type. A second kernel, rather
// than the last block of each (sequence, kv head) found with a device
// counter, because it needs no counter zeroed before each launch and no
// fence between the partials' writes and their reads; its grid of
// B x Hkv x (rep D / 32) blocks of 8 warps, each warp a share of the
// chunks, costs about one launch gap. What is left between
// it and its bound: each warp waits for its loads before it computes on
// them, so with ~4 blocks of 4 warps per SM it reads 1.4-2.4 TB/s
// (chip_smoke.py, H100 80GB HBM3 at 700 W); a cp.async or TMA ring in
// shared memory would keep more bytes in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads of a split block
constexpr int NWARP = NT / 32;
constexpr int NT_MERGE = 256;     // threads of a merge block
constexpr int MERGE_COLS = 32;    // output columns of a merge block
constexpr int MAX_D = 128;
constexpr int MAX_REP = 16;
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive elements held as 32-bit words (one float32 or two bf16
// each), loaded as one 16- or 8-byte access where the address allows
__device__ __forceinline__ uint32_t word(const float* p, int w) {
  return __float_as_uint(p[w]);
}
__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p, int w) {
  return (uint32_t)__bfloat16_as_ushort(p[2 * w]) |
         ((uint32_t)__bfloat16_as_ushort(p[2 * w + 1]) << 16);
}

template <typename T, int VEC>
struct Pack {
  static constexpr int WORDS = VEC * (int)sizeof(T) / 4;
  static_assert(WORDS == 4 || WORDS == 2, "16- or 8-byte packs");
  uint32_t w[WORDS];

  // vec: the address is aligned to the pack (one load); else element-wise
  __device__ __forceinline__ void load(const T* p, bool vec) {
    if (vec && WORDS == 4) {
      const uint4 x = *reinterpret_cast<const uint4*>(p);
      w[0] = x.x;
      w[1] = x.y;
      w[WORDS - 2] = x.z;
      w[WORDS - 1] = x.w;
    } else if (vec) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x;
      w[WORDS - 1] = x.y;
    } else {
#pragma unroll
      for (int i = 0; i < WORDS; ++i) w[i] = word(p, i);
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0u;
  }
  // bf16 -> float32 is exact: the 16 bits become the high half
  __device__ __forceinline__ void unpack(float* out) const {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if (sizeof(T) == 4) {
        out[i] = __uint_as_float(w[i]);
      } else {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

struct Shape {
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;
  int s_max, rep, d, chunk, nchunk, lpr;
  float qscale;                   // scale * log2 e
};

// rows of kv head `blockIdx.y` of sequence `blockIdx.z` in chunk
// `blockIdx.x`; REP: a power of two >= rep (registers are sized for it)
template <typename T, int REP, int VEC>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    float* __restrict__ part, Shape sh, int vec) {
  using P = Pack<T, VEC>;
  constexpr int U = REP <= 4 ? 4 : 2;       // row loads in flight per lane
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // [NWARP][rep][d + 2]

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int len = min(max(kv_len[b], 0), sh.s_max);
  const int r0 = c * sh.chunk;
  const int rep = sh.rep, d = sh.d, lpr = sh.lpr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (r0 >= len) return;                     // nothing of this chunk is valid
  const int r1 = min(r0 + sh.chunk, len);
  const int rpw = 32 / lpr;                  // rows a warp reads per load
  const int grp = lane / lpr, col = (lane % lpr) * VEC;
  const bool act = col < d;
  const bool vload = vec != 0;

  float qv[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      qv[r][i] = r < rep && act
          ? to_f(q[b * sh.qsb + (g * rep + r) * sh.qsh + col + i]) * sh.qscale
          : 0.f;
  float m[REP], l[REP], acc[REP][VEC];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + b * sh.ksb + g * sh.ksh + col;
  const T* vb = v + b * sh.vsb + g * sh.vsh + col;
  // warp-uniform loop: row base + u * rpw + grp is this lane's u-th row
  const int step = NWARP * U * rpw;
  for (int base = r0 + warp * U * rpw; base < r1; base += step) {
    P kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * rpw + grp;
      if (j < r1 && act) {
        kr[u].load(kb + (long long)j * sh.kss, vload);
        vr[u].load(vb + (long long)j * sh.vss, vload);
      } else {
        kr[u].zero();
        vr[u].zero();
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float kx[VEC];
        kr[u].unpack(kx);
        float part_dot = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          part_dot = fmaf(qv[r][i], kx[i], part_dot);
        for (int off = lpr >> 1; off > 0; off >>= 1)
          part_dot += __shfl_xor_sync(0xffffffffu, part_dot, off);
        sc[u] = base + u * rpw + grp < r1 ? part_dot : -INFINITY;
      }
      float mx = sc[0];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u]);
      const float m_new = fmaxf(m[r], mx);
      if (m_new == -INFINITY) continue;      // no valid row for this group yet
      const float corr = exp2f(m[r] - m_new);
      float lsum = 0.f, pv[VEC];
#pragma unroll
      for (int i = 0; i < VEC; ++i) pv[i] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u] - m_new);
        float vx[VEC];
        vr[u].unpack(vx);
        lsum += p;
#pragma unroll
        for (int i = 0; i < VEC; ++i) pv[i] = fmaf(p, vx[i], pv[i]);
      }
      l[r] = fmaf(l[r], corr, lsum);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] = fmaf(acc[r][i], corr, pv[i]);
      m[r] = m_new;
    }
  }

  // merge the warp's row groups (lanes lpr, 2 lpr, ... apart)
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) break;
    for (int off = lpr; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], mo);
      const float fa = mm == -INFINITY ? 0.f : exp2f(m[r] - mm);
      const float fb = mm == -INFINITY ? 0.f : exp2f(mo - mm);
      l[r] = l[r] * fa + lo * fb;
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * fa + ao * fb;
      }
      m[r] = mm;
    }
  }
  // then the warps, through shared memory
  float* sw = smem + warp * rep * (d + 2);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sw[r * (d + 2)] = m[r];
      sw[r * (d + 2) + 1] = l[r];
    }
    if (grp == 0 && act)
#pragma unroll
      for (int i = 0; i < VEC; ++i) sw[r * (d + 2) + 2 + col + i] = acc[r][i];
  }
  __syncthreads();
  const long long bg = (long long)b * gridDim.y + g;
  for (int idx = tid; idx < rep * d; idx += NT) {
    const int r = idx / d, cc = idx - r * d;
    float mm = -INFINITY;
    for (int w = 0; w < NWARP; ++w)
      mm = fmaxf(mm, smem[(w * rep + r) * (d + 2)]);
    float num = 0.f, den = 0.f;              // row r0 < len: mm is finite
    for (int w = 0; w < NWARP; ++w) {
      const float* sr = smem + (w * rep + r) * (d + 2);
      const float f = exp2f(sr[0] - mm);     // an empty warp gives 0
      num = fmaf(f, sr[2 + cc], num);
      den = fmaf(f, sr[1], den);
    }
    // partial (bg, c, r): [max, sum, accumulator (d)]
    float* pr = part + ((bg * sh.nchunk + c) * rep + r) * (d + 2);
    if (cc == 0) {
      pr[0] = mm;
      pr[1] = den;
    }
    pr[2 + cc] = num;
  }
}

// merges the partials of kv head `blockIdx.x` of sequence `blockIdx.y` for
// MERGE_COLS output columns (block `blockIdx.z` of them): the warps take
// the chunks in turn, each lane keeps a running (max, sum, accumulator) of
// its column over its warp's chunks, and the warps' states are merged
// through shared memory; many small blocks keep many loads in flight
template <typename T>
__global__ void __launch_bounds__(NT_MERGE) decode_merge_kernel(
    const int* __restrict__ kv_len, const float* __restrict__ part,
    T* __restrict__ o, Shape sh) {
  constexpr int NW = NT_MERGE / MERGE_COLS;
  __shared__ float s_st[3][NW][MERGE_COLS];
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lc = tid % MERGE_COLS, w = tid / MERGE_COLS;
  const int len = min(max(kv_len[b], 0), sh.s_max);
  const int nv = (len + sh.chunk - 1) / sh.chunk;   // chunks that wrote
  const int rep = sh.rep, d = sh.d;
  const int idx = blockIdx.z * MERGE_COLS + lc;      // r * d + column
  const bool act = idx < rep * d;
  const int r = idx / d, cc = idx - r * d;
  const long long cs = (long long)rep * (d + 2);     // chunk stride
  const float* pr = part + (long long)(b * gridDim.x + g) * sh.nchunk * cs
                    + r * (d + 2);
  float m = -INFINITY, num = 0.f, den = 0.f;
  if (act) {
#pragma unroll 4
    for (int c = w; c < nv; c += NW) {
      const float mc = pr[c * cs], lcs = pr[c * cs + 1];
      const float ac = pr[c * cs + 2 + cc];
      const float mn = fmaxf(m, mc);               // finite: mc is
      const float fo = exp2f(m - mn), fn = exp2f(mc - mn);
      num = num * fo + ac * fn;
      den = den * fo + lcs * fn;
      m = mn;
    }
  }
  s_st[0][w][lc] = m;
  s_st[1][w][lc] = num;
  s_st[2][w][lc] = den;
  __syncthreads();
  if (w == 0 && act) {
    float mm = -INFINITY;
    for (int i = 0; i < NW; ++i) mm = fmaxf(mm, s_st[0][i][lc]);
    float tn = 0.f, td = 0.f;
    if (nv)                                   // L_b = 0: the output is 0
      for (int i = 0; i < NW; ++i) {
        const float f = exp2f(s_st[0][i][lc] - mm);   // an idle warp: 0
        tn = fmaf(f, s_st[1][i][lc], tn);
        td = fmaf(f, s_st[2][i][lc], td);
      }
    o[b * sh.osb + (g * rep + r) * sh.osh + cc] =
        from_f<T>(nv ? tn / td : 0.f);
  }
}

size_t smem_bytes(int rep, int d) {
  return sizeof(float) * (size_t)(NWARP * rep * (d + 2));
}

template <typename T, int REP, int VEC>
int launch_rep(const T* q, const T* k, const T* v, const int* kv_len, T* o,
               float* part, const Shape& sh, int batch, int hkv, int vec,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(sh.rep, sh.d);
  auto split = decode_split_kernel<T, REP, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(sh.nchunk, hkv, batch), NT, smem, stream>>>(
      q, k, v, kv_len, part, sh, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 mgrid(hkv, batch, (sh.rep * sh.d + MERGE_COLS - 1) / MERGE_COLS);
  decode_merge_kernel<T><<<mgrid, NT_MERGE, 0, stream>>>(kv_len, part, o,
                                                         sh);
  return (int)cudaGetLastError();
}

// VEC: 16 bytes a lane, but 8 for bf16 query groups of 8 or more, whose
// per-lane query and accumulator registers grow with the group
template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kv_len, T* o,
           float* part, const long long* st, int batch, int s_max, int hq,
           int hkv, int d, float scale, int chunk, void* stream) {
  if (batch <= 0 || s_max <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      hq / hkv > MAX_REP || d <= 0 || d % 8 || d > MAX_D || batch > 65535 ||
      hkv > 65535 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int rep = hq / hkv;
  Shape sh;
  sh.qsb = st[0]; sh.qsh = st[1]; sh.ksb = st[2]; sh.kss = st[3];
  sh.ksh = st[4]; sh.vsb = st[5]; sh.vss = st[6]; sh.vsh = st[7];
  sh.osb = st[8]; sh.osh = st[9];
  sh.s_max = s_max; sh.rep = rep; sh.d = d; sh.chunk = chunk;
  sh.nchunk = (s_max + chunk - 1) / chunk;
  sh.qscale = scale * LOG2E;
  const bool wide = sizeof(T) == 2 && rep > 4;
  const int vec_el = sizeof(T) == 4 ? 4 : (wide ? 4 : 8);
  int lpr = 1;                               // lanes per row: a power of 2
  while (lpr * vec_el < d) lpr <<= 1;
  sh.lpr = lpr;
  // pack loads need every row start aligned to the pack
  const unsigned long long align = (unsigned long long)vec_el * sizeof(T);
  const int vec = reinterpret_cast<unsigned long long>(k) % align == 0 &&
                  reinterpret_cast<unsigned long long>(v) % align == 0 &&
                  st[2] % vec_el == 0 && st[3] % vec_el == 0 &&
                  st[4] % vec_el == 0 && st[5] % vec_el == 0 &&
                  st[6] % vec_el == 0 && st[7] % vec_el == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int V16 = 16 / sizeof(T);
#define DECODE_CASE(RR, VV)                                                  \
  return launch_rep<T, RR, VV>(q, k, v, kv_len, o, part, sh, batch, hkv,    \
                               vec, s)
  if (rep <= 1) DECODE_CASE(1, V16);
  if (rep <= 2) DECODE_CASE(2, V16);
  if (rep <= 4) DECODE_CASE(4, V16);
  if (rep <= 8) DECODE_CASE(8, 4);
  DECODE_CASE(16, 4);
#undef DECODE_CASE
}

}  // namespace

// strides: 10 values in elements: q (batch, head); k (batch, seq, head);
// v (batch, seq, head); o (batch, head). Head dims have stride 1. part:
// float32 scratch of B * Hkv * ceil(S_max / chunk) * (Hq / Hkv) * (D + 2)
// values.
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* o, float* part,
                                    const long long* strides, int batch,
                                    int s_max, int hq, int hkv, int d,
                                    float scale, int chunk, void* stream) {
  return launch<float>(q, k, v, kv_len, o, part, strides, batch, s_max, hq,
                       hkv, d, scale, chunk, stream);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q,
                                     const __nv_bfloat16* k,
                                     const __nv_bfloat16* v,
                                     const int* kv_len, __nv_bfloat16* o,
                                     float* part, const long long* strides,
                                     int batch, int s_max, int hq, int hkv,
                                     int d, float scale, int chunk,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, o, part, strides, batch,
                               s_max, hq, hkv, d, scale, chunk, stream);
}
