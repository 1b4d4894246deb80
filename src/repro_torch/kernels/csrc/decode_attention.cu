// One-token grouped-query attention over a KV cache, for decode.
//
// Replaces the TPU kernel repro/kernels/decode_attention/kernel.py::
// _decode_kernel (entry decode_attention_grouped). For q (B, Hq, D), the
// caches k, v (B, S_max, Hkv, D), kv_len (B,) int32 and optionally kv_start
// (B,) int32 on the device:
//     o[b, h] = sum_{F_b <= j < L_b} softmax_j(scale * q[b, h] . k[b, j, hk]) v[b, j, hk]
// with hk = h / (Hq / Hkv), L_b = kv_len[b] clamped to [0, S_max] and F_b =
// kv_start[b] clamped to [0, L_b] (0 without kv_start), in float32 with the
// output rounded once to q's type (float32 or bfloat16). The TPU kernel
// takes one scalar kv_len; one length per sequence is what the model's
// decode masks (repro/models/attention.py:316-317), and with equal lengths
// it is the TPU kernel's function. A first valid row per sequence is the
// model's sliding window (:88-89, the window measured from the batch's
// largest position, as the reference's decode does). No valid row (F_b =
// L_b) gives zeros.
//
// The caches are in q's type, or both float8 (e4m3 or e5m2) under a
// bfloat16 or float32 q: the reference's quantized KV cache, dequantised
// on read by a plain cast (:78-80). The kernel loads the float8 bytes and
// converts them in registers (cvt to half pairs, then float32), which is
// exact: every e4m3 and e5m2 value is a half, a bfloat16 and a float32
// value. A float8 cache moves half the bytes of a bfloat16 one. A float32
// q over bfloat16 caches (float32 params over bfloat16 activations: the
// projections promote q to float32, the cache is allocated in the compute
// dtype) reads the bf16 rows as stored and widens them in registers, as
// the reference's astype widens them, exactly; it moves the bf16 cache's
// bytes and writes a float32 output.
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
// rows for one sequence of 32,768 (the tensor-core body at head dim 256,
// whose blocks take 143 KB of shared memory, one an SM, about a quarter of
// those blocks: chunks four times as long). Each block writes one float32
// partial (max, sum, unnormalised (rep, D) accumulator) to scratch the
// wrapper allocates. A second small kernel merges each (sequence, kv head)'s
// partials by their log-sum-exp and rounds once to q's type; on request it
// also writes each query head's log-sum-exp (natural log, float32), by
// which a decode over a sequence-sharded cache merges its shards' outputs.
// A second kernel, rather than the last block of each (sequence, kv head)
// found with a device counter, because it needs no counter zeroed before
// each launch and no fence between the partials' writes and their
// reads; its grid of B x Hkv x (rep D / 32) blocks of 8 warps, each warp
// a share of the chunks, costs about one launch gap. A block whose chunk
// ends at or before F_b exits at once, as one past L_b does, and the merge
// takes the chunks from the one holding F_b.
//
// Two split bodies write those partials; the wrapper picks one.
// - Groups of 2-16 under a bfloat16 q, over bfloat16 or float8 caches,
//   head dims 64, 128 and 256, rows 16-byte aligned (the decode of every
//   bf16 config but musicgen_large's groups of 1): the tensor-core body
//   (decode_tc_kernel, entries decode_attention_bf16*_tc). Each of a
//   block's 4 warps takes its own 16-row steps of the chunk (step i of the
//   chunk goes to warp i % 4) and stages them through a ring of its own in
//   shared memory (two stages: a third was no faster at any width timed,
//   and three blocks of 74 KB fit an SM at D 128 where two of 104 KB did)
//   with 16-byte cp.async, rows past the chunk filled with zeros, so each
//   warp keeps its next step of K and V in flight while it computes one. Scores are mma.sync.m16n8k16
//   products (bf16 in, float32 accumulate): the group's query heads are
//   the 16 rows of A (rows rep..15 zero), K the B operand through ldmatrix,
//   and the float32 scores times scale log2 e take the online softmax in
//   log2 units on the accumulator fragments; P, rounded to bf16 as the
//   Hopper flash body rounds it, is the A fragment of O += P V as it lies
//   (two n8 score tiles are one k16 A tile), V the B operand through
//   ldmatrix.trans. Staged rows are padded by 16 bytes so the 8 rows of an
//   ldmatrix hit 8 different bank groups. A float8 cache is staged as its
//   bytes and widened to bf16 in shared memory before the products, exactly
//   (every e4m3 and e5m2 value is a bf16 value). The 4 warps' states merge
//   through shared memory (the ring's bytes) into the same partials. At
//   groups of 1 it was no faster than the CUDA-core body (chip_smoke.py's
//   decode phases, PERF.md).
// - Everything else (groups of 1, a float32 q, other head dims, rows not
//   16-byte aligned): the CUDA-core body (decode_split_kernel). A block of
//   4 warps reads its chunk in the cache's native (B, S_max, Hkv, D) layout
//   through strides, 16 bytes a lane (8 bf16 or 4 float32 columns; 8 bytes
//   for query groups of 8 or more, for registers): LPR lanes cover one row,
//   so a warp reads 32 / LPR rows a load and keeps U loads of K and of V in
//   flight per lane (float8 caches: 16 bytes are 16 columns for groups of
//   1-2, and the columns a lane holds stay bfloat16's, 8 or 4 bytes a load,
//   for larger groups, whose query and accumulator registers grow with the
//   group). A row wider than a warp's packs (head dim 256 in float32, or in
//   bf16 at groups past 4: 64 packs of 4 columns) gives each of the 32
//   lanes NPK = 2 packs of it, 32 packs apart, so every load of the warp
//   stays one contiguous span of the row. Each lane keeps the running max,
//   sum and accumulator of its row group's rows for the Hq / Hkv query
//   heads that share the kv head (scores in log2 units, q prescaled by
//   scale * log2 e, so each weight is one exp2); every score is a float32
//   dot product on the CUDA cores, repeated for each head of the group. The
//   row groups of a warp merge by shuffles, the warps through shared
//   memory. Each warp waits for its loads before it computes on them, so
//   with ~4 blocks of 4 warps per SM it reads 1.4-2.4 TB/s at groups of 1-4
//   (chip_smoke.py, H100 80GB HBM3 at 700 W); a float32 q keeps it, since
//   rounding q or P to bf16 would break the float32 entries' bounds.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads of a split block
constexpr int NWARP = NT / 32;
constexpr int NT_MERGE = 256;     // threads of a merge block
constexpr int MERGE_COLS = 32;    // output columns of a merge block
constexpr int MAX_D = 256;
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

// the float8 storage types' interpretation for the converting cvt
template <typename T>
struct Fp8Kind;
template <>
struct Fp8Kind<__nv_fp8_e4m3> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E4M3;
};
template <>
struct Fp8Kind<__nv_fp8_e5m2> {
  static constexpr __nv_fp8_interpretation_t value = __NV_E5M2;
};

// VEC consecutive elements held as 32-bit words (one float32, two bf16 or
// four float8 each), loaded as one 16-, 8- or 4-byte access where the
// address allows
__device__ __forceinline__ uint32_t word(const float* p, int w) {
  return __float_as_uint(p[w]);
}
__device__ __forceinline__ uint32_t word(const __nv_bfloat16* p, int w) {
  return (uint32_t)__bfloat16_as_ushort(p[2 * w]) |
         ((uint32_t)__bfloat16_as_ushort(p[2 * w + 1]) << 16);
}
template <typename T>
__device__ __forceinline__ uint32_t word(const T* p, int w) {  // float8
  const uint8_t* b = reinterpret_cast<const uint8_t*>(p) + 4 * w;
  return (uint32_t)b[0] | ((uint32_t)b[1] << 8) | ((uint32_t)b[2] << 16) |
         ((uint32_t)b[3] << 24);
}

// two float8 values (the low 16 bits of x, the lower byte first) as
// float32: float8 -> half pair (one cvt) -> float32 pair, both exact
template <typename T>
__device__ __forceinline__ float2 fp8x2_to_float2(uint32_t x) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      (__nv_fp8x2_storage_t)(x & 0xffffu), Fp8Kind<T>::value);
  return __half22float2(__half2(h));
}

template <typename T, int VEC>
struct Pack {
  static constexpr int WORDS = VEC * (int)sizeof(T) / 4;
  static_assert(WORDS == 4 || WORDS == 2 || WORDS == 1,
                "16-, 8- or 4-byte packs");
  uint32_t w[WORDS];

  // vec: the address is aligned to the pack (one load); else element-wise
  __device__ __forceinline__ void load(const T* p, bool vec) {
    if constexpr (WORDS == 4) {
      if (vec) {
        const uint4 x = *reinterpret_cast<const uint4*>(p);
        w[0] = x.x;
        w[1] = x.y;
        w[2] = x.z;
        w[3] = x.w;
        return;
      }
    } else if constexpr (WORDS == 2) {
      if (vec) {
        const uint2 x = *reinterpret_cast<const uint2*>(p);
        w[0] = x.x;
        w[1] = x.y;
        return;
      }
    } else {
      if (vec) {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = word(p, i);
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) w[i] = 0u;
  }
  // bf16 -> float32 is exact: the 16 bits become the high half; float8 ->
  // float32 too (fp8x2_to_float2)
  __device__ __forceinline__ void unpack(float* out) const {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (sizeof(T) == 4) {
        out[i] = __uint_as_float(w[i]);
      } else if constexpr (sizeof(T) == 2) {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        const float2 lo = fp8x2_to_float2<T>(w[i]);
        const float2 hi = fp8x2_to_float2<T>(w[i] >> 16);
        out[4 * i] = lo.x;
        out[4 * i + 1] = lo.y;
        out[4 * i + 2] = hi.x;
        out[4 * i + 3] = hi.y;
      }
    }
  }
};

struct Shape {
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;
  int s_max, rep, d, chunk, nchunk, lpr;
  float qscale;                   // scale * log2 e
};

// the valid rows [first, len) of sequence b: len = kv_len[b] clamped to
// [0, S_max], first = kv_start[b] (0 without it) clamped to [0, len]
__device__ __forceinline__ int2 valid_rows(const int* kv_len,
                                           const int* kv_start, int b,
                                           int s_max) {
  const int len = min(max(kv_len[b], 0), s_max);
  const int first = kv_start == nullptr ? 0 : min(max(kv_start[b], 0), len);
  return make_int2(first, len);
}

// rows of kv head `blockIdx.y` of sequence `blockIdx.z` in chunk
// `blockIdx.x`; TQ: q's type, T: the caches'; REP: a power of two >= rep
// (registers are sized for it); NPK: packs of a row a lane holds (1, or 2
// when lpr = 32 lanes of VEC columns do not cover D)
template <typename TQ, typename T, int REP, int VEC, int NPK>
__global__ void __launch_bounds__(NT) decode_split_kernel(
    const TQ* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ kv_start, float* __restrict__ part, Shape sh,
    int vec) {
  using P = Pack<T, VEC>;
  constexpr int NV = NPK * VEC;             // columns a lane holds
  // row loads in flight per lane: 4 packs of K and of V, 2 for wide groups
  constexpr int U = (REP <= 4 ? 4 : 2) / NPK;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // [NWARP][rep][d + 2]

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int2 rows = valid_rows(kv_len, kv_start, b, sh.s_max);
  const int r0 = max(c * sh.chunk, rows.x);
  const int r1 = min(c * sh.chunk + sh.chunk, rows.y);
  const int rep = sh.rep, d = sh.d, lpr = sh.lpr;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (r0 >= r1) return;                      // nothing of this chunk is valid
  const int rpw = 32 / lpr;                  // rows a warp reads per load
  // pack p of this lane covers columns col + p * pstride .. + VEC - 1
  const int grp = lane / lpr, col = (lane % lpr) * VEC;
  const int pstride = lpr * VEC;
  bool act[NPK];
#pragma unroll
  for (int pk = 0; pk < NPK; ++pk) act[pk] = col + pk * pstride < d;
  const bool vload = vec != 0;

  float qv[REP][NV];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int pk = 0; pk < NPK; ++pk)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        qv[r][pk * VEC + i] =
            r < rep && act[pk]
                ? to_f(q[b * sh.qsb + (g * rep + r) * sh.qsh + col +
                         pk * pstride + i]) * sh.qscale
                : 0.f;
  float m[REP], l[REP], acc[REP][NV];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + b * sh.ksb + g * sh.ksh + col;
  const T* vb = v + b * sh.vsb + g * sh.vsh + col;
  // warp-uniform loop: row base + u * rpw + grp is this lane's u-th row
  const int step = NWARP * U * rpw;
  for (int base = r0 + warp * U * rpw; base < r1; base += step) {
    P kr[U][NPK], vr[U][NPK];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * rpw + grp;
#pragma unroll
      for (int pk = 0; pk < NPK; ++pk) {
        if (j < r1 && act[pk]) {
          kr[u][pk].load(kb + (long long)j * sh.kss + pk * pstride, vload);
          vr[u][pk].load(vb + (long long)j * sh.vss + pk * pstride, vload);
        } else {
          kr[u][pk].zero();
          vr[u][pk].zero();
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part_dot = 0.f;
#pragma unroll
        for (int pk = 0; pk < NPK; ++pk) {
          float kx[VEC];
          kr[u][pk].unpack(kx);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            part_dot = fmaf(qv[r][pk * VEC + i], kx[i], part_dot);
        }
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
      float lsum = 0.f, pv[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) pv[i] = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(sc[u] - m_new);
        lsum += p;
#pragma unroll
        for (int pk = 0; pk < NPK; ++pk) {
          float vx[VEC];
          vr[u][pk].unpack(vx);
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            pv[pk * VEC + i] = fmaf(p, vx[i], pv[pk * VEC + i]);
        }
      }
      l[r] = fmaf(l[r], corr, lsum);
#pragma unroll
      for (int i = 0; i < NV; ++i) acc[r][i] = fmaf(acc[r][i], corr, pv[i]);
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
      for (int i = 0; i < NV; ++i) {
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
    if (grp == 0)
#pragma unroll
      for (int pk = 0; pk < NPK; ++pk)
        if (act[pk])
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            sw[r * (d + 2) + 2 + col + pk * pstride + i] = acc[r][pk * VEC + i];
  }
  __syncthreads();
  const long long bg = (long long)b * gridDim.y + g;
  for (int idx = tid; idx < rep * d; idx += NT) {
    const int r = idx / d, cc = idx - r * d;
    float mm = -INFINITY;
    for (int w = 0; w < NWARP; ++w)
      mm = fmaxf(mm, smem[(w * rep + r) * (d + 2)]);
    float num = 0.f, den = 0.f;              // row r0 < r1: mm is finite
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
    const int* __restrict__ kv_len, const int* __restrict__ kv_start,
    const float* __restrict__ part, T* __restrict__ o,
    float* __restrict__ lse, Shape sh) {
  constexpr int NW = NT_MERGE / MERGE_COLS;
  __shared__ float s_st[3][NW][MERGE_COLS];
  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lc = tid % MERGE_COLS, w = tid / MERGE_COLS;
  const int2 rows = valid_rows(kv_len, kv_start, b, sh.s_max);
  // the chunks that wrote: c0 (holding the first valid row) .. nv - 1,
  // none when no row is valid
  const bool any = rows.x < rows.y;
  const int c0 = any ? rows.x / sh.chunk : 0;
  const int nv = any ? (rows.y + sh.chunk - 1) / sh.chunk : 0;
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
    for (int c = c0 + w; c < nv; c += NW) {
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
    if (any)                          // no valid row: the output is 0
      for (int i = 0; i < NW; ++i) {
        const float f = exp2f(s_st[0][i][lc] - mm);   // an idle warp: 0
        tn = fmaf(f, s_st[1][i][lc], tn);
        td = fmaf(f, s_st[2][i][lc], td);
      }
    o[b * sh.osb + (g * rep + r) * sh.osh + cc] =
        from_f<T>(any ? tn / td : 0.f);
    // lse (B, Hq), contiguous: the scores are in log2 units
    if (lse != nullptr && cc == 0)
      lse[b * gridDim.x * rep + g * rep + r] =
          any ? (mm + log2f(td)) / LOG2E : -INFINITY;
  }
}

// ---- groups of 2-16 on the tensor cores: cp.async rings, mma.sync ---------

constexpr int TC_ROWS = 16;       // kv rows of a warp's step

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 bf16 matrices, lanes 8 i .. 8 i + 7 giving matrix i's rows
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// the shared memory of the tensor-core body for caches of type T at head
// dim D: the group's Q (16 rows), then each warp's ring of STAGES steps
// (K then V, TC_ROWS rows each; as stored, so float8 rows are D bytes) and,
// for float8, its bf16 copy of one step; bf16 rows are padded to LDS
template <typename T, int D>
struct TcPlan {
  static constexpr int LDS = D + 8;                  // bf16 row, elements
  static constexpr int STAGES = 2;
  static constexpr int CH = D * (int)sizeof(T) / 16;  // 16-byte chunks a row
  static constexpr int RAW_LD = sizeof(T) == 2 ? 2 * LDS : D;   // bytes
  static constexpr int RAW_TILE = TC_ROWS * RAW_LD;   // one of K, V
  static constexpr int STAGE_BYTES = 2 * RAW_TILE;
  static constexpr int WIDE_BYTES = sizeof(T) == 1 ? 2 * TC_ROWS * LDS * 2
                                                   : 0;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES + WIDE_BYTES;
  static constexpr int Q_BYTES = TC_ROWS * LDS * 2;
  static constexpr int SMEM = Q_BYTES + NWARP * WARP_BYTES;
  // the warps' states merge through the rings' bytes
  static_assert(NWARP * MAX_REP * (D + 2) * 4 <= NWARP * WARP_BYTES,
                "the merge does not fit the rings");
  static_assert(D % 16 == 0 && D <= MAX_D, "head dims 64, 128, 256");
};

// two float8 values (the low 16 bits of x) as a bf16 pair, exactly
template <typename T>
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t x) {
  const float2 f = fp8x2_to_float2<T>(x);
  return pack_bf16(f.x, f.y);
}

// rows of kv head `blockIdx.y` of sequence `blockIdx.z` in chunk
// `blockIdx.x`, as decode_split_kernel, on the tensor cores: the same
// partials for the same merge
template <typename T, int D>
__global__ void __launch_bounds__(NT) decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    const int* __restrict__ kv_start, float* __restrict__ part, Shape sh) {
  using P = TcPlan<T, D>;
  constexpr int LDS = P::LDS;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* rings = smem + P::Q_BYTES;

  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int2 rows = valid_rows(kv_len, kv_start, b, sh.s_max);
  const int r0 = max(c * sh.chunk, rows.x);
  const int r1 = min(c * sh.chunk + sh.chunk, rows.y);
  if (r0 >= r1) return;                      // nothing of this chunk is valid
  const int rep = sh.rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the group's query heads as stored (rows rep..15 zero): the scale
  // multiplies the float32 scores
  for (int i = tid; i < TC_ROWS * D; i += NT) {
    const int r = i / D, col = i - r * D;
    qs[r * LDS + col] = r < rep ? q[b * sh.qsb + (g * rep + r) * sh.qsh + col]
                                : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  const T* kb = k + b * sh.ksb + g * sh.ksh;
  const T* vb = v + b * sh.vsb + g * sh.vsh;
  const int nstep = (r1 - r0 + TC_ROWS - 1) / TC_ROWS;
  // my steps: warp, warp + NWARP, ...
  const int mine = nstep > warp ? (nstep - warp + NWARP - 1) / NWARP : 0;
  uint8_t* ring = rings + warp * P::WARP_BYTES;

  // my j-th step's rows into stage j % STAGES, zeros past the chunk
  auto load = [&](int j) {
    const int row0 = r0 + (warp + j * NWARP) * TC_ROWS;
    uint8_t* st = ring + (j % P::STAGES) * P::STAGE_BYTES;
    static_assert(TC_ROWS * P::CH % 32 == 0, "whole chunks a lane");
#pragma unroll
    for (int it = 0; it < TC_ROWS * P::CH / 32; ++it) {
      const int i = lane + 32 * it;
      const int r = i / P::CH, ch = i - r * P::CH;
      const int row = row0 + r;
      const bool in = row < r1;
      const long long rr = in ? row : r0;
      constexpr int EL = 16 / (int)sizeof(T);        // elements a chunk
      cp_async16(st + r * P::RAW_LD + ch * 16, kb + rr * sh.kss + ch * EL,
                 in);
      cp_async16(st + P::RAW_TILE + r * P::RAW_LD + ch * 16,
                 vb + rr * sh.vss + ch * EL, in);
    }
  };

  // fragment rows: heads h0 = lane / 4 and h1 = h0 + 8; columns 2 (lane % 4)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int j = 0; j < P::STAGES - 1; ++j) {
    if (j < mine) load(j);
    cp_async_commit();
  }
  for (int j = 0; j < mine; ++j) {
    if (j + P::STAGES - 1 < mine) load(j + P::STAGES - 1);
    cp_async_commit();
    cp_async_wait<P::STAGES - 1>();          // step j has landed
    __syncwarp();
    const uint8_t* st = ring + (j % P::STAGES) * P::STAGE_BYTES;
    const __nv_bfloat16* ks;
    const __nv_bfloat16* vs;
    if constexpr (sizeof(T) == 1) {
      // widen the float8 step to bf16, 8 values a lane at a time
      __nv_bfloat16* wide =
          reinterpret_cast<__nv_bfloat16*>(ring + P::STAGES * P::STAGE_BYTES);
#pragma unroll
      for (int it = 0; it < 2 * TC_ROWS * D / 8 / 32; ++it) {
        const int i = lane + 32 * it;
        const int t = i / (TC_ROWS * D / 8);         // 0: K, 1: V
        const int rem = i - t * (TC_ROWS * D / 8);
        const int r = rem / (D / 8), c8 = (rem - r * (D / 8)) * 8;
        const uint2 x = *reinterpret_cast<const uint2*>(
            st + t * P::RAW_TILE + r * D + c8);
        uint4 o;
        o.x = fp8x2_to_bf16x2<T>(x.x);
        o.y = fp8x2_to_bf16x2<T>(x.x >> 16);
        o.z = fp8x2_to_bf16x2<T>(x.y);
        o.w = fp8x2_to_bf16x2<T>(x.y >> 16);
        *reinterpret_cast<uint4*>(wide + (t * TC_ROWS + r) * LDS + c8) = o;
      }
      __syncwarp();
      ks = wide;
      vs = wide + TC_ROWS * LDS;
    } else {
      ks = reinterpret_cast<const __nv_bfloat16*>(st);
      vs = reinterpret_cast<const __nv_bfloat16*>(st + P::RAW_TILE);
    }

    // S = Q K^T: 16 heads x 16 rows, two n8 tiles, D / 16 k16 steps
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], kf[4];
      ldsm_x4(a, qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + kk * 16 +
                     (lane >> 4) * 8);
      ldsm_x4(kf, ks + ((lane >> 4) * 8 + (lane & 7)) * LDS + kk * 16 +
                      ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], a, kf[0], kf[1]);
      mma_bf16(sc[1], a, kf[2], kf[3]);
    }
    // scores in log2 units; rows past the chunk score -inf
    const int col0 = r0 + (warp + j * NWARP) * TC_ROWS + 2 * (lane & 3);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * sh.qscale;
        if (col0 + 8 * n + (e & 1) >= r1) x = -INFINITY;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the four lanes of a head row are lanes 4 (lane / 4) .. + 3
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: a row is valid
      base[h] = m_new;
      corr[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = exp2f(sc[n][e] - base[e >> 1]);
        l[e >> 1] += sc[n][e];
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P (bf16) as the A fragment of one k16 step: the two score tiles
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]),
                            pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]),
                            pack_bf16(sc[1][2], sc[1][3])};
    // O += P V: D / 8 n8 tiles, two an ldmatrix
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS +
                            n * 8 + (lane >> 4) * 8);
      mma_bf16(acc[n], pa, vf[0], vf[1]);
      mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
    }
    __syncwarp();                // the stage is read before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  // the warps' states through the rings' bytes, once every warp is done
  __syncthreads();
  float* merge = reinterpret_cast<float*>(rings);   // [NWARP][rep][D + 2]
  float* sw = merge + warp * rep * (D + 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    if (r >= rep) continue;
    if ((lane & 3) == 0) {
      sw[r * (D + 2)] = m[h];
      sw[r * (D + 2) + 1] = l[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      sw[r * (D + 2) + 2 + 8 * n + 2 * (lane & 3)] = acc[n][2 * h];
      sw[r * (D + 2) + 2 + 8 * n + 2 * (lane & 3) + 1] = acc[n][2 * h + 1];
    }
  }
  __syncthreads();
  const long long bg = (long long)b * gridDim.y + g;
  for (int idx = tid; idx < rep * D; idx += NT) {
    const int r = idx / D, cc = idx - r * D;
    float mm = -INFINITY;
    for (int w = 0; w < NWARP; ++w)
      mm = fmaxf(mm, merge[(w * rep + r) * (D + 2)]);
    float num = 0.f, den = 0.f;              // warp 0 took a step: finite
    for (int w = 0; w < NWARP; ++w) {
      const float* sr = merge + (w * rep + r) * (D + 2);
      const float f = exp2f(sr[0] - mm);     // an idle warp gives 0
      num = fmaf(f, sr[2 + cc], num);
      den = fmaf(f, sr[1], den);
    }
    float* pr = part + ((bg * sh.nchunk + c) * rep + r) * (D + 2);
    if (cc == 0) {
      pr[0] = mm;
      pr[1] = den;
    }
    pr[2 + cc] = num;
  }
}

size_t smem_bytes(int rep, int d) {
  return sizeof(float) * (size_t)(NWARP * rep * (d + 2));
}

// the merge of the partials the split grid wrote
template <typename TQ>
int launch_merge(const int* kv_len, const int* kv_start, const float* part,
                 TQ* o, float* lse, const Shape& sh, int batch, int hkv,
                 cudaStream_t stream) {
  const dim3 mgrid(hkv, batch, (sh.rep * sh.d + MERGE_COLS - 1) / MERGE_COLS);
  decode_merge_kernel<TQ><<<mgrid, NT_MERGE, 0, stream>>>(
      kv_len, kv_start, part, o, lse, sh);
  return (int)cudaGetLastError();
}

template <typename TQ, typename T, int REP, int VEC, int NPK>
int launch_rep(const TQ* q, const T* k, const T* v, const int* kv_len,
               const int* kv_start, TQ* o, float* lse, float* part,
               const Shape& sh, int batch, int hkv, int vec,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(sh.rep, sh.d);
  auto split = decode_split_kernel<TQ, T, REP, VEC, NPK>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(sh.nchunk, hkv, batch), NT, smem, stream>>>(
      q, k, v, kv_len, kv_start, part, sh, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge<TQ>(kv_len, kv_start, part, o, lse, sh, batch, hkv,
                          stream);
}

template <typename T, int D>
int launch_tc_d(const __nv_bfloat16* q, const T* k, const T* v,
                const int* kv_len, const int* kv_start, __nv_bfloat16* o,
                float* lse, float* part, const Shape& sh, int batch, int hkv,
                cudaStream_t stream) {
  using P = TcPlan<T, D>;
  auto split = decode_tc_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      split, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  split<<<dim3(sh.nchunk, hkv, batch), NT, P::SMEM, stream>>>(
      q, k, v, kv_len, kv_start, part, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge<__nv_bfloat16>(kv_len, kv_start, part, o, lse, sh,
                                     batch, hkv, stream);
}

// NPK: 2 where 32 lanes of VEC columns do not cover D (VEC 4 past D 128)
template <typename TQ, typename T, int REP, int VEC>
int launch_npk(const TQ* q, const T* k, const T* v, const int* kv_len,
               const int* kv_start, TQ* o, float* lse, float* part,
               const Shape& sh, int batch, int hkv, int vec,
               cudaStream_t stream) {
  if constexpr (32 * VEC < MAX_D) {
    if (sh.lpr * VEC < sh.d)
      return launch_rep<TQ, T, REP, VEC, 2>(q, k, v, kv_len, kv_start, o,
                                            lse, part, sh, batch, hkv, vec,
                                            stream);
  }
  return launch_rep<TQ, T, REP, VEC, 1>(q, k, v, kv_len, kv_start, o, lse,
                                        part, sh, batch, hkv, vec, stream);
}

// VEC (columns a lane loads at once): 16 bytes of the cache's type, but 8
// bytes for bf16 query groups of 8 or more, whose per-lane query and
// accumulator registers grow with the group; a float8 cache keeps bf16's
// columns (16 bytes, 16 columns, only for groups of 1-2 and head dims
// that 16 divides: a lane's pack must not cross the row's end)
template <typename T>
int vec_cols(int rep, int d) {
  if (sizeof(T) == 4 || rep > 4) return 4;
  return sizeof(T) == 1 && rep <= 2 && d % 16 == 0 ? 16 : 8;
}

template <typename TQ, typename T, int REP>
int launch_vec(const TQ* q, const T* k, const T* v, const int* kv_len,
               const int* kv_start, TQ* o, float* lse, float* part,
               const Shape& sh, int batch, int hkv, int vec, int vec_el,
               cudaStream_t stream) {
#define DECODE_VEC(VV)                                                       \
  return launch_npk<TQ, T, REP, VV>(q, k, v, kv_len, kv_start, o, lse, part, \
                                    sh, batch, hkv, vec, stream)
  if constexpr (sizeof(T) == 4 || REP > 4) {
    DECODE_VEC(4);
  } else if constexpr (sizeof(T) == 1 && REP <= 2) {
    if (vec_el == 16) DECODE_VEC(16);
    DECODE_VEC(8);
  } else {
    DECODE_VEC(8);
  }
#undef DECODE_VEC
}

// the launch's arguments checked and its shape filled (lpr left 0)
bool make_shape(Shape* sh, const long long* st, int batch, int s_max, int hq,
                int hkv, int d, float scale, int chunk) {
  if (batch <= 0 || s_max <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      hq / hkv > MAX_REP || d <= 0 || d % 8 || d > MAX_D || batch > 65535 ||
      hkv > 65535 || chunk <= 0)
    return false;
  sh->qsb = st[0]; sh->qsh = st[1]; sh->ksb = st[2]; sh->kss = st[3];
  sh->ksh = st[4]; sh->vsb = st[5]; sh->vss = st[6]; sh->vsh = st[7];
  sh->osb = st[8]; sh->osh = st[9];
  sh->s_max = s_max; sh->rep = hq / hkv; sh->d = d; sh->chunk = chunk;
  sh->nchunk = (s_max + chunk - 1) / chunk;
  sh->lpr = 0;
  sh->qscale = scale * LOG2E;
  return true;
}

template <typename TQ, typename T>
int launch(const TQ* q, const T* k, const T* v, const int* kv_len,
           const int* kv_start, TQ* o, float* lse, float* part,
           const long long* st, int batch, int s_max, int hq, int hkv, int d,
           float scale, int chunk, void* stream) {
  Shape sh;
  if (!make_shape(&sh, st, batch, s_max, hq, hkv, d, scale, chunk))
    return (int)cudaErrorInvalidValue;
  const int rep = sh.rep;
  const int vec_el = vec_cols<T>(rep, d);
  int lpr = 1;                 // lanes per row: a power of 2, at most 32
  while (lpr < 32 && lpr * vec_el < d) lpr <<= 1;
  sh.lpr = lpr;
  // pack loads need every row start aligned to the pack
  const unsigned long long align = (unsigned long long)vec_el * sizeof(T);
  const int vec = reinterpret_cast<unsigned long long>(k) % align == 0 &&
                  reinterpret_cast<unsigned long long>(v) % align == 0 &&
                  st[2] % vec_el == 0 && st[3] % vec_el == 0 &&
                  st[4] % vec_el == 0 && st[5] % vec_el == 0 &&
                  st[6] % vec_el == 0 && st[7] % vec_el == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DECODE_CASE(RR)                                                      \
  return launch_vec<TQ, T, RR>(q, k, v, kv_len, kv_start, o, lse, part, sh,  \
                               batch, hkv, vec, vec_el, s)
  if (rep <= 1) DECODE_CASE(1);
  if (rep <= 2) DECODE_CASE(2);
  if (rep <= 4) DECODE_CASE(4);
  if (rep <= 8) DECODE_CASE(8);
  DECODE_CASE(16);
#undef DECODE_CASE
}

// The tensor-core body takes a bf16 q over bf16 or float8 caches at head
// dims 64, 128 and 256, with 16-byte-aligned cache rows (cp.async): both
// base pointers and every cache stride a multiple of 16 bytes.
template <typename T>
int launch_tc(const __nv_bfloat16* q, const T* k, const T* v,
              const int* kv_len, const int* kv_start, __nv_bfloat16* o,
              float* lse, float* part, const long long* st, int batch,
              int s_max, int hq, int hkv, int d, float scale, int chunk,
              void* stream) {
  Shape sh;
  if (!make_shape(&sh, st, batch, s_max, hq, hkv, d, scale, chunk))
    return (int)cudaErrorInvalidValue;
  constexpr int EL = 16 / (int)sizeof(T);
  if (reinterpret_cast<unsigned long long>(k) % 16 ||
      reinterpret_cast<unsigned long long>(v) % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 2; i < 8; ++i)
    if (st[i] % EL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_tc_d<T, 64>(q, k, v, kv_len, kv_start, o, lse, part, sh,
                                batch, hkv, s);
    case 128:
      return launch_tc_d<T, 128>(q, k, v, kv_len, kv_start, o, lse, part,
                                 sh, batch, hkv, s);
    case 256:
      return launch_tc_d<T, 256>(q, k, v, kv_len, kv_start, o, lse, part,
                                 sh, batch, hkv, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 10 values in elements: q (batch, head); k (batch, seq, head);
// v (batch, seq, head); o (batch, head). Head dims have stride 1. kv_start:
// null, or a contiguous int32 (batch,) of each sequence's first valid row.
// lse: null, or a contiguous float32 (batch, Hq) for each head's
// log-sum-exp of its scaled scores (-inf where no row is valid). part:
// float32 scratch of B * Hkv * ceil(S_max / chunk) * (Hq / Hkv) * (D + 2)
// values. decode_attention_<q>_<cache>: the caches in float8 e4m3 or e5m2,
// or in bfloat16, under a q (and output) of bfloat16 or float32. The
// entries ending in _tc run the tensor-core body (a bf16 q; head dims 64,
// 128 and 256; 16-byte-aligned cache rows; any group the wrapper sends);
// the others the CUDA-core body.
#define DECODE_ENTRY(NAME, TQ, T)                                            \
  extern "C" int NAME(const TQ* q, const T* k, const T* v,                   \
                      const int* kv_len, const int* kv_start, TQ* o,         \
                      float* lse, float* part, const long long* strides,     \
                      int batch, int s_max, int hq, int hkv, int d,          \
                      float scale, int chunk, void* stream) {                \
    return launch<TQ, T>(q, k, v, kv_len, kv_start, o, lse, part, strides,   \
                         batch, s_max, hq, hkv, d, scale, chunk, stream);    \
  }
DECODE_ENTRY(decode_attention_f32, float, float)
DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16, __nv_bfloat16)
DECODE_ENTRY(decode_attention_bf16_e4m3, __nv_bfloat16, __nv_fp8_e4m3)
DECODE_ENTRY(decode_attention_bf16_e5m2, __nv_bfloat16, __nv_fp8_e5m2)
DECODE_ENTRY(decode_attention_f32_e4m3, float, __nv_fp8_e4m3)
DECODE_ENTRY(decode_attention_f32_e5m2, float, __nv_fp8_e5m2)
DECODE_ENTRY(decode_attention_f32_bf16, float, __nv_bfloat16)
#undef DECODE_ENTRY

#define DECODE_TC_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const __nv_bfloat16* q, const T* k, const T* v,        \
                      const int* kv_len, const int* kv_start,                \
                      __nv_bfloat16* o, float* lse, float* part,             \
                      const long long* strides, int batch, int s_max, int hq,\
                      int hkv, int d, float scale, int chunk, void* stream) {\
    return launch_tc<T>(q, k, v, kv_len, kv_start, o, lse, part, strides,    \
                        batch, s_max, hq, hkv, d, scale, chunk, stream);     \
  }
DECODE_TC_ENTRY(decode_attention_bf16_tc, __nv_bfloat16)
DECODE_TC_ENTRY(decode_attention_bf16_e4m3_tc, __nv_fp8_e4m3)
DECODE_TC_ENTRY(decode_attention_bf16_e5m2_tc, __nv_fp8_e5m2)
#undef DECODE_TC_ENTRY
