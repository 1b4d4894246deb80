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
//
// Design. The TPU grid walks kv blocks sequentially with the running
// statistics in VMEM scratch, and its wrapper first transposes the whole
// cache to (B, Hkv, S, D). Here one block of 8 warps serves one
// (sequence, kv head) and the Hq / Hkv query heads that share it, reading
// the cache in its native (B, S_max, Hkv, D) layout through strides: each
// valid row is read once, and rows past L_b not at all. Each warp walks its
// own share of the rows, U at a time (U rows of K and of V in flight per
// warp), with lane i holding columns 4i..4i+3 of the query heads, the rows
// and its accumulator in registers: a score is a warp all-reduce of the
// lanes' partial dots, and each warp keeps its own running max, sum and
// accumulator per query head. At the end the 8 warps' states are merged
// through shared memory (rescaled to the largest max). L_b is read on the
// device, so one kernel serves every step with no host sync. At 8
// sequences x 8 kv heads that is 64 blocks, under the 132 SMs: splitting a
// sequence's rows across blocks (split-KV) is left for later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int NT = 256;
constexpr int NWARP = NT / 32;
constexpr int MAX_D = 128;      // 32 lanes x 4 columns
constexpr int MAX_REP = 16;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive elements; vec: one 16-byte (float) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, bool vec, float* out) {
  if (vec) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = p[i];
  }
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, bool vec,
                                      float* out) {
  if (vec) {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __bfloat162float(p[i]);
  }
}

size_t smem_bytes(int rep, int d) {
  return sizeof(float) * (size_t)(NWARP * rep * (d + 2));
}

// REP: a power of two >= rep (registers are sized for it)
template <typename T, int REP>
__global__ void __launch_bounds__(NT) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ kv_len,
    T* __restrict__ o, long long qsb, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long osh, int s_max, int rep, int d,
    float scale, int vec) {
  // rows in flight per warp: fewer for wider query groups (registers)
  constexpr int U = REP <= 2 ? 8 : (REP <= 4 ? 4 : 2);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);   // [NWARP][rep][d + 2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = blockIdx.x, b = blockIdx.y;
  const int len = min(max(kv_len[b], 0), s_max);
  const int c0 = lane * 4;
  const bool act = c0 < d;
  const bool vload = vec != 0;

  float qv[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r < rep && act) {
      load4(q + b * qsb + (g * rep + r) * qsh + c0, false, qv[r]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[r][i] *= scale;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[r][i] = 0.f;
    }
  }
  float m[REP], l[REP], acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
  }

  const T* kb = k + b * ksb + g * ksh + c0;
  const T* vb = v + b * vsb + g * vsh + c0;
  for (int j0 = warp * U; j0 < len; j0 += NWARP * U) {
    float kx[U][4], vx[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j < len && act) {
        load4(kb + j * kss, vload, kx[u]);
        load4(vb + j * vss, vload, vx[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r >= rep) break;
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) part = fmaf(qv[r][i], kx[u][i], part);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[u] = j0 + u < len ? part : -INFINITY;
      }
      float mx = sc[0];                 // row j0 < len is valid
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, sc[u]);
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      float lsum = 0.f, pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(sc[u] - m_new);
        lsum += p;
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = fmaf(p, vx[u][i], pv[i]);
      }
      l[r] = l[r] * corr + lsum;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(acc[r][i], corr, pv[i]);
      m[r] = m_new;
    }
  }

  // merge the warps: each publishes (max, sum, accumulator) per query head
  float* sw = smem + warp * rep * (d + 2);
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sw[r * (d + 2)] = m[r];
      sw[r * (d + 2) + 1] = l[r];
    }
    if (act)
#pragma unroll
      for (int i = 0; i < 4; ++i) sw[r * (d + 2) + 2 + c0 + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = tid; idx < rep * d; idx += NT) {
    const int r = idx / d, c = idx - r * d;
    float mm = -INFINITY;
    for (int w = 0; w < NWARP; ++w)
      mm = fmaxf(mm, smem[(w * rep + r) * (d + 2)]);
    float num = 0.f, den = 0.f;
    if (mm != -INFINITY) {              // L_b = 0 leaves every warp empty
      for (int w = 0; w < NWARP; ++w) {
        const float* sr = smem + (w * rep + r) * (d + 2);
        const float f = expf(sr[0] - mm);   // an empty warp gives 0
        num = fmaf(f, sr[2 + c], num);
        den = fmaf(f, sr[1], den);
      }
    }
    o[b * osb + (g * rep + r) * osh + c] = from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int REP>
int launch_rep(const T* q, const T* k, const T* v, const int* kv_len, T* o,
               const long long* st, int batch, int s_max, int hkv, int rep,
               int d, float scale, int vec, cudaStream_t stream) {
  const size_t smem = smem_bytes(rep, d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, REP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hkv, batch);
  decode_kernel<T, REP><<<grid, NT, smem, stream>>>(
      q, k, v, kv_len, o, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], s_max, rep, d, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* kv_len, T* o,
           const long long* st, int batch, int s_max, int hq, int hkv,
           int d, float scale, void* stream) {
  if (batch <= 0 || s_max <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      hq / hkv > MAX_REP || d <= 0 || d % 8 || d > MAX_D || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int rep = hq / hkv;
  // vector loads of 4 elements need the cache rows 4-element aligned
  const unsigned long long align = 4 * sizeof(T);
  const int vec = reinterpret_cast<unsigned long long>(k) % align == 0 &&
                  reinterpret_cast<unsigned long long>(v) % align == 0 &&
                  st[2] % 4 == 0 && st[3] % 4 == 0 && st[4] % 4 == 0 &&
                  st[5] % 4 == 0 && st[6] % 4 == 0 && st[7] % 4 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rep <= 1)
    return launch_rep<T, 1>(q, k, v, kv_len, o, st, batch, s_max, hkv, rep,
                            d, scale, vec, s);
  if (rep <= 2)
    return launch_rep<T, 2>(q, k, v, kv_len, o, st, batch, s_max, hkv, rep,
                            d, scale, vec, s);
  if (rep <= 4)
    return launch_rep<T, 4>(q, k, v, kv_len, o, st, batch, s_max, hkv, rep,
                            d, scale, vec, s);
  if (rep <= 8)
    return launch_rep<T, 8>(q, k, v, kv_len, o, st, batch, s_max, hkv, rep,
                            d, scale, vec, s);
  return launch_rep<T, 16>(q, k, v, kv_len, o, st, batch, s_max, hkv, rep,
                           d, scale, vec, s);
}

}  // namespace

// strides: 10 values in elements: q (batch, head); k (batch, seq, head);
// v (batch, seq, head); o (batch, head). Head dims have stride 1.
extern "C" int decode_attention_f32(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* o, const long long* strides,
                                    int batch, int s_max, int hq, int hkv,
                                    int d, float scale, void* stream) {
  return launch<float>(q, k, v, kv_len, o, strides, batch, s_max, hq, hkv,
                       d, scale, stream);
}

extern "C" int decode_attention_bf16(const __nv_bfloat16* q,
                                     const __nv_bfloat16* k,
                                     const __nv_bfloat16* v,
                                     const int* kv_len, __nv_bfloat16* o,
                                     const long long* strides, int batch,
                                     int s_max, int hq, int hkv, int d,
                                     float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, kv_len, o, strides, batch, s_max,
                               hq, hkv, d, scale, stream);
}
