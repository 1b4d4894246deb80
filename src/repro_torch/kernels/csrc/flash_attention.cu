// Causal grouped-query flash attention, forward, for prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (entry flash_attention_bhsd). For q (B, S, Hq, D) and
// k, v (B, S, Hkv, D), query head h reads kv head h / (Hq / Hkv) and
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
// over j <= i (causal) or all j < S, with float32 scores, softmax
// statistics and accumulator, and the output rounded once to q's type
// (float32 or bfloat16), as the TPU kernel computes it; the tensor-core
// body below also rounds the softmax weights to bfloat16 for the second
// product.
//
// What bounds it on an H100: 4 S^2 Hq D / 2 operations (causal) against
// (2 Hq + 2 Hkv) S D elements moved; at S = 1024, D = 128 that is ~2,000
// operations per byte, so the tensor cores' rate bounds it (989 TFLOP/s
// bf16).
//
// Design. The TPU grid walks kv blocks sequentially and carries the
// running max, denominator and accumulator in VMEM scratch. Here one block
// owns a tile of BQ = 64 query rows of one (batch, head) and loops over kv
// tiles of BK = 64 rows up to the causal limit, so the online-softmax state
// never leaves the block. Two bodies share that plan:
// - bfloat16 with D a multiple of 16 and 16-byte-aligned rows (the model's
//   case) runs on the tensor cores, mma.sync m16n8k16 with float32 sums
//   (flash_mma_kernel, below);
// - float32, and bfloat16 otherwise, runs float32 FMAs on the CUDA cores
//   (flash_kernel): 256 threads, each holding 4 query rows' statistics and
//   a 4 x ceil(D/16) slice of the accumulator in registers; the Q tile
//   (pre-scaled), the K and V tiles and the probabilities staged in shared
//   memory as float32; a thread computes a 4 x 4 block of scores per tile
//   (rows 4 ty.., columns tx + 16 j), so the K rows read by the 16 column
//   threads sit D + 1 words apart and hit 16 different banks. It is bound
//   by the CUDA cores' issue rate and shared-memory loads.
// Both read the model's (B, S, H, D) layout through strides (the head
// dimension contiguous): no transposed copy. Ragged S is masked here (rows
// >= S are neither read nor written, columns >= S score -inf), so nothing
// is padded. Query tiles are issued heaviest (latest) first, since causal
// tiles differ in length.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // kv rows per tile
constexpr int NT = 256;         // threads: 16 column x 16 row groups
constexpr int PLD = BQ + 4;     // row length of the staged probabilities
constexpr int MAX_D = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long b, s, h;            // in elements; the head dim has stride 1
};

size_t smem_bytes(int d) {
  return sizeof(float) *
         (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BK * PLD);
}

// NC = ceil(D / 16): accumulator columns per thread
template <typename T, int NC>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
    Strides vs, Strides os, int seq, int rep, int d, float scale,
    int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = d + 1;
  float* Qs = smem;                 // [BQ][d + 1], pre-scaled
  float* Ks = Qs + BQ * ld;         // [BK][d + 1]
  float* Vs = Ks + BK * ld;         // [BK][d]
  float* Ps = Vs + BK * d;          // [BK][PLD], probabilities transposed

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int q0 = qt * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int idx = tid; idx < BQ * d; idx += NT) {
    const int r = idx / d, c = idx - r * d;
    const int row = q0 + r;
    Qs[r * ld + c] = row < seq ? to_f(qb[row * qs.s + c]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(seq, q0 + BQ) : seq;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    const int kn = min(BK, seq - k0);
    __syncthreads();              // the last tile's K, V and P are consumed
    for (int idx = tid; idx < BK * d; idx += NT) {
      const int r = idx / d, c = idx - r * d;
      const bool in = r < kn;
      Ks[r * ld + c] = in ? to_f(kb[(k0 + r) * ks.s + c]) : 0.f;
      Vs[r * d + c] = in ? to_f(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= seq || (causal && col > row)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are lanes 16 apart: xor 1..8
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing valid yet keeps m = -inf and p = 0
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float corr = expf(m[i] - base);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - base);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(tx + 16 * j) * PLD + ty * 4 + i] = s[i][j];
    }
    __syncthreads();

    for (int j = 0; j < kn; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * PLD + ty * 4]);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        if (col < d) {
          const float vv = Vs[j * d + col];
          acc[0][c] = fmaf(p.x, vv, acc[0][c]);
          acc[1][c] = fmaf(p.y, vv, acc[1][c]);
          acc[2][c] = fmaf(p.z, vv, acc[2][c]);
          acc[3][c] = fmaf(p.w, vv, acc[3][c]);
        }
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= seq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < d) ob[row * os.s + col] = from_f<T>(acc[i][c] * inv);
    }
  }
}


// ---- bfloat16 on the tensor cores (mma.sync m16n8k16, float32 sums) -------
//
// One block of 4 warps owns BQ = 64 query rows, 16 per warp, and loops over
// kv tiles of BK = 64 rows. K and V are staged in shared memory as bfloat16
// (rows D + 8 apart: fragment loads hit 32 different banks), two tiles deep:
// cp.async copies tile t + 1 while the warps compute on tile t. Each
// warp computes its 16 x 64 scores with mma.sync from its Q fragments (held
// in registers for the whole loop), keeps the online-softmax statistics of
// its two rows per thread in registers, turns the probabilities into
// bfloat16 A fragments without leaving registers, and accumulates the
// 16 x D output with mma.sync on V fragments read by ldmatrix.trans. Scores
// and the output are float32; P is rounded to bfloat16 for the second
// product, as flash-attention kernels on tensor cores do.
constexpr int MMA_NT = 128;     // 4 warps x 16 query rows
constexpr int MMA_PAD = 8;      // bf16 row padding of the staged tiles

__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared without registers; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

size_t mma_smem_bytes(int d) {       // two stages of K and V
  return sizeof(__nv_bfloat16) * (size_t)(4 * BK * (d + MMA_PAD));
}

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    Strides qs, Strides ks, Strides vs, Strides os, int seq, int rep,
    float scale_log2, int causal) {
  constexpr int LD = D + MMA_PAD;
  constexpr int KC = D / 16;    // 16-wide chunks of the head dim
  constexpr int NB = BK / 8;    // 8-wide score tiles per kv tile
  constexpr int ND = D / 8;     // 8-wide output tiles
  extern __shared__ float4 smem4[];
  // [2][BK][LD] each: tile t computes from stage t & 1 while tile t + 1
  // is copied into the other (cp.async)
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Vs = Ks + 2 * BK * LD;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / rep;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;   // this thread's rows

  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + hk * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + hk * vs.h;

  unsigned qa[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const int c = kc * 16 + tig * 2;
    const unsigned* p0 = reinterpret_cast<const unsigned*>(qb + r0 * qs.s);
    const unsigned* p1 = reinterpret_cast<const unsigned*>(qb + r1 * qs.s);
    qa[kc][0] = r0 < seq ? p0[c / 2] : 0u;
    qa[kc][1] = r1 < seq ? p1[c / 2] : 0u;
    qa[kc][2] = r0 < seq ? p0[c / 2 + 4] : 0u;
    qa[kc][3] = r1 < seq ? p1[c / 2 + 4] : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  auto load_tile = [&](int stage, int k0) {
    __nv_bfloat16* kd = Ks + stage * BK * LD;
    __nv_bfloat16* vd = Vs + stage * BK * LD;
    for (int idx = tid; idx < BK * (D / 8); idx += MMA_NT) {
      const int r = idx / (D / 8), c = (idx - r * (D / 8)) * 8;
      const bool ok = k0 + r < seq;           // rows past S read as zeros
      const int row = ok ? k0 + r : 0;
      cp_async16(kd + r * LD + c, kb + row * ks.s + c, ok);
      cp_async16(vd + r * LD + c, vb + row * vs.s + c, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int kv_end = causal ? min(seq, q0 + BQ) : seq;
  const int ntiles = (kv_end + BK - 1) / BK;
  load_tile(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    if (t + 1 < ntiles) {
      load_tile((t + 1) & 1, k0 + BK);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();              // tile t has landed for every thread
    const __nv_bfloat16* Kt = Ks + (t & 1) * BK * LD;
    const __nv_bfloat16* Vt = Vs + (t & 1) * BK * LD;

    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nb][i] = 0.f;
      const __nv_bfloat16* kr = Kt + (nb * 8 + gid) * LD + tig * 2;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const unsigned b0 = *reinterpret_cast<const unsigned*>(kr + kc * 16);
        const unsigned b1 =
            *reinterpret_cast<const unsigned*>(kr + kc * 16 + 8);
        mma_bf16(s[nb], qa[kc], b0, b1);
      }
    }

    // scale into the log2 domain and mask: c0, c1 are row r0, c2, c3 row r1
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = i < 2 ? r0 : r1;
        const int col = k0 + nb * 8 + tig * 2 + (i & 1);
        float x = s[nb][i] * scale_log2;
        if (col >= seq || (causal && col > row)) x = -INFINITY;
        s[nb][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float corr[2], base[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      // the four threads of a row are lanes 4 gid .. 4 gid + 3
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      const float m_new = fmaxf(m[j], mx[j]);
      base[j] = m_new == -INFINITY ? 0.f : m_new;
      corr[j] = exp2f(m[j] - base[j]);
      m[j] = m_new;
      l[j] *= corr[j];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nb][i] = exp2f(s[nb][i] - base[i >> 1]);
        l[i >> 1] += s[nb][i];
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vrow =
          Vt + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        unsigned b0, b1, b2, b3;
        const unsigned addr =
            (unsigned)__cvta_generic_to_shared(vrow + n * 8);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
            : "r"(addr));
        mma_bf16(acc[n], pa, b0, b1);
        mma_bf16(acc[n + 1], pa, b2, b3);
      }
    }
    __syncthreads();              // stage t & 1 is free for tile t + 2
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = j ? r1 : r0;
    if (row >= seq) continue;
    const float inv = 1.f / fmaxf(l[j], 1e-30f);
    unsigned* orow = reinterpret_cast<unsigned*>(ob + row * os.s);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      orow[(n * 8 + tig * 2) / 2] =
          pack_bf16(acc[n][2 * j] * inv, acc[n][2 * j + 1] * inv);
  }
}

template <int D>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, Strides qs,
               Strides ks, Strides vs, Strides os, int batch, int seq,
               int hq, int hkv, float scale, int causal,
               cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, hq, batch);
  flash_mma_kernel<D><<<grid, MMA_NT, smem, stream>>>(
      q, k, v, o, qs, ks, vs, os, seq, hq / hkv,
      scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
}

// The tensor-core path takes head dims that are multiples of 16 and rows
// that start on 16 bytes (strides multiples of 8, aligned pointers).
bool mma_ok(const void* q, const void* k, const void* v, const void* o,
            const long long* st, int d) {
  if (d % 16) return false;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) return false;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8) return false;
  return true;
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, T* o, Strides qs,
              Strides ks, Strides vs, Strides os, int batch, int seq,
              int hq, int hkv, int d, float scale, int causal,
              cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, hq, batch);
  flash_kernel<T, NC><<<grid, NT, smem, stream>>>(
      q, k, v, o, qs, ks, vs, os, seq, hq / hkv, d, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, const long long* st,
           int batch, int seq, int hq, int hkv, int d, float scale,
           int causal, void* stream) {
  if (batch <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      d <= 0 || d % 8 || d > MAX_D || batch > 65535 || hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma_ok(q, k, v, o, st, d)) {
#define FLASH_MMA_CASE(D)                                                 \
  case D:                                                                 \
    return launch_mma<D>(q, k, v, o, qs, ks, vs, os, batch, seq, hq, hkv, \
                         scale, causal, s);
      switch (d) {
        FLASH_MMA_CASE(16)
        FLASH_MMA_CASE(32)
        FLASH_MMA_CASE(48)
        FLASH_MMA_CASE(64)
        FLASH_MMA_CASE(80)
        FLASH_MMA_CASE(96)
        FLASH_MMA_CASE(112)
        FLASH_MMA_CASE(128)
      }
#undef FLASH_MMA_CASE
    }
  }
#define FLASH_CASE(NC)                                                    \
  case NC:                                                                \
    return launch_nc<T, NC>(q, k, v, o, qs, ks, vs, os, batch, seq, hq,  \
                            hkv, d, scale, causal, s);
  switch ((d + 15) / 16) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and o, in elements
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o,
                                   const long long* strides, int batch,
                                   int seq, int hq, int hkv, int d,
                                   float scale, int causal, void* stream) {
  return launch<float>(q, k, v, o, strides, batch, seq, hq, hkv, d, scale,
                       causal, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    const long long* strides, int batch,
                                    int seq, int hq, int hkv, int d,
                                    float scale, int causal, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, strides, batch, seq, hq, hkv, d,
                               scale, causal, stream);
}
