// Causal grouped-query flash attention, forward, for prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (entry flash_attention_bhsd). For q (B, S, Hq, D) and
// k, v (B, S, Hkv, D), query head h reads kv head h / (Hq / Hkv) and
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
// over j <= i (causal) or all j < S, with float32 scores, softmax
// statistics and accumulator, and the output rounded once to q's type
// (float32 or bfloat16), as the TPU kernel computes it; the Hopper body
// also rounds the softmax weights to bfloat16 for the second product.
//
// What bounds it on an H100: 4 S^2 Hq D / 2 operations (causal) against
// (2 Hq + 2 Hkv) S D elements moved; at S = 1024, D = 128 that is ~2,000
// operations per byte, so the tensor cores' rate bounds it (989 TFLOP/s
// bf16).
//
// Design. The TPU grid walks kv blocks sequentially and carries the
// running max, denominator and accumulator in VMEM scratch. Here one block
// owns a tile of query rows of one (batch, head) and loops over kv tiles up
// to the causal limit, so the online-softmax state never leaves the block.
// Query tiles are issued heaviest (latest) first, since causal tiles differ
// in length. The wrapper picks one of two bodies from its inputs:
// - bfloat16 with D 64 or 128, 16-byte-aligned pointers and strides that
//   are multiples of 8 elements (the model's case): the Hopper body
//   (flash_wgmma_kernel). One producer warpgroup issues TMA loads: the
//   block's Q tile once, then K and V tiles into a ring of stages, each
//   guarded by a full and an empty mbarrier. The tensor maps describe the
//   (B, S, H, D) tensors through their strides (no transposed copy) with
//   the 128-byte swizzle, so a D = 128 row is two 64-wide boxes; rows past
//   S arrive as zeros. One or two consumer warpgroups, 64 query rows each,
//   compute S = Q K^T with wgmma (Q and K from shared memory, both K-major),
//   the online softmax in the log2 domain in float32 registers, round P to
//   bfloat16 in registers and feed it as wgmma's register A operand for
//   O += P V (V from shared memory, MN-major: the transpose flag). Only the
//   tiles that cross the diagonal or the end of S test the mask; a
//   warpgroup skips tiles wholly above its rows.
// - float32, and bfloat16 otherwise: float32 FMAs on the CUDA cores
//   (flash_kernel): 256 threads, each holding 4 query rows' statistics and
//   a 4 x ceil(D/16) slice of the accumulator in registers; the Q tile
//   (pre-scaled), the K and V tiles and the probabilities staged in shared
//   memory as float32; a thread computes a 4 x 4 block of scores per tile
//   (rows 4 ty.., columns tx + 16 j), so the K rows read by the 16 column
//   threads sit D + 1 words apart and hit 16 different banks. It is bound
//   by the CUDA cores' issue rate and shared-memory loads.
// Both mask ragged S themselves (rows >= S are not written, columns >= S
// score -inf), so nothing is padded.
//
// Tile plan of the Hopper body: kv tiles of 128 rows a stage, and BQ query
// rows a block, 64 per consumer warpgroup. The wrapper's block_rows() takes
// 64-row blocks while all of them run at once, one an SM (B Hq ceil(S / 64)
// <= 132), else 128-row blocks. chip_smoke.py's "flash tile plans" phase
// times both at qwen3_1_7b's heads (B 1, 16/8 x 128, causal; CUDA-graph
// replays on an NVIDIA H100 80GB HBM3 at 700 W), e.g. at S 128: BQ 64
// 0.0057 ms, BQ 128 0.0079; S 512: 0.0102, 0.0142; S 768: 0.0189, 0.0182;
// S 1,024: 0.0268, 0.0221 (PERF.md keeps the readings).
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>


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

// ---- bfloat16 on Hopper's tensor cores: TMA loads, wgmma products -------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

// one arrival that also announces the bytes the TMA loads will deliver
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// wait for the phase of parity `parity` to complete; a wait that outlasts
// any real one (~2^30 polls) traps, so a broken pipeline fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 30)) __trap();
  }
}

// TMA: one box of a 4-d tensor map (coordinates innermost first) into
// shared memory, completion counted in bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, float32, the wgmma accumulator layout) (+)= A B: A 64 x 16 and
// B 16 x N from shared memory, both K-major (ss, N = 128: one kv tile), or
// A from registers and B MN-major (rs, N = D: the transpose flag of 16-bit
// types)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_ss0_n128(float* d, uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "n"(0));
}


// the first k16 step of a product writes D without reading it, so no
// earlier instruction that defined D's registers is an input of the pipe
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         bool first) {
  if (first) wgmma_ss0_n128(d, da, db);
  else wgmma_ss_n128(d, da, db);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D head dim (64 or 128), NWG consumer warpgroups of 64 query rows; one
// more warpgroup produces. kv tiles are 128 rows.
template <int D, int NWG>
struct Tile {
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = 128;                    // kv rows per stage
  static constexpr int BOXES = D / 64;              // 64-wide boxes per row
  // three stages in the ring, so the next two tiles load while one is
  // computed (230,456 bytes at most: BQ 128, D 128)
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;       // one of K, V per stage
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int THREADS = 128 * (NWG + 1);
};

template <int D, int NWG>
__global__ void __launch_bounds__(Tile<D, NWG>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, Strides os, int seq,
                       int rep, float scale_log2, int causal) {
  using T = Tile<D, NWG>;
  constexpr int BK = T::BK;  // (the CUDA-core body's BK is 64)
  extern __shared__ uint8_t smem_raw[];
  // the swizzle atoms (8 rows x 128 bytes) need 1024-byte alignment
  uint8_t* qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kvs = qs + T::Q_BYTES;          // stage s: K, then V
  uint64_t* qbar =
      reinterpret_cast<uint64_t*>(kvs + T::STAGES * 2 * T::KV_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + T::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * T::BQ;
  const int kv_end = causal ? min(seq, q0 + T::BQ) : seq;
  const int ntiles = (kv_end + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
#pragma unroll
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NWG) {
    // -- producer: one thread issues every TMA load ----------------------
    if (threadIdx.x == NWG * 128) {
      const int hk = h / rep;
      mbar_expect_tx(qbar, T::Q_BYTES);
#pragma unroll
      for (int x = 0; x < T::BOXES; ++x)
        tma_load_4d(qs + x * T::BQ * 128, &qmap, qbar, x * 64, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % T::STAGES;
        mbar_wait(&empty[s], ((t / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
        uint8_t* ks = kvs + s * 2 * T::KV_BYTES;
        uint8_t* vs = ks + T::KV_BYTES;
#pragma unroll
        for (int x = 0; x < T::BOXES; ++x) {
          tma_load_4d(ks + x * BK * 128, &kmap, &full[s], x * 64, hk, t * BK,
                      b);
          tma_load_4d(vs + x * BK * 128, &vmap, &full[s], x * 64, hk, t * BK,
                      b);
        }
      }
    }
  } else {
    // -- consumers: 64 query rows per warpgroup --------------------------
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int tig = lane % 4;
    const int first = q0 + wg * 64, last = first + 63;
    const int r0 = first + warp * 16 + lane / 4, r1 = r0 + 8;  // my rows
    // this warpgroup's 64 rows inside each Q box
    const uint32_t q_addr = smem_u32(qs) + wg * 64 * 128;

    float acc[D / 2], sc[BK / 2];
    uint32_t pa[BK / 16][4];              // P of the tile in P V
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];

    // S = Q K^T for stage s: D / 16 steps of k16, 32 bytes apart in a box
    auto issue_qk = [&](int s) {
      const uint32_t k_addr = smem_u32(kvs + s * 2 * T::KV_BYTES);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss(
            sc, sw128_desc(q_addr + (kk / 4) * T::BQ * 128 + off, 16, 1024),
            sw128_desc(k_addr + (kk / 4) * BK * 128 + off, 16, 1024),
            kk == 0);
      }
      wgmma_commit();
    };
    // O += P V for stage s: V's k16 rows are 16 x 128 bytes apart, its two
    // 64-wide boxes (D = 128) BK x 128 bytes apart
    auto issue_pv = [&](int s) {
      const uint32_t v_addr =
          smem_u32(kvs + s * 2 * T::KV_BYTES) + T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D>(acc, pa[kk],
                    sw128_desc(v_addr + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
    };
    // the online softmax of tile k0: sc becomes P (float32), with corr
    // and l updated
    auto softmax = [&](int k0) {
      // log2-domain scores; sc[4 j + i]: row i < 2 ? r0 : r1, column
      // k0 + 8 j + 2 tig + (i & 1). Only tiles crossing my rows' diagonal
      // or the end of S test the mask.
      float mx[2] = {-INFINITY, -INFINITY};
      if ((causal && k0 + BK - 1 > first) || k0 + BK > seq) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int row = (e & 2) ? r1 : r0;
          const int col = k0 + 8 * (e / 4) + 2 * tig + (e & 1);
          float x = sc[e] * scale_log2;
          if (col >= seq || (causal && col > row)) x = -INFINITY;
          sc[e] = x;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], x);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          sc[e] *= scale_log2;
          mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
        }
      }
      float base[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // the four threads of a row are lanes 4 (lane / 4) .. + 3
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
        mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
        const float m_new = fmaxf(m[j], mx[j]);
        // a row with nothing valid yet keeps m = -inf and p = 0
        base[j] = m_new == -INFINITY ? 0.f : m_new;
        corr[j] = exp2f(m[j] - base[j]);
        m[j] = m_new;
        l[j] *= corr[j];
      }
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) {
        sc[e] = exp2f(sc[e] - base[(e >> 1) & 1]);
        l[(e >> 1) & 1] += sc[e];
      }
    };
    // rescale O, and round P to bfloat16 as the A fragments of the BK / 16
    // k16 steps of P V
    auto take = [&]() {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= corr[(e >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    };
    // Tiles wholly above my rows (causal) come last: I only release them.
    mbar_wait(qbar, 0);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % T::STAGES;
      mbar_wait(&full[s], (t / T::STAGES) & 1);
      if (!(causal && t * BK > last)) {
        wgmma_fence();
        issue_qk(s);
        wgmma_wait<0>();
        reg_fence<BK / 2>(sc);
        softmax(t * BK);
        take();
        wgmma_fence();
        issue_pv(s);
        wgmma_wait<0>();
        reg_fence<D / 2>(acc);
      }
      mbar_arrive(&empty[s]);
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
      uint32_t* orow = reinterpret_cast<uint32_t*>(ob + row * os.s);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        orow[(n * 8 + tig * 2) / 2] = pack_bf16(acc[4 * n + 2 * j] * inv,
                                                acc[4 * n + 2 * j + 1] * inv);
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's entry-point lookup, so the
// library links no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, S, H, D) bfloat16 tensor as a 4-d map (D, H, S, B) through its
// strides; boxes of 64 x 1 x rows x 1, 128-byte swizzle, zeros past S
int tensor_map(CUtensorMap* map, const void* ptr, const Strides& st, int d,
               int heads, int seq, int batch, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st.h * 2, (cuuint64_t)st.s * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D, int NWG>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, Strides qs,
                 Strides ks, Strides vs, Strides os, int batch, int seq,
                 int hq, int hkv, float scale, int causal,
                 cudaStream_t stream) {
  using T = Tile<D, NWG>;
  CUtensorMap qm, km, vm;
  int err = tensor_map(&qm, q, qs, D, hq, seq, batch, T::BQ);
  if (!err) err = tensor_map(&km, k, ks, D, hkv, seq, batch, T::BK);
  if (!err) err = tensor_map(&vm, v, vs, D, hkv, seq, batch, T::BK);
  if (err) return err;
  // the shared-memory limit is raised once per device for each instance
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  static bool raised[64] = {};
  if (!raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_wgmma_kernel<D, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const dim3 grid((seq + T::BQ - 1) / T::BQ, hq, batch);
  flash_wgmma_kernel<D, NWG><<<grid, T::THREADS, T::SMEM, stream>>>(
      qm, km, vm, o, os, seq, hq / hkv, scale * 1.4426950408889634f, causal);
  return (int)cudaGetLastError();
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

// The Hopper body takes D 64 or 128 and rows TMA can address: 16-byte
// aligned pointers, strides that are multiples of 8 elements.
int launch_hopper(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, __nv_bfloat16* o,
                  const long long* st, int batch, int seq, int hq, int hkv,
                  int d, float scale, int causal, int bq, void* stream) {
  if (batch <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      batch > 65535 || hq > 65535 || (d != 64 && d != 128) ||
      (bq != 64 && bq != 128))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 8 || st[i] <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_HOPPER_CASE(D, NWG)                                          \
  if (d == D && bq == 64 * NWG)                                            \
    return launch_wgmma<D, NWG>(q, k, v, o, qs, ks, vs, os, batch, seq, hq, \
                                hkv, scale, causal, s);
  FLASH_HOPPER_CASE(128, 2)
  FLASH_HOPPER_CASE(128, 1)
  FLASH_HOPPER_CASE(64, 2)
  FLASH_HOPPER_CASE(64, 1)
#undef FLASH_HOPPER_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and o, in elements.
// flash_attention_f32 and flash_attention_bf16 run the CUDA-core body;
// flash_attention_bf16_hopper the TMA + wgmma body with blocks of bq query
// rows (64 or 128).
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

extern "C" int flash_attention_bf16_hopper(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, const long long* strides, int batch, int seq, int hq,
    int hkv, int d, float scale, int causal, int bq, void* stream) {
  return launch_hopper(q, k, v, o, strides, batch, seq, hq, hkv, d, scale,
                       causal, bq, stream);
}
