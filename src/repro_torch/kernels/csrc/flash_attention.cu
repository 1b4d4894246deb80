// Causal grouped-query flash attention, forward, for prefill.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::
// _flash_kernel (entry flash_attention_bhsd). For q (B, S, Hq, D) and
// k, v (B, S, Hkv, D), query head h reads kv head h / (Hq / Hkv) and
//     o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, hk]) v[b, j, hk]
// over j <= i (causal) or all j < S, and with a sliding window W > 0 (causal
// only) over i - W < j <= i, as the reference's model masks it
// (repro/models/attention.py:88-89, :128-129, :169-170), with float32 scores, softmax
// statistics and accumulator, and the output rounded once to q's type
// (float32 or bfloat16), as the TPU kernel computes it; the Hopper body
// also rounds the softmax weights to bfloat16 for the second product.
//
// What bounds it on an H100: 4 S^2 Hq D / 2 operations (causal) against
// (2 Hq + 2 Hkv) S D elements moved; at S = 1024, D = 128 that is ~2,000
// operations per byte in bfloat16 (~1,000 in float32), so the tensor
// cores' rate bounds it: 989 TFLOP/s bf16; for float32 results the
// float32-accurate rate of the TF32 units, 495 / 3 TFLOP/s (three TF32
// products stand for one float32 product, below), 2.5x the CUDA cores'
// 67.
//
// Design. The TPU grid walks kv blocks sequentially and carries the
// running max, denominator and accumulator in VMEM scratch. Here one block
// owns a tile of query rows of one (batch, head) and loops over kv tiles up
// to the causal limit, so the online-softmax state never leaves the block.
// Query tiles are issued heaviest (latest) first, since causal tiles differ
// in length. The wrapper picks one of three bodies from its inputs:
// - bfloat16 with D 64, 128 or 256, 16-byte-aligned pointers and strides
//   that are multiples of 8 elements (the models' case, gemma_2b's head dim
//   256 among them): the Hopper body (flash_wgmma_kernel). One producer
//   warpgroup issues TMA loads: the block's Q tile once, then K and V tiles
//   into a ring of stages, each guarded by a full and an empty mbarrier. The
//   tensor maps describe the (B, S, H, D) tensors through their strides (no
//   transposed copy) with the 128-byte swizzle, so a row is D / 64 boxes 64
//   wide; rows past S arrive as zeros. One or two consumer warpgroups, 64
//   query rows each, compute S = Q K^T with wgmma (Q and K from shared
//   memory, both K-major), the online softmax in the log2 domain in float32
//   registers, round P to bfloat16 in registers and feed it as wgmma's
//   register A operand for O += P V (V from shared memory, MN-major: the
//   transpose flag). Only the tiles that cross the diagonal or the end of S
//   test the mask; a warpgroup skips tiles wholly above its rows.
// - float32 with D 64, 128 or 256, 16-byte-aligned pointers and strides
//   that are multiples of 4 elements (every float32 prefill and training
//   forward of the models): the float32 tensor-core body
//   (flash_tf32_kernel). The float32 gates (2e-5 on the output, 1e-5 on
//   lse) rule out one TF32 product (~2^-10 relative an operand), so each
//   operand a is split into hi = a truncated to TF32 and lo = a - hi
//   (split_tf32) and each product taken as lo·hi + hi·lo + hi·hi with
//   float32 sums (mma.sync m16n8k8, under 3 x 2^-20 relative): three TF32
//   products for one, so 495 / 3 TFLOP/s is its ceiling. wgmma takes TF32 B operands only
//   K-major from shared memory, and V in the (S, H, D) layout is MN-major
//   for P V, so the body is mma.sync: 4 warps of 16 query rows a block;
//   K and V tiles through a cp.async ring (two stages of 64 rows; one of
//   32 at D 256, for the shared memory) as float32 and split as each warp
//   reads its fragments; Q loaded once and split into hi and lo tiles in
//   shared memory. A k8 step's index t is taken as column 2t and t + 4 as
//   2t + 1 in both operands (a sum is over all eight either way), so Q's
//   and K's fragments are float2 reads and P is split in registers as it
//   lies in the score fragments (the accumulator layout); V is read rows
//   2t and 2t + 1 at column g. Rows are padded (Q and K D + 8, V D + 4
//   floats) so each fragment read hits 32 banks. A k8 step of S = Q K^T
//   sums its three products into a zeroed fragment that is added to the
//   scores with a float32 add: the tensor cores' accumulation rounds
//   toward zero, and D / 8 x 3 such sums into one score of ~50 moved the
//   log-sum-exp by 1e-5 (its bound) at D 256; P V's sums (P <= 1, the
//   output divided by l) keep the tensor cores' accumulation. Its issue
//   slots go to the splits (two instructions an operand value a warp)
//   as much as to the products: 768 mma.sync and ~550 splits a warp per
//   64-row tile at D 128; with cvt.rna for the splits they outweighed the
//   products, hence the truncating split (two instructions a value).
// - float32 otherwise, and bfloat16 at other head dims or on rows TMA
//   cannot address: float32 FMAs on the
//   CUDA cores (flash_kernel): 256 threads, each holding 4 query rows'
//   statistics and a 4 x ceil(D/16) slice of the accumulator in registers;
//   the Q tile (pre-scaled), the K and V tiles and the probabilities staged
//   in shared memory as float32; a thread computes a 4 x 4 block of scores
//   per tile (rows 4 ty.., columns tx + 16 j), so the K rows read by the 16
//   column threads sit D + 1 words apart and hit 16 different banks. It is
//   bound by the CUDA cores' issue rate and shared-memory loads. Head dims
//   up to 256 take it: at D 256 the staged tiles are 214.5 KB of shared
//   memory (one block an SM, under the H100's 227 KB opt-in, which the
//   launch raises) and each thread holds 4 x 16 accumulators.
// Each body masks ragged S itself (rows >= S are not written, columns >= S
// score -inf), so nothing is padded.
//
// Head dim 256 on the Hopper body (Tile<256, 1>): a stage of 128 kv rows
// would be 128 KB of K and V, so its stages hold 64 rows (BK 64), and one
// consumer warpgroup of 64 query rows computes with three stages in the
// ring (230,456 bytes, as the D 128 body's largest instance). S = Q K^T is
// 16 k16 steps of m64n64k16 over Q's and K's four boxes; O += P V two
// m64n128k16 products a k16 step, over V's boxes 0-1 and 2-3. The consumer
// holds the 64 x 256 float32 O (128 registers a thread) beside S (32) and
// P (16): 198 registers, which a 256-thread block has. Two consumer
// warpgroups (two stages) would get 168 registers a thread from a
// 384-thread block: that layout spilled, setmaxnreg moving the producer's
// registers to them notwithstanding, and ran slower than this one at
// gemma_2b's heads at every S tried (PERF.md).
//
// Sliding window (window > 0): a block's kv loop starts at the tile that
// holds column q0 - W + 1, its first row's first key, so the tiles wholly
// below the window are neither loaded nor multiplied; at S 8,192 with W
// 4,096 that halves the work of the causal loop. The tiles crossing the
// window's lower edge test the mask (col <= row - W scores -inf) beside
// those crossing the diagonal or the end of S. A row is never wholly
// masked: its diagonal is inside its window. In the Hopper body the
// producer's TMA loop and the consumers' loop both run over the block's
// tiles t_first .. ntiles - 1, and each stage index and mbarrier phase is
// counted from the loop's own iteration (t - t_first), not from the tile
// index, so the ring starts at stage 0, phase 0, wherever the window
// starts; a warpgroup whose rows lie wholly above a tile of the block's
// range (causal) or wholly past its window only releases that tile.
//
// The log-sum-exp of each row's scaled scores, lse = m + log(l) in float32
// (B, Hq, S), is written when the caller passes an lse pointer (the
// training path's recompute backward reads it, as the reference's
// _flash_fwd_scan returns it); serving passes null and nothing more is
// written. Each body writes it once a row, from the row's running max and
// sum after their last reduction: in the CUDA-core body the first of the
// row's 16 threads, in the Hopper and float32 tensor-core bodies the first
// lane of the row's quad (their m is in the log2 domain: lse = m ln 2 +
// log l). The Hopper
// body is compiled with and without the store (its LSE parameter), so the
// serving instance is the code it was before lse existed.
//
// Tile plan of the Hopper body at D 64 and 128: kv tiles of 128 rows a
// stage, and BQ query rows a block, 64 per consumer warpgroup (D 256: kv
// tiles of 64 rows, blocks of 64 rows). The wrapper's block_rows() takes
// 64-row blocks while all of them run at once, one an SM (B Hq ceil(S /
// 64) <= 132), else 128-row blocks. chip_smoke.py's "flash tile plans"
// phase times both at qwen3_1_7b's heads (B 1, 16/8 x 128, causal;
// CUDA-graph replays on an NVIDIA H100 80GB HBM3 at 700 W), e.g. at S 128:
// BQ 64 0.0057 ms, BQ 128 0.0079; S 512: 0.0102, 0.0142; S 768: 0.0189,
// 0.0182; S 1,024: 0.0268, 0.0221 (PERF.md keeps the readings).
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
constexpr int MAX_D = 256;

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
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    Strides qs, Strides ks, Strides vs, Strides os, int seq, int rep, int d,
    float scale, int causal, int window) {
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
  // with a window, from the tile holding the block's first key q0 - W + 1
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
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
        if (col >= seq || (causal && col > row) ||
            (window > 0 && col <= row - window))
          s[i][j] = -INFINITY;
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
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * gridDim.y + h) * seq + row] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
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

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_ss0_n64(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "n"(0));
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
// earlier instruction that defined D's registers is an input of the pipe;
// N: the kv rows of a stage (128, or 64 at head dim 256)
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         bool first) {
  if constexpr (N == 64) {
    if (first) wgmma_ss0_n64(d, da, db);
    else wgmma_ss_n64(d, da, db);
  } else {
    if (first) wgmma_ss0_n128(d, da, db);
    else wgmma_ss_n128(d, da, db);
  }
}
// O (64 x D) += P (64 x 16, registers) V (16 rows of a stage from v_addr):
// V's 64-wide boxes lie BK x 128 bytes apart; at D 256 two n128 products,
// over boxes 0-1 and 2-3 (O's columns 128.. are its registers 64..)
template <int D, int BK>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint32_t v_addr) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, sw128_desc(v_addr, BK * 128, 1024));
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, sw128_desc(v_addr, BK * 128, 1024));
  } else {
    static_assert(D == 256, "head dims 64, 128 and 256");
    wgmma_rs_n128(d, a, sw128_desc(v_addr, BK * 128, 1024));
    wgmma_rs_n128(d + 64, a,
                  sw128_desc(v_addr + 2 * BK * 128, BK * 128, 1024));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D head dim (64, 128 or 256), NWG consumer warpgroups of 64 query rows
// (one at D 256); one more warpgroup produces. kv tiles are 128 rows at D
// 64 and 128, 64 rows at D 256 (a 128-row stage of K and V would be 128 KB
// there).
template <int D, int NWG>
struct Tile {
  static constexpr int BQ = 64 * NWG;
  static constexpr int BK = D == 256 ? 64 : 128;    // kv rows per stage
  static constexpr int BOXES = D / 64;              // 64-wide boxes per row
  // three stages in the ring, so the next two tiles load while one is
  // computed (230,456 bytes at most: BQ 128 at D 128, BQ 64 at D 256)
  static constexpr int STAGES = 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;       // one of K, V per stage
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
  static constexpr int THREADS = 128 * (NWG + 1);
  static_assert(SMEM <= 232448, "more shared memory than an H100 block has");
};

template <int D, int NWG, bool LSE>
__global__ void __launch_bounds__(Tile<D, NWG>::THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, Strides os, int seq,
                       int rep, float scale_log2, int causal, int window) {
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
  // the block's tiles are t_first .. ntiles - 1: with a window, from the
  // one holding its first key q0 - W + 1
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
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
      // stage and phase from the iteration i, not the tile t
      for (int t = t_first; t < ntiles; ++t) {
        const int i = t - t_first, s = i % T::STAGES;
        mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
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
        wgmma_ss<BK>(
            sc, sw128_desc(q_addr + (kk / 4) * T::BQ * 128 + off, 16, 1024),
            sw128_desc(k_addr + (kk / 4) * BK * 128 + off, 16, 1024),
            kk == 0);
      }
      wgmma_commit();
    };
    // O += P V for stage s: V's k16 rows are 16 x 128 bytes apart, its
    // 64-wide boxes BK x 128 bytes apart
    auto issue_pv = [&](int s) {
      const uint32_t v_addr =
          smem_u32(kvs + s * 2 * T::KV_BYTES) + T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<D, BK>(acc, pa[kk], v_addr + kk * 16 * 128);
      wgmma_commit();
    };
    // the online softmax of tile k0: sc becomes P (float32), with corr
    // and l updated
    auto softmax = [&](int k0) {
      // log2-domain scores; sc[4 j + i]: row i < 2 ? r0 : r1, column
      // k0 + 8 j + 2 tig + (i & 1). Only tiles crossing my rows' diagonal,
      // the end of S or my rows' window's lower edge test the mask.
      float mx[2] = {-INFINITY, -INFINITY};
      if ((causal && k0 + BK - 1 > first) || k0 + BK > seq ||
          (window > 0 && k0 <= last - window)) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int row = (e & 2) ? r1 : r0;
          const int col = k0 + 8 * (e / 4) + 2 * tig + (e & 1);
          float x = sc[e] * scale_log2;
          if (col >= seq || (causal && col > row) ||
              (window > 0 && col <= row - window))
            x = -INFINITY;
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
    // Tiles wholly above my rows (causal) come last, tiles wholly below
    // my rows' window (every column <= first - W) first: I only release
    // them. Stage and phase count the iteration, as the producer's do.
    mbar_wait(qbar, 0);
    for (int t = t_first; t < ntiles; ++t) {
      const int i = t - t_first, s = i % T::STAGES;
      mbar_wait(&full[s], (i / T::STAGES) & 1);
      if (!(causal && t * BK > last) &&
          !(window > 0 && t * BK + BK - 1 <= first - window)) {
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
    // m and l are the same in the row's four lanes now: the first writes.
    // A compile-time switch, so the serving instance (LSE false) keeps m
    // dead after the last tile, as before lse existed: kept live, it cost
    // the D 128 body 2-7% at S >= 512 (chip_smoke.py's flash phases, parent
    // against change on one H100)
    if constexpr (LSE) {
      if (tig == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int row = j ? r1 : r0;
          if (row < seq)
            lse[((size_t)b * gridDim.y + h) * seq + row] =
                m[j] * 0.69314718055994531f + logf(fmaxf(l[j], 1e-30f));
        }
      }
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

template <int D, int NWG, bool LSE>
int launch_wgmma(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                 Strides qs, Strides ks, Strides vs, Strides os, int batch,
                 int seq, int hq, int hkv, float scale, int causal,
                 int window, cudaStream_t stream) {
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
        flash_wgmma_kernel<D, NWG, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const dim3 grid((seq + T::BQ - 1) / T::BQ, hq, batch);
  flash_wgmma_kernel<D, NWG, LSE><<<grid, T::THREADS, T::SMEM, stream>>>(
      qm, km, vm, o, lse, os, seq, hq / hkv, scale * 1.4426950408889634f,
      causal, window);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, T* o, float* lse,
              Strides qs, Strides ks, Strides vs, Strides os, int batch,
              int seq, int hq, int hkv, int d, float scale, int causal,
              int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + BQ - 1) / BQ, hq, batch);
  flash_kernel<T, NC><<<grid, NT, smem, stream>>>(
      q, k, v, o, lse, qs, ks, vs, os, seq, hq / hkv, d, scale, causal,
      window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* lse,
           const long long* st, int batch, int seq, int hq, int hkv, int d,
           float scale, int causal, int window, void* stream) {
  if (batch <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      d <= 0 || d % 8 || d > MAX_D || batch > 65535 || hq > 65535 ||
      window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(NC)                                                    \
  case NC:                                                                \
    return launch_nc<T, NC>(q, k, v, o, lse, qs, ks, vs, os, batch, seq, \
                            hq, hkv, d, scale, causal, window, s);
  switch ((d + 15) / 16) {
    FLASH_CASE(1)
    FLASH_CASE(2)
    FLASH_CASE(3)
    FLASH_CASE(4)
    FLASH_CASE(5)
    FLASH_CASE(6)
    FLASH_CASE(7)
    FLASH_CASE(8)
    FLASH_CASE(9)
    FLASH_CASE(10)
    FLASH_CASE(11)
    FLASH_CASE(12)
    FLASH_CASE(13)
    FLASH_CASE(14)
    FLASH_CASE(15)
    FLASH_CASE(16)
  }
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// ---- float32 on the tensor cores: split TF32, mma.sync ------------------

// a = hi + lo: hi = a with the 13 low mantissa bits cleared (TF32 by
// truncation), lo = a - hi (exact, below 2^-10 |a|), passed as it is: the
// tensor cores read a TF32 operand's sign, exponent and top 10 mantissa
// bits, so lo enters truncated too, within 2^-20 |a| of its value. One
// LOP3 and one FADD a value; cvt.rna.tf32.f32 for each of the two cost
// ~10 instructions, and the splits outweighed the products
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a b (the accumulator's input zero)
__device__ __forceinline__ void mma_tf32_zero(float* c, const uint32_t* a,
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// c += a b in three TF32 products, the small terms first: lo hi + hi lo +
// hi hi (lo lo, ~2^-22 of a b, is left out); with fresh, c = a b
template <bool FRESH>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  if constexpr (FRESH) mma_tf32_zero(c, al, bh0, bh1);
  else mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// 16 bytes global -> shared without registers; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile plan of the float32 tensor-core body at head dim D: 64 query rows a
// block, 16 a warp; kv tiles of BK rows in a ring of STAGES cp.async
// stages. Rows in shared memory are padded so that a warp's fragment reads
// hit 32 banks: Q (hi and lo) and K rows D + 8 floats apart (float2 reads
// of 8 rows at one column pair), V rows D + 4 apart (rows 2t and 2t + 1
// at column g). D 256 keeps one stage of 32 rows (202,240 bytes).
template <int D>
struct TileF {
  static constexpr int BQ = 64;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int STAGES = D == 256 ? 1 : 2;
  static constexpr int LDQ = D + 8;
  static constexpr int LDV = D + 4;
  static constexpr int THREADS = 128;
  static constexpr int STAGE_FLOATS = BK * (LDQ + LDV);
  static constexpr int SMEM = 4 * (2 * BQ * LDQ + STAGES * STAGE_FLOATS);
  static_assert(SMEM <= 232448, "more shared memory than an H100 block has");
};

template <int D>
__global__ void __launch_bounds__(TileF<D>::THREADS) flash_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, Strides qs, Strides ks, Strides vs, Strides os,
    int seq, int rep, float scale_log2, int causal, int window) {
  using T = TileF<D>;
  constexpr int BQ = T::BQ, BK = T::BK, LDQ = T::LDQ, LDV = T::LDV;
  constexpr int NJ = BK / 8, ND = D / 8;   // n8 tiles of S and of O
  extern __shared__ float4 smem4[];
  float* qh = reinterpret_cast<float*>(smem4);   // [BQ][LDQ], tf32 bits
  float* ql = qh + BQ * LDQ;
  float* kvs = ql + BQ * LDQ;                    // stage s: K, then V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  // query tiles on the grid's y: blocks are dispatched x fastest, so the
  // heaviest (latest, causal) tiles of every head go out in the first wave
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int h = blockIdx.x, b = blockIdx.z, hk = h / rep;
  const int q0 = qt * BQ;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;
  const int kv_end = causal ? min(seq, q0 + BQ) : seq;
  const int ntiles = (kv_end + BK - 1) / BK;
  // with a window, from the tile holding the block's first key q0 - W + 1
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  // K and V of tile tt into stage st, 16 bytes a copy, rows past S zeros
  auto load = [&](int tt, int st) {
    float* ksm = kvs + st * T::STAGE_FLOATS;
    float* vsm = ksm + BK * LDQ;
    const int k0 = tt * BK;
    for (int idx = tid; idx < BK * (D / 4); idx += T::THREADS) {
      const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
      const bool in = k0 + r < seq;
      const long long row = in ? k0 + r : 0;
      cp_async16(ksm + r * LDQ + c, kb + row * ks.s + c, in);
      cp_async16(vsm + r * LDV + c, vb + row * vs.s + c, in);
    }
  };
#pragma unroll
  for (int i = 0; i < T::STAGES - 1; ++i) {
    if (t_first + i < ntiles) load(t_first + i, i);
    cp_async_commit();
  }
  // Q once, split into hi and lo tiles (rows past S zeros)
  for (int idx = tid; idx < BQ * (D / 4); idx += T::THREADS) {
    const int r = idx / (D / 4), c = (idx % (D / 4)) * 4;
    const int row = q0 + r;
    const float4 x = row < seq
        ? *reinterpret_cast<const float4*>(qb + (long long)row * qs.s + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(qh + r * LDQ + c) = hi;
    *reinterpret_cast<uint4*>(ql + r * LDQ + c) = lo;
  }

  const int first = q0 + warp * 16, last = first + 15;
  const int r0 = first + g, r1 = r0 + 8;            // my rows
  const float* qhw = qh + (warp * 16 + g) * LDQ;   // my rows' Q
  const float* qlw = ql + (warp * 16 + g) * LDQ;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int tt = t_first; tt < ntiles; ++tt) {
    const int i = tt - t_first;
    // the stage of tile tt + STAGES - 1 held tile tt - 1, which every
    // warp released at the barrier that ended the last iteration
    if (tt + T::STAGES - 1 < ntiles)
      load(tt + T::STAGES - 1, (i + T::STAGES - 1) % T::STAGES);
    cp_async_commit();
    cp_async_wait<T::STAGES - 1>();    // my copies of tile tt have landed
    __syncthreads();                   // everyone's, and Q's split
    const int k0 = tt * BK;
    // tiles wholly above my rows (causal) or wholly below my rows' window
    // are skipped
    if (!(causal && k0 > last) &&
        !(window > 0 && k0 + BK - 1 <= first - window)) {
      const float* ksm = kvs + (i % T::STAGES) * T::STAGE_FLOATS;
      const float* vsm = ksm + BK * LDQ;
      // S = Q K^T. The k8 step's index kappa = t maps to column c = 8 kk +
      // 2 t and kappa = t + 4 to c + 1, in the A and B fragments alike, so
      // each is one float2 read: a = (Q[g][c], Q[g+8][c], Q[g][c+1],
      // Q[g+8][c+1]), b = (K[8 j + g][c], K[8 j + g][c + 1])
      float sc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 8; ++kk) {
        const int c = kk * 8 + 2 * t4;
        const float2 h0 = *reinterpret_cast<const float2*>(qhw + c);
        const float2 h1 = *reinterpret_cast<const float2*>(qhw + 8 * LDQ + c);
        const float2 l0 = *reinterpret_cast<const float2*>(qlw + c);
        const float2 l1 = *reinterpret_cast<const float2*>(qlw + 8 * LDQ + c);
        const uint32_t ah[4] = {__float_as_uint(h0.x), __float_as_uint(h1.x),
                                __float_as_uint(h0.y), __float_as_uint(h1.y)};
        const uint32_t al[4] = {__float_as_uint(l0.x), __float_as_uint(l1.x),
                                __float_as_uint(l0.y), __float_as_uint(l1.y)};
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float2 kf =
              *reinterpret_cast<const float2*>(ksm + (j * 8 + g) * LDQ + c);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kf.x, bh0, bl0);
          split_tf32(kf.y, bh1, bl1);
          // the k8 step's three products into a zeroed fragment, added to
          // the scores in float32: the tensor cores' own sums round toward
          // zero, which over D / 8 x 3 sums into a score of ~50 biased the
          // scores (and lse) by ~1e-5 at D 256
          float part[4];
          mma3<true>(part, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += part[e];
        }
      }
      // the online softmax in the log2 domain; sc[j][e]: row e < 2 ? r0 :
      // r1, column k0 + 8 j + 2 t + (e & 1). Only tiles crossing my rows'
      // diagonal, the end of S or my rows' window's lower edge test the
      // mask.
      float mx[2] = {-INFINITY, -INFINITY};
      const bool edge = (causal && k0 + BK - 1 > first) || k0 + BK > seq ||
                        (window > 0 && k0 <= last - window);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale_log2;
          if (edge) {
            const int row = e < 2 ? r0 : r1;
            const int col = k0 + 8 * j + 2 * t4 + (e & 1);
            if (col >= seq || (causal && col > row) ||
                (window > 0 && col <= row - window))
              x = -INFINITY;
          }
          sc[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float base[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four threads of a row are lanes 4 g .. 4 g + 3
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        // a row with nothing valid yet keeps m = -inf and p = 0
        base[r] = m_new == -INFINITY ? 0.f : m_new;
        corr[r] = exp2f(m[r] - base[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = exp2f(sc[j][e] - base[e >> 1]);
          l[e >> 1] += sc[j][e];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // O += P V over the tile's k8 steps j, P split as it lies in the
      // score fragments: kappa = t is kv row 8 j + 2 t, kappa = t + 4 row
      // 8 j + 2 t + 1, so a = (P[g][2t], P[g+8][2t], P[g][2t+1],
      // P[g+8][2t+1]) = sc[j][0, 2, 1, 3] and b = (V[8 j + 2 t][8 n + g],
      // V[8 j + 2 t + 1][8 n + g])
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(sc[j][0], ph[0], pl[0]);
        split_tf32(sc[j][2], ph[1], pl[1]);
        split_tf32(sc[j][1], ph[2], pl[2]);
        split_tf32(sc[j][3], ph[3], pl[3]);
        const float* vrow = vsm + (j * 8 + 2 * t4) * LDV + g;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vrow[n * 8], bh0, bl0);
          split_tf32(vrow[LDV + n * 8], bh1, bl1);
          mma3<false>(acc[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // m and l are the same in the row's four lanes now: the first writes
  if (lse != nullptr && t4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? r1 : r0;
      if (row < seq)
        lse[((size_t)b * gridDim.x + h) * seq + row] =
            m[r] * 0.69314718055994531f + logf(fmaxf(l[r], 1e-30f));
    }
  }
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? r1 : r0;
    if (row >= seq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    float* orow = ob + (long long)row * os.s + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch_tf32(const float* q, const float* k, const float* v, float* o,
                float* lse, Strides qs, Strides ks, Strides vs, Strides os,
                int batch, int seq, int hq, int hkv, float scale, int causal,
                int window, cudaStream_t stream) {
  using T = TileF<D>;
  // the shared-memory limit is raised once per device for each instance
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  static bool raised[64] = {};
  if (!raised[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tf32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (e != cudaSuccess) return (int)e;
    raised[dev] = true;
  }
  const dim3 grid(hq, (seq + T::BQ - 1) / T::BQ, batch);
  flash_tf32_kernel<D><<<grid, T::THREADS, T::SMEM, stream>>>(
      q, k, v, o, lse, qs, ks, vs, os, seq, hq / hkv,
      scale * 1.4426950408889634f, causal, window);
  return (int)cudaGetLastError();
}

// The float32 tensor-core body takes D 64, 128 or 256 and rows cp.async
// copies 16 bytes at a time: 16-byte aligned pointers, strides that are
// multiples of 4 elements.
int launch_f32_tc(const float* q, const float* k, const float* v, float* o,
                  float* lse, const long long* st, int batch, int seq,
                  int hq, int hkv, int d, float scale, int causal,
                  int window, void* stream) {
  if (batch <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      batch > 65535 || hq > 65535 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  for (int i = 0; i < 4; ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16)
      return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 12; ++i)
    if (st[i] % 4 || st[i] <= 0) return (int)cudaErrorInvalidValue;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_tf32<64>(q, k, v, o, lse, qs, ks, vs, os, batch, seq, hq,
                             hkv, scale, causal, window, s);
    case 128:
      return launch_tf32<128>(q, k, v, o, lse, qs, ks, vs, os, batch, seq,
                              hq, hkv, scale, causal, window, s);
    case 256:
      return launch_tf32<256>(q, k, v, o, lse, qs, ks, vs, os, batch, seq,
                              hq, hkv, scale, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The Hopper body takes D 64, 128 or 256 (blocks of 64 query rows at 256)
// and rows TMA can address: 16-byte aligned pointers, strides that are
// multiples of 8 elements.
int launch_hopper(const __nv_bfloat16* q, const __nv_bfloat16* k,
                  const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                  const long long* st, int batch, int seq, int hq, int hkv,
                  int d, float scale, int causal, int window, int bq,
                  void* stream) {
  if (batch <= 0 || seq <= 0 || hq <= 0 || hkv <= 0 || hq % hkv ||
      batch > 65535 || hq > 65535 || (d != 64 && d != 128 && d != 256) ||
      (bq != 64 && bq != 128) || window < 0 || (window > 0 && !causal))
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
    return lse ? launch_wgmma<D, NWG, true>(q, k, v, o, lse, qs, ks, vs,   \
                                            os, batch, seq, hq, hkv, scale, \
                                            causal, window, s)              \
               : launch_wgmma<D, NWG, false>(q, k, v, o, lse, qs, ks, vs,  \
                                             os, batch, seq, hq, hkv,      \
                                             scale, causal, window, s);
  FLASH_HOPPER_CASE(256, 1)
  FLASH_HOPPER_CASE(128, 2)
  FLASH_HOPPER_CASE(128, 1)
  FLASH_HOPPER_CASE(64, 2)
  FLASH_HOPPER_CASE(64, 1)
#undef FLASH_HOPPER_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 12 values, (batch, seq, head) for q, k, v and o, in elements.
// lse: a float32 (B, Hq, S) tensor to write each row's log-sum-exp into,
// or null (serving) for none. window: 0 (none), or W > 0 with causal.
// flash_attention_f32 and flash_attention_bf16 run the CUDA-core body;
// flash_attention_f32_tf32 the float32 tensor-core body (D 64, 128 or
// 256); flash_attention_bf16_hopper the TMA + wgmma body (D 64, 128 or
// 256) with blocks of bq query rows (64 or 128; 64 at D 256).
extern "C" int flash_attention_f32_tf32(const float* q, const float* k,
                                        const float* v, float* o, float* lse,
                                        const long long* strides, int batch,
                                        int seq, int hq, int hkv, int d,
                                        float scale, int causal, int window,
                                        void* stream) {
  return launch_f32_tc(q, k, v, o, lse, strides, batch, seq, hq, hkv, d,
                       scale, causal, window, stream);
}

extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, float* lse,
                                   const long long* strides, int batch,
                                   int seq, int hq, int hkv, int d,
                                   float scale, int causal, int window,
                                   void* stream) {
  return launch<float>(q, k, v, o, lse, strides, batch, seq, hq, hkv, d,
                       scale, causal, window, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    float* lse, const long long* strides,
                                    int batch, int seq, int hq, int hkv,
                                    int d, float scale, int causal,
                                    int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, strides, batch, seq, hq, hkv,
                               d, scale, causal, window, stream);
}

extern "C" int flash_attention_bf16_hopper(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, float* lse, const long long* strides, int batch,
    int seq, int hq, int hkv, int d, float scale, int causal, int window,
    int bq, void* stream) {
  return launch_hopper(q, k, v, o, lse, strides, batch, seq, hq, hkv, d,
                       scale, causal, window, bq, stream);
}
