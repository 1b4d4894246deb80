// Mamba-2 SSD chunked scan (ngroups = 1), for prefill.
//
// Replaces the TPU kernel repro/kernels/ssd_scan/kernel.py::_ssd_kernel
// (entry ssd_scan). For x (B, H, S, P), dt (B, H, S) after softplus,
// a (H,) negative and B, C (B, S, N), chunk by chunk of Q rows with
// seg = cumsum(dt a) inside the chunk and the (P, N) state carried across
// chunks:
//     y[i]   = sum_{j<=i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//              + exp(seg_i) C_i . state^T
//     state' = state exp(seg_last)
//              + sum_j exp(seg_last - seg_j) dt_j x_j B_j^T
// in float32, x, B, C and y in float32 or bfloat16, y rounded once. It
// also writes the final state (B, H, P, N) in float32, which the TPU
// kernel lacks and the decode cache needs (repro/models/ssm.py:
// _ssd_chunked returns it), and starts from an optional initial state.
// The ragged last chunk's rows past S have dt = 0: they leave the state
// unchanged and are not written.
//
// What bounds it on an H100: reading x, B, C and dt once and writing y and
// the final state once (about 20 MB at B 1, S 1,024, H 64, P 64, N 128,
// bf16; 37 MB in float32) against the operations the function needs, nc
// Q(Q+1) N for the causal C B^T shared by all heads plus H nc (Q(Q+1) P + 4
// Q N P) for the causal W x, C state^T and x^T B (2.7 GFLOP): ~6 us by
// bytes in bfloat16 (989 TFLOP/s would take 2.7 us). In float32 the bytes
// bound it too: ~11 us. Each product there is three bfloat16
// products (below), so its operations run at a third of the bfloat16 rate,
// 330 TFLOP/s: ~8 us.
//
// Design: the SSD's own chunk decomposition (Dao and Gu 2024, the chunked
// algorithm) in three kernels, below (ssd_chunk_kernel, ssd_state_kernel,
// ssd_output_kernel), for bfloat16 and float32 inputs alike (a template on
// the input type). C B^T is formed once per chunk for all heads; the chunk
// deltas and the outputs are one block per (chunk, head, 64 columns of P),
// nc H B blocks each (512 at S 1,024), and only the elementwise state pass
// walks the chunks in order. Every product runs on the tensor cores
// (mma.sync, bfloat16 operands, float32 sums); a float32 operand is split
// in two bfloat16 terms (hi + lo), which keeps the products within the
// float32 bounds: with bfloat16 inputs the float32 intermediates are, with
// float32 inputs x, B and C too (three products where both operands are
// split). The wrapper allocates the scratch: the scores G (nc Q Q float32
// a sequence), the chunk deltas (nc H P N float32; 16.8 MB at S 1,024),
// the entry states beside them (the same bytes, as hi and lo bfloat16) and
// the chunk decays; it stays in the 50 MB L2. The float32 entry replaces
// a CUDA-core body that walked the chunks in one block per (sequence,
// head, 32 columns of P): 0.33 ms at mamba2_1_3b's S 1,024 (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 128;      // the widest state

// ---- the SSD's chunk decomposition on the tensor cores -------------------
//
// Four steps, three kernels, per sequence b with chunks c of Q rows:
// (1) ssd_chunk_kernel, one extra block per (b, c): G_c = C_c B_c^T (its
//     16 x 16 blocks on or below the diagonal), once for all heads;
// (2) ssd_chunk_kernel, one block per (b, c, h, 64 columns of P): the chunk
//     delta D_c = sum_j w_j x_j^T B_j, w_j = exp(seg_last - seg_j) dt_j, and
//     the chunk's decay exp(seg_last);
// (3) ssd_state_kernel: state_c = exp(seg_last) state_{c-1} + D_c from the
//     initial state, elementwise over (h, P, N), writing the state entering
//     each chunk (as hi and lo bfloat16 planes) and the final state;
// (4) ssd_output_kernel, one block per (b, c, h, 64 columns of P):
//     y = exp(seg_i) C_i . state^T + (G_c o decay o dt) x_c, written once.
// Products run on mma.sync m16n8k16 (bfloat16 in, float32 sums) with
// ldmatrix. A float32 operand is split into two bfloat16 terms, hi + lo
// with lo = bf16(v - hi) (16 bits of mantissa, ~2^-17 relative, where one
// rounding would cost ~2^-9), and a product of two split operands taken as
// hi·hi + hi·lo + lo·hi into the same float32 sums (lo·lo, ~2^-18, left
// out); a split operand times an exact bfloat16 one is hi·b + lo·b. With
// bfloat16 inputs (T = __nv_bfloat16) C, B and x are exact and only the
// float32 intermediates are split (w x in (2), the entry state and the
// decayed scores in (4)); with float32 inputs (T = float) every operand is,
// C, B and x as they are staged. Tiles are staged with cp.async (16 bytes a
// copy, zeros past the edges) where the rows allow (bfloat16), or read as
// float4s and split on their way into shared memory (float32).
constexpr int CT = 256;       // threads of the chunk kernels: 8 warps
constexpr int PT = 64;        // columns of P per block
constexpr int PLD = PT + 8;   // row length of a staged P tile (bf16)

template <typename T>
struct Ssd {
  const T* x;
  const float* dt;
  const float* a;
  const T* bm;
  const T* cm;
  const float* init;
  T* y;
  float* fstate;
  float* g;              // (B, nc, Q, Q): C_c B_c^T
  float* delta;          // (B, nc, H, P, N): chunk deltas
  __nv_bfloat16* entry;  // (B, nc, H, 2, P, N): entry states, hi and lo
  float* dec;            // (B, H, nc): exp(seg_last)
  long long xsb, xsh, xss, xsp, dsb, dsh, dss, bsb, bss, bsn, csb, css, csn,
      ysb, ysh, yss, ysp;
  int nh, s, p, n, nc, np, ptiles;   // np: N rounded up to 16
  bool vec_x, vec_b, vec_c, vec_y;   // 16-byte copies (see stage)
};

// bfloat16 planes a staged operand of type T takes: 1 exact, or hi and lo
template <typename T>
struct Planes {
  static constexpr int value = sizeof(T) == 4 ? 2 : 1;
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for a, b in one or two terms: with both split (al, bl non-null)
// hi·hi + hi·lo + lo·hi, with one split its two terms, else one product
__device__ __forceinline__ void mma_terms(float* c, const uint32_t* ah,
                                          const uint32_t* al, uint32_t bh0,
                                          uint32_t bh1, const uint32_t* bl) {
  if (al != nullptr) mma_bf16(c, al, bh0, bh1);
  if (bl != nullptr) mma_bf16(c, ah, bl[0], bl[1]);
  mma_bf16(c, ah, bh0, bh1);
}

// four 8 x 8 bf16 matrices; lane l gives the address of one row
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// 16 bytes global -> shared without registers; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + lo in two bfloat16 terms
__device__ __forceinline__ void split(float v, __nv_bfloat16& hi,
                                      __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// dt of the chunk's rows (0 past S) and seg = cumsum(dt a) over the chunk,
// by warp 0; the caller syncs
template <int Q, typename T>
__device__ void chunk_seg(const Ssd<T>& A, int b, int h, int t0, float* dtv,
                          float* seg) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= 32) return;
  const float ah = A.a[h];
  constexpr int PER = (Q + 31) / 32;
  float loc[PER], sum = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = lane * PER + e, t = t0 + i;
    const float d = i < Q && t < A.s
                        ? A.dt[b * A.dsb + h * A.dsh + (long long)t * A.dss]
                        : 0.f;
    if (i < Q) dtv[i] = d;
    sum += d * ah;
    loc[e] = sum;
  }
  float incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const float excl = incl - sum;
#pragma unroll
  for (int e = 0; e < PER; ++e) {
    const int i = lane * PER + e;
    if (i < Q) seg[i] = excl + loc[e];
  }
}

// rows x cols bf16 tile (row length ld) from src[r * rs + c * cs], zeros
// outside rows_in x cols_in; with vec (cs 1, rows on 16 bytes, cols_in a
// multiple of 8) by cp.async, which the caller waits for. bfloat16 values
// are exact, so there is no lo plane: lo_off, the float32 overload's, is
// not used
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, long long rs,
                                      long long cs, int rows_in, int rows,
                                      int cols_in, int cols, bool vec,
                                      int /*lo_off*/ = 0) {
  if (vec) {
    const int c8 = cols / 8;
    for (int idx = threadIdx.x; idx < rows * c8; idx += CT) {
      const int r = idx / c8, c = (idx - r * c8) * 8;
      const bool in = r < rows_in && c < cols_in;
      cp_async16(dst + r * ld + c, in ? src + r * rs + c : src, in);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += CT) {
    const int r = idx / cols, c = idx - r * cols;
    dst[r * ld + c] = r < rows_in && c < cols_in
                          ? src[r * rs + c * cs]
                          : __float2bfloat16_rn(0.f);
  }
}

// the same tile from float32 src, each value times w[r] (w null: 1) and
// split into hi (dst) and lo (dst + lo_off) planes; with vec (cs 1, rows
// on 16 bytes, cols_in a multiple of 4) as float4 reads
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const float* src, long long rs,
                                      long long cs, int rows_in, int rows,
                                      int cols_in, int cols, bool vec,
                                      int lo_off, const float* w = nullptr) {
  if (vec) {
    const int c4 = cols / 4;
    for (int idx = threadIdx.x; idx < rows * c4; idx += CT) {
      const int r = idx / c4, c = (idx - r * c4) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < rows_in && c < cols_in)
        v = *reinterpret_cast<const float4*>(src + r * rs + c);
      const float f = w != nullptr ? w[r] : 1.f;
      __nv_bfloat16 h[4], l[4];
      split(v.x * f, h[0], l[0]);
      split(v.y * f, h[1], l[1]);
      split(v.z * f, h[2], l[2]);
      split(v.w * f, h[3], l[3]);
      *reinterpret_cast<uint2*>(dst + r * ld + c) =
          make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
      *reinterpret_cast<uint2*>(dst + lo_off + r * ld + c) =
          make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * cols; idx += CT) {
    const int r = idx / cols, c = idx - r * cols;
    const float v = r < rows_in && c < cols_in ? src[r * rs + c * cs] : 0.f;
    split(v * (w != nullptr ? w[r] : 1.f), dst[r * ld + c],
          dst[lo_off + r * ld + c]);
  }
}

template <int Q, typename T>
__global__ void __launch_bounds__(CT) ssd_chunk_kernel(Ssd<T> A) {
  constexpr bool F32 = Planes<T>::value == 2;
  extern __shared__ float4 smem4[];
  const int ldn = A.np + 8;
  // B [Q][ldn] (float32 inputs: then its lo plane)
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* bl = F32 ? bs + Q * ldn : nullptr;
  __nv_bfloat16* r2 = bs + Planes<T>::value * Q * ldn;
  const int b = blockIdx.z, c = blockIdx.y, t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows_in = min(Q, A.s - t0);
  stage(bs, ldn, A.bm + b * A.bsb + (long long)t0 * A.bss, A.bss, A.bsn,
        rows_in, Q, A.n, A.np, A.vec_b, Q * ldn);

  if (blockIdx.x == A.nh * A.ptiles) {
    // -- (1) G_c = C_c B_c^T, blocks on or below the diagonal ------------
    __nv_bfloat16* cs = r2;                                     // [Q][ldn]
    __nv_bfloat16* cl = F32 ? cs + Q * ldn : nullptr;
    stage(cs, ldn, A.cm + b * A.csb + (long long)t0 * A.css, A.css, A.csn,
          rows_in, Q, A.n, A.np, A.vec_c, Q * ldn);
    cp_async_wait();
    __syncthreads();
    if (warp >= Q / 16) return;
    float acc[Q / 8][4];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < A.np; k0 += 16) {
      const int aoff = (warp * 16 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8;
      uint32_t af[4], afl[4];
      ldsm_x4(af, cs + aoff);
      if constexpr (F32) ldsm_x4(afl, cl + aoff);
#pragma unroll
      for (int jp = 0; jp < Q / 16; ++jp) {
        if (jp > warp) break;
        const int boff = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + k0 +
                         ((lane >> 3) & 1) * 8;
        uint32_t bf[4], bfl[4];
        ldsm_x4(bf, bs + boff);
        if constexpr (F32) ldsm_x4(bfl, bl + boff);
        mma_terms(acc[2 * jp], af, F32 ? afl : nullptr, bf[0], bf[1],
                  F32 ? bfl : nullptr);
        mma_terms(acc[2 * jp + 1], af, F32 ? afl : nullptr, bf[2], bf[3],
                  F32 ? bfl + 2 : nullptr);
      }
    }
    float* g = A.g + ((long long)b * A.nc + c) * Q * Q;
    const int i0 = warp * 16 + gid;
#pragma unroll
    for (int j = 0; j < Q / 8; ++j) {
      if (j / 2 > warp) break;
      const int col = j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(g + i0 * Q + col) =
          make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(g + (i0 + 8) * Q + col) =
          make_float2(acc[j][2], acc[j][3]);
    }
    return;
  }

  // -- (2) D_c = sum_j (w_j x_j)^T B_j for 64 columns of P ----------------
  const int h = blockIdx.x / A.ptiles, p0 = (blockIdx.x % A.ptiles) * PT;
  __nv_bfloat16* xh = r2;                 // [Q][PLD]: hi of w_j x_j
  __nv_bfloat16* xl = xh + Q * PLD;       // lo
  float* dtv = reinterpret_cast<float*>(xl + Q * PLD);
  float* seg = dtv + Q;
  float* wr = seg + Q;                    // w_j
  const int cols_in = min(PT, A.p - p0);
  const long long xoff = b * A.xsb + h * A.xsh + (long long)t0 * A.xss +
                         (long long)p0 * A.xsp;
  if constexpr (!F32)   // x first, exact, into the hi plane
    stage(xh, PLD, A.x + xoff, A.xss, A.xsp, rows_in, Q, cols_in, PT,
          A.vec_x);
  chunk_seg<Q>(A, b, h, t0, dtv, seg);
  __syncthreads();
  const float last = seg[Q - 1];
  if (threadIdx.x < Q)
    wr[threadIdx.x] = expf(last - seg[threadIdx.x]) * dtv[threadIdx.x];
  if (threadIdx.x == 0 && p0 == 0)
    A.dec[((long long)b * A.nh + h) * A.nc + c] = expf(last);
  cp_async_wait();
  __syncthreads();
  if constexpr (F32) {
    // w_j x_j from float32 x, split on its way in
    stage(xh, PLD, A.x + xoff, A.xss, A.xsp, rows_in, Q, cols_in, PT,
          A.vec_x, Q * PLD, wr);
  } else {
    // w_j x_j split in place: each thread reads, then writes, its own 8
    for (int idx = threadIdx.x; idx < Q * (PT / 8); idx += CT) {
      const int i = idx / (PT / 8), pp = (idx % (PT / 8)) * 8;
      uint4 raw = *reinterpret_cast<const uint4*>(xh + i * PLD + pp);
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw);
      uint4 hi, lo;
      __nv_bfloat16* hv = reinterpret_cast<__nv_bfloat16*>(&hi);
      __nv_bfloat16* lv = reinterpret_cast<__nv_bfloat16*>(&lo);
      const float w = wr[i];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        split(__bfloat162float(xv[e]) * w, hv[e], lv[e]);
      *reinterpret_cast<uint4*>(xh + i * PLD + pp) = hi;
      *reinterpret_cast<uint4*>(xl + i * PLD + pp) = lo;
    }
  }
  __syncthreads();
  const int wm = warp & 3, wn = warp >> 2;   // P rows 16 wm, N half wn
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < Q; k0 += 16) {
    // A = (w x)^T: stored [j][p], read transposed
    const int ar = k0 + (lane & 7) + (lane >> 4) * 8;
    const int ac = wm * 16 + ((lane >> 3) & 1) * 8;
    uint32_t ahi[4], alo[4];
    ldsm_x4_t(ahi, xh + ar * PLD + ac);
    ldsm_x4_t(alo, xl + ar * PLD + ac);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int n0 = (wn * 8 + 2 * jp) * 8;
      if (n0 >= A.np) break;
      // B stored [j][n]: read transposed
      const int boff = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldn + n0 +
                       (lane >> 4) * 8;
      uint32_t bf[4], bfl[4];
      ldsm_x4_t(bf, bs + boff);
      if constexpr (F32) ldsm_x4_t(bfl, bl + boff);
      mma_terms(acc[2 * jp], ahi, alo, bf[0], bf[1], F32 ? bfl : nullptr);
      mma_terms(acc[2 * jp + 1], ahi, alo, bf[2], bf[3],
                F32 ? bfl + 2 : nullptr);
    }
  }
  // D through shared memory (over the staged tiles, once every warp is
  // done with them) for row-contiguous stores
  __syncthreads();
  const int ldd = A.np + 4;
  float* ds = reinterpret_cast<float*>(smem4);            // [PT][ldd]
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = (wn * 8 + j) * 8 + 2 * tig;
    if (col >= A.np) break;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(ds + (wm * 16 + gid + r * 8) * ldd + col) =
          make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
  }
  __syncthreads();
  float* dd = A.delta + (((long long)b * A.nc + c) * A.nh + h) * A.p * A.n +
              (long long)p0 * A.n;
  if (A.n % 4 == 0) {
    const int n4 = A.n / 4;
    for (int idx = threadIdx.x; idx < cols_in * n4; idx += CT) {
      const int r = idx / n4, c4 = (idx - r * n4) * 4;
      *reinterpret_cast<float4*>(dd + r * A.n + c4) =
          *reinterpret_cast<const float4*>(ds + r * ldd + c4);
    }
  } else {
    for (int idx = threadIdx.x; idx < cols_in * A.n; idx += CT) {
      const int r = idx / A.n, cc = idx - r * A.n;
      dd[r * A.n + cc] = ds[r * ldd + cc];
    }
  }
}

// (3) the state pass: per (b, h) element of P x N, over the chunks in
// order; V elements a thread (4 where P N allows 16-byte loads)
template <int V, typename T>
__global__ void __launch_bounds__(CT) ssd_state_kernel(Ssd<T> A) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int pn = A.p * A.n;
  const int e = (blockIdx.x * CT + threadIdx.x) * V;
  if (e >= pn) return;
  const long long bh = (long long)b * A.nh + h;
  float state[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    state[v] = A.init != nullptr ? A.init[bh * pn + e + v] : 0.f;
  const float* dec = A.dec + bh * A.nc;
  constexpr int U = 8;                  // deltas loaded ahead
  for (int c0 = 0; c0 < A.nc; c0 += U) {
    float d[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float* src =
          A.delta + (((long long)b * A.nc + c0 + u) * A.nh + h) * pn + e;
      if (c0 + u >= A.nc) {
#pragma unroll
        for (int v = 0; v < V; ++v) d[u][v] = 0.f;
      } else if constexpr (V == 4) {
        const float4 q = *reinterpret_cast<const float4*>(src);
        d[u][0] = q.x;
        d[u][1] = q.y;
        d[u][2] = q.z;
        d[u][3] = q.w;
      } else {
        d[u][0] = *src;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c0 + u >= A.nc) break;
      __nv_bfloat16* en =
          A.entry + (((long long)b * A.nc + c0 + u) * A.nh + h) * 2 * pn + e;
      __nv_bfloat16 hi[V], lo[V];
      const float dc = dec[c0 + u];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        split(state[v], hi[v], lo[v]);
        state[v] = state[v] * dc + d[u][v];
      }
      if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(en) =
            make_uint2(pack2(hi[0], hi[1]), pack2(hi[2], hi[3]));
        *reinterpret_cast<uint2*>(en + pn) =
            make_uint2(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]));
      } else {
        en[0] = hi[0];
        en[pn] = lo[0];
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) A.fstate[bh * pn + e + v] = state[v];
}

// (4), one warp's 16 rows of the chunk: y into ys (bfloat16), or straight
// into yb's rows (float32)
template <int Q, typename T>
__device__ __forceinline__ void output_rows(
    const Ssd<T>& A, int warp, int lane, const __nv_bfloat16* cs,
    const __nv_bfloat16* sh, const __nv_bfloat16* sl,
    const __nv_bfloat16* xs, __nv_bfloat16* ys, T* yb, int rows_in,
    int cols_in, const float* dtv, const float* seg, int ldn, int b, int c) {
  constexpr bool F32 = Planes<T>::value == 2;
  // float32 inputs: C's and x's lo planes follow their hi planes
  const __nv_bfloat16* cl = cs + Q * ldn;
  const __nv_bfloat16* xl = xs + Q * PLD;
  const int gid = lane >> 2, tig = lane & 3;
  const int ra = warp * 16 + gid, rb = ra + 8;   // my rows of the chunk
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const float* g = A.g + ((long long)b * A.nc + c) * Q * Q;
  const float sa = seg[ra], sb = seg[rb];
  // the scores of key block kb for my rows, loaded a block ahead
  float2 gv[4], gn[4];
  auto load_g = [&](int kb, float2* dst) {
#pragma unroll
    for (int f = 0; f < 4; ++f)
      dst[f] = *reinterpret_cast<const float2*>(
          g + ((f & 1) ? rb : ra) * Q + kb * 16 + (f >> 1) * 8 + 2 * tig);
  };
  load_g(0, gv);
  // C_i . state^T: A = C [i][n]; B = the state [p][n], read as columns
  for (int k0 = 0; k0 < A.np; k0 += 16) {
    const int aoff = (warp * 16 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8;
    uint32_t af[4], afl[4];
    ldsm_x4(af, cs + aoff);
    if constexpr (F32) ldsm_x4(afl, cl + aoff);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int off = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + k0 +
                      ((lane >> 3) & 1) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, sh + off);
      ldsm_x4(bl, sl + off);
      mma_terms(acc[2 * jp], af, F32 ? afl : nullptr, bh[0], bh[1], bl);
      mma_terms(acc[2 * jp + 1], af, F32 ? afl : nullptr, bh[2], bh[3],
                bl + 2);
    }
  }
  const float ea = expf(seg[ra]), eb = expf(seg[rb]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] *= ea;
    acc[j][1] *= ea;
    acc[j][2] *= eb;
    acc[j][3] *= eb;
  }
  // (G o decay o dt) x over the key blocks on or below my rows' diagonal;
  // the decayed scores are built in registers as hi and lo A fragments
  for (int kb = 0; kb <= warp; ++kb) {
    if (kb < warp) load_g(kb + 1, gn);
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int row = (f & 1) ? rb : ra;
      const float sr = (f & 1) ? sb : sa;
      const int col = kb * 16 + (f >> 1) * 8 + 2 * tig;
      const float w0 =
          col <= row ? gv[f].x * expf(sr - seg[col]) * dtv[col] : 0.f;
      const float w1 = col + 1 <= row
                           ? gv[f].y * expf(sr - seg[col + 1]) * dtv[col + 1]
                           : 0.f;
      __nv_bfloat16 h0, l0, h1, l1;
      split(w0, h0, l0);
      split(w1, h1, l1);
      ahi[f] = pack2(h0, h1);
      alo[f] = pack2(l0, l1);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      // x stored [j][p]: read transposed
      const int off = (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PLD +
                      jp * 16 + (lane >> 4) * 8;
      uint32_t bf[4], bfl[4];
      ldsm_x4_t(bf, xs + off);
      if constexpr (F32) ldsm_x4_t(bfl, xl + off);
      mma_terms(acc[2 * jp], ahi, alo, bf[0], bf[1], F32 ? bfl : nullptr);
      mma_terms(acc[2 * jp + 1], ahi, alo, bf[2], bf[3],
                F32 ? bfl + 2 : nullptr);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) gv[f] = gn[f];
  }
  if constexpr (F32) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? rb : ra;
      if (i >= rows_in) continue;
      T* yr = yb + i * A.yss;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int pp = j * 8 + 2 * tig;
        if (A.vec_y && pp < cols_in) {
          *reinterpret_cast<float2*>(yr + pp) =
              make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
        } else {
          if (pp < cols_in) yr[pp * A.ysp] = acc[j][2 * r];
          if (pp + 1 < cols_in) yr[(pp + 1) * A.ysp] = acc[j][2 * r + 1];
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(ys + (r ? rb : ra) * PLD + j * 8 +
                                     2 * tig) =
            pack2(__float2bfloat16_rn(acc[j][2 * r]),
                  __float2bfloat16_rn(acc[j][2 * r + 1]));
  }
}

// (4) y for one (b, c, h, 64 columns of P)
template <int Q, typename T>
__global__ void __launch_bounds__(CT) ssd_output_kernel(Ssd<T> A) {
  constexpr bool F32 = Planes<T>::value == 2;
  constexpr int NP = Planes<T>::value;
  extern __shared__ float4 smem4[];
  const int ldn = A.np + 8;
  // C [Q][ldn], the entry state's hi and lo [PT][ldn], x [Q][PLD] (C and x
  // each followed by its lo plane with float32 inputs), then y [Q][PLD]
  // for the stores (bfloat16)
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sh = cs + NP * Q * ldn;
  __nv_bfloat16* sl = sh + PT * ldn;
  __nv_bfloat16* xs = sl + PT * ldn;
  __nv_bfloat16* ys = xs + NP * Q * PLD;
  float* dtv = reinterpret_cast<float*>(ys + (F32 ? 0 : Q * PLD));
  float* seg = dtv + Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = blockIdx.x / A.ptiles, p0 = (blockIdx.x % A.ptiles) * PT;
  const int t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_in = min(Q, A.s - t0), cols_in = min(PT, A.p - p0);

  const T* csrc = A.cm + b * A.csb + (long long)t0 * A.css;
  const T* xsrc = A.x + b * A.xsb + h * A.xsh + (long long)t0 * A.xss +
                  (long long)p0 * A.xsp;
  stage(cs, ldn, csrc, A.css, A.csn, rows_in, Q, A.n, A.np, A.vec_c,
        Q * ldn);
  stage(xs, PLD, xsrc, A.xss, A.xsp, rows_in, Q, cols_in, PT, A.vec_x,
        Q * PLD);
  const long long pn = (long long)A.p * A.n;
  const __nv_bfloat16* en =
      A.entry + (((long long)b * A.nc + c) * A.nh + h) * 2 * pn +
      (long long)p0 * A.n;
  const bool vec_e = A.n % 8 == 0;
  stage(sh, ldn, en, A.n, 1, cols_in, PT, A.n, A.np, vec_e);
  stage(sl, ldn, en + pn, A.n, 1, cols_in, PT, A.n, A.np, vec_e);
  chunk_seg<Q>(A, b, h, t0, dtv, seg);
  cp_async_wait();
  __syncthreads();
  T* yb = A.y + b * A.ysb + h * A.ysh + (long long)t0 * A.yss +
          (long long)p0 * A.ysp;
  if (warp < Q / 16)
    output_rows<Q>(A, warp, lane, cs, sh, sl, xs, ys, yb, rows_in, cols_in,
                   dtv, seg, ldn, b, c);
  if constexpr (!F32) {
    __syncthreads();
    // y rows of 64 columns, 16 bytes a store where the layout allows
    if (A.vec_y && cols_in % 8 == 0) {
      for (int idx = threadIdx.x; idx < rows_in * (PT / 8); idx += CT) {
        const int i = idx / (PT / 8), pp = (idx % (PT / 8)) * 8;
        if (pp < cols_in)
          *reinterpret_cast<uint4*>(yb + i * A.yss + pp) =
              *reinterpret_cast<const uint4*>(ys + i * PLD + pp);
      }
    } else {
      for (int idx = threadIdx.x; idx < rows_in * PT; idx += CT) {
        const int i = idx / PT, pp = idx - i * PT;
        if (pp < cols_in) yb[i * A.yss + pp * A.ysp] = ys[i * PLD + pp];
      }
    }
  }
}

// shared memory of the chunk kernel: the G role stages B and C, the delta
// role B, w x's hi and lo and three Q-vectors, then the delta tile; each
// of B and C twice with float32 inputs (hi and lo)
size_t chunk_smem(int q, int np, int planes) {
  const size_t ldn = np + 8;
  const size_t g_role = 2 * planes * q * ldn * 2;
  const size_t d_role = planes * q * ldn * 2 + 2 * q * PLD * 2 + 3 * q * 4;
  const size_t d_out = PT * (np + 4) * 4;   // the delta tile, staged last
  const size_t most = g_role > d_role ? g_role : d_role;
  return most > d_out ? most : d_out;
}

size_t output_smem(int q, int np, int planes) {
  const size_t ldn = np + 8;
  const size_t y_tile = planes == 1 ? q * PLD : 0;
  return (planes * q * ldn + 2 * PT * ldn + planes * q * PLD + y_tile) * 2 +
         2 * q * 4;
}

template <int Q, typename T>
int launch_chunked(Ssd<T> A, int batch, cudaStream_t stream) {
  constexpr int NP = Planes<T>::value;
  if (A.nc > 0) {
    const size_t sm2 = chunk_smem(Q, A.np, NP), sm4 = output_smem(Q, A.np, NP);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<Q, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm2);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_output_kernel<Q, T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sm4);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_kernel<Q, T><<<dim3(A.nh * A.ptiles + 1, A.nc, batch), CT, sm2,
                             stream>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int pn = A.p * A.n;
  if (pn % 4 == 0)
    ssd_state_kernel<4, T><<<dim3((pn / 4 + CT - 1) / CT, A.nh, batch), CT,
                             0, stream>>>(A);
  else
    ssd_state_kernel<1, T><<<dim3((pn + CT - 1) / CT, A.nh, batch), CT, 0,
                             stream>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || A.nc == 0) return (int)err;
  ssd_output_kernel<Q, T><<<dim3(A.nc * A.ptiles, A.nh, batch), CT,
                            output_smem(Q, A.np, NP), stream>>>(A);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const T* bm,
           const T* cm, const float* init, T* y, float* fstate,
           float* scratch, const long long* sd, int batch, int nh, int s,
           int p, int n, int chunk, void* stream) {
  if (batch <= 0 || nh <= 0 || s < 0 || p <= 0 || n <= 0 || n > MAX_N ||
      batch > 65535 || nh > 65535 ||
      (chunk != 16 && chunk != 64 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  Ssd<T> A{x, dt, a, bm, cm, init, y, fstate, nullptr, nullptr, nullptr,
           nullptr, sd[0], sd[1], sd[2], sd[3], sd[4], sd[5], sd[6], sd[7],
           sd[8], sd[9], sd[10], sd[11], sd[12], sd[13], sd[14], sd[15],
           sd[16], nh, s, p, n, (s + chunk - 1) / chunk,
           (n + 15) / 16 * 16, (p + PT - 1) / PT};
  if (A.nc > 65535) return (int)cudaErrorInvalidValue;
  // 16 bytes a copy: E elements of T
  constexpr int E = 16 / sizeof(T);
  auto vec = [](const void* ptr, long long inner, long long s0, long long s1,
                long long s2, int cols) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 &&
           inner == 1 && s0 % E == 0 && s1 % E == 0 && s2 % E == 0 &&
           cols % E == 0;
  };
  A.vec_x = vec(x, A.xsp, A.xsb, A.xsh, A.xss, p);
  A.vec_b = vec(bm, A.bsn, A.bsb, A.bss, 0, n);
  A.vec_c = vec(cm, A.csn, A.csb, A.css, 0, n);
  A.vec_y = vec(y, A.ysp, A.ysb, A.ysh, A.yss, p);
  A.g = scratch;
  const long long states = (long long)batch * A.nc * nh * p * n;
  A.delta = A.g + (long long)batch * A.nc * chunk * chunk;
  A.entry = reinterpret_cast<__nv_bfloat16*>(A.delta + states);
  A.dec = A.delta + 2 * states;
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return launch_chunked<16>(A, batch, str);
    case 64:
      return launch_chunked<64>(A, batch, str);
    default:
      return launch_chunked<128>(A, batch, str);
  }
}

}  // namespace

// strides: 17 values in elements: x (batch, head, seq, p); dt (batch,
// head, seq); B (batch, seq, n); C (batch, seq, n); y (batch, head, seq,
// p). init (may be null) and fstate are contiguous (B, H, P, N) float32.
// scratch holds ssd_scan_scratch(...) float32 values (kernel.py's
// scratch_size), for either entry.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* bm, const float* cm,
                            const float* init, float* y, float* fstate,
                            float* scratch, const long long* strides,
                            int batch, int nh, int s, int p, int n,
                            int chunk, void* stream) {
  return launch<float>(x, dt, a, bm, cm, init, y, fstate, scratch, strides,
                       batch, nh, s, p, n, chunk, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* a, const __nv_bfloat16* bm,
                             const __nv_bfloat16* cm, const float* init,
                             __nv_bfloat16* y, float* fstate, float* scratch,
                             const long long* strides, int batch, int nh,
                             int s, int p, int n, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, init, y, fstate, scratch,
                               strides, batch, nh, s, p, n, chunk, stream);
}
