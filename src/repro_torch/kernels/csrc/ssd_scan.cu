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
// bf16) against the operations the function needs, nc Q(Q+1) N for the
// causal C B^T shared by all heads plus H nc (Q(Q+1) P + 4 Q N P) for the
// causal W x, C state^T and x^T B (2.7 GFLOP): ~6 us by bytes.
//
// Two bodies, chosen by x's type:
// - bfloat16 (the model's prefill): the SSD's own chunk decomposition
//   (Dao and Gu 2024, the chunked algorithm) in three kernels, below
//   (ssd_chunk_kernel, ssd_state_kernel, ssd_output_kernel). C B^T is
//   formed once per chunk for all heads; the chunk deltas and the outputs
//   are one block per (chunk, head, 64 columns of P), nc H B blocks each
//   (512 at S 1,024), and only the elementwise state pass walks the
//   chunks in order. Every product runs on the tensor cores (mma.sync,
//   bfloat16 operands, float32 sums); float32 operands are split in two
//   bfloat16 terms (hi + lo), which keeps the products within the float32
//   bounds. The wrapper allocates the scratch: the scores G (nc Q Q
//   float32 a sequence), the chunk deltas (nc H P N float32; 16.8 MB at
//   S 1,024), the entry states beside them (the same bytes, as hi and lo
//   bfloat16) and the chunk decays; it stays in the 50 MB L2.
// - float32: one block of 256 threads (16 x 16) per (sequence, head, 32
//   columns of P) walks the chunks itself, holding its (32, N) slice of
//   the state in registers (a copy in shared memory feeds the off-diagonal
//   product), with float32 FMAs on the CUDA cores from shared memory
//   (ssd_kernel). The tensor-core body reads bfloat16 x, B and C; on
//   float32 inputs they would need hi/lo splits too, which is untried
//   against the 1e-4 bound (PERF.md, open questions). Per chunk: the chunk's C, B, x and dt staged in
//   shared memory as float32 (rows past S as zeros); warp 0 scans seg;
//   then (1) the scores C B^T, only their lower 16 x 16 blocks, in
//   registers, with exp(seg_i) C state^T beside them; (2) the decayed,
//   masked scores W (Q x Q) over C's buffer; (3) y += W x, written out;
//   (4) the state update x^T (w B) in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // 16 x 16 threads
constexpr int TD = 16;
constexpr int MAX_N = 128;      // state width: 16 lanes x 8
constexpr int PB = 32;          // columns of P per block: 16 lanes x 2
constexpr int RN = MAX_N / TD;
constexpr int RP = PB / TD;

struct Layout {                 // offsets in floats into shared memory
  int ldn, ldw, c_w, b, x, st, seg, dtv, eseg, wst, total;
};

__host__ __device__ inline Layout layout(int q, int n) {
  Layout l;
  l.ldn = n | 1;                      // odd: B rows read down a column
  l.ldw = q % 32 == 0 ? q + TD : q;   // 16 mod 32: two W rows per warp
  const int cw = q * l.ldn > q * l.ldw ? q * l.ldn : q * l.ldw;
  l.c_w = 0;                          // C (Q x ldn), then W (Q x ldw)
  l.b = cw;                           // B (Q x ldn)
  l.x = l.b + q * l.ldn;              // x (Q x PB)
  l.st = l.x + q * PB;                // state (PB x ldn)
  l.seg = l.st + PB * l.ldn;
  l.dtv = l.seg + q;
  l.eseg = l.dtv + q;
  l.wst = l.eseg + q;
  l.total = l.wst + q;
  return l;
}

// RQ = Q / 16 row blocks of a chunk
template <int RQ>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, const float* __restrict__ init,
    float* __restrict__ y, float* __restrict__ fstate, long long xsb,
    long long xsh, long long xss, long long xsp, long long dsb,
    long long dsh, long long dss, long long bsb, long long bss,
    long long bsn, long long csb, long long css, long long csn,
    long long ysb, long long ysh, long long yss, long long ysp, int nh,
    int s, int p, int n) {
  constexpr int Q = RQ * TD;
  constexpr int NTRI = RQ * (RQ + 1) / 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = layout(Q, n);
  float* cs = sm + L.c_w;
  float* ws = sm + L.c_w;
  float* bs = sm + L.b;
  float* xs = sm + L.x;
  float* ss = sm + L.st;
  float* seg = sm + L.seg;
  float* dtv = sm + L.dtv;
  float* eseg = sm + L.eseg;
  float* wst = sm + L.wst;

  const int tid = threadIdx.x, tx = tid % TD, ty = tid / TD;
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PB, h = blockIdx.y, b = blockIdx.z;
  const float ah = a[h];
  const long long sbase = ((long long)b * nh + h) * p;   // state row (b, h, 0)

  // the state slice: rows p0 + ty + 16 r, columns tx + 16 c
  float st[RP][RN];
#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int pp = p0 + ty + TD * r, nn = tx + TD * c;
      st[r][c] = init != nullptr && pp < p && nn < n
                     ? init[(sbase + pp) * n + nn] : 0.f;
      if (nn < n) ss[(ty + TD * r) * L.ldn + nn] = st[r][c];
    }

  const int nchunks = (s + Q - 1) / Q;
  for (int k = 0; k < nchunks; ++k) {
    const int t0 = k * Q;
    // -- stage the chunk (rows past S as zeros) ------------------------------
    for (int idx = tid; idx < Q * n; idx += NT) {
      const int i = idx / n, nn = idx - i * n, t = t0 + i;
      const bool in = t < s;
      cs[i * L.ldn + nn] = in ? cm[b * csb + t * css + nn * csn] : 0.f;
      bs[i * L.ldn + nn] = in ? bm[b * bsb + t * bss + nn * bsn] : 0.f;
    }
    for (int idx = tid; idx < Q * PB; idx += NT) {
      const int i = idx / PB, pp = idx - i * PB, t = t0 + i;
      xs[idx] = t < s && p0 + pp < p
                    ? x[b * xsb + h * xsh + t * xss + (p0 + pp) * xsp]
                    : 0.f;
    }
    for (int i = tid; i < Q; i += NT)
      dtv[i] = t0 + i < s ? dt[b * dsb + h * dsh + (t0 + i) * dss] : 0.f;
    __syncthreads();

    // -- seg = cumsum(dt a) over the chunk (warp 0) --------------------------
    if (warp == 0) {
      constexpr int PER = (Q + 31) / 32;
      float loc[PER], sum = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        const int i = lane * PER + e;
        sum += i < Q ? dtv[i] * ah : 0.f;
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
    __syncthreads();
    const float last = seg[Q - 1];
    for (int i = tid; i < Q; i += NT) {
      eseg[i] = expf(seg[i]);
      wst[i] = expf(last - seg[i]) * dtv[i];
    }

    // -- (1) scores C B^T (lower blocks) and C state^T ----------------------
    float sc[NTRI], acc[RQ][RP];
#pragma unroll
    for (int e = 0; e < NTRI; ++e) sc[e] = 0.f;
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < RP; ++c) acc[r][c] = 0.f;
    for (int nn = 0; nn < n; ++nn) {
      float av[RQ], bv[RQ], sv[RP];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        av[r] = cs[(ty + TD * r) * L.ldn + nn];
        bv[r] = bs[(tx + TD * r) * L.ldn + nn];
      }
#pragma unroll
      for (int c = 0; c < RP; ++c) sv[c] = ss[(tx + TD * c) * L.ldn + nn];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
#pragma unroll
        for (int c = 0; c <= r; ++c)
          sc[r * (r + 1) / 2 + c] =
              fmaf(av[r], bv[c], sc[r * (r + 1) / 2 + c]);
#pragma unroll
        for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(av[r], sv[c], acc[r][c]);
      }
    }
    __syncthreads();              // C is read; W overwrites it

    // -- (2) W = scores exp(seg_i - seg_j) dt_j, j <= i ----------------------
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int i = ty + TD * r;
#pragma unroll
      for (int c = 0; c <= r; ++c) {
        const int j = tx + TD * c;
        ws[i * L.ldw + j] = j <= i ? sc[r * (r + 1) / 2 + c] *
                                         expf(seg[i] - seg[j]) * dtv[j]
                                   : 0.f;
      }
#pragma unroll
      for (int c = 0; c < RP; ++c) acc[r][c] *= eseg[i];
    }
    __syncthreads();

    // -- (3) y = exp(seg) C state^T + W x -----------------------------------
#pragma unroll
    for (int jb = 0; jb < RQ; ++jb) {
      for (int jj = 0; jj < TD; ++jj) {
        const int j = jb * TD + jj;
        float xv[RP];
#pragma unroll
        for (int c = 0; c < RP; ++c) xv[c] = xs[j * PB + tx + TD * c];
#pragma unroll
        for (int r = jb; r < RQ; ++r) {
          const float wv = ws[(ty + TD * r) * L.ldw + j];
#pragma unroll
          for (int c = 0; c < RP; ++c) acc[r][c] = fmaf(wv, xv[c], acc[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RQ; ++r) {
      const int t = t0 + ty + TD * r;
#pragma unroll
      for (int c = 0; c < RP; ++c) {
        const int pp = p0 + tx + TD * c;
        if (t < s && pp < p)
          y[b * ysb + h * ysh + t * yss + pp * ysp] = acc[r][c];
      }
    }

    // -- (4) state = state exp(seg_last) + sum_j x_j^T (wst_j B_j) ----------
    const float dec = expf(last);
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c) st[r][c] *= dec;
    for (int j = 0; j < Q; ++j) {
      const float wj = wst[j];
      float xv[RP], bv[RN];
#pragma unroll
      for (int r = 0; r < RP; ++r) xv[r] = xs[j * PB + ty + TD * r] * wj;
#pragma unroll
      for (int c = 0; c < RN; ++c)
        bv[c] = tx + TD * c < n ? bs[j * L.ldn + tx + TD * c] : 0.f;
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int c = 0; c < RN; ++c) st[r][c] = fmaf(xv[r], bv[c], st[r][c]);
    }
    // the state copy was last read in (1), before two barriers
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int c = 0; c < RN; ++c)
        if (tx + TD * c < n)
          ss[(ty + TD * r) * L.ldn + tx + TD * c] = st[r][c];
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < RP; ++r)
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int pp = p0 + ty + TD * r, nn = tx + TD * c;
      if (pp < p && nn < n) fstate[(sbase + pp) * n + nn] = st[r][c];
    }
}

template <int RQ>
int launch_q(const float* x, const float* dt, const float* a, const float* bm,
             const float* cm, const float* init, float* y, float* fstate,
             const long long* st, int batch, int nh, int s, int p, int n,
             cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)layout(RQ * TD, n).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p + PB - 1) / PB, nh, batch);
  ssd_kernel<RQ><<<grid, NT, smem, stream>>>(
      x, dt, a, bm, cm, init, y, fstate, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], st[15], st[16], nh, s, p, n);
  return (int)cudaGetLastError();
}

// ---- bfloat16: the SSD's chunk decomposition on the tensor cores ---------
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
// ldmatrix. C, B and x are bfloat16 and exact as operands; the float32
// operands (w x in (2), the entry state and the decayed scores in (4)) are
// split into two bfloat16 terms, hi + lo with lo = bf16(v - hi), and both
// multiplied into the same float32 sums: 16 bits of mantissa, ~2^-17
// relative, where one rounding would cost ~2^-9. Tiles are staged with
// cp.async (16 bytes a copy, zeros past the edges) where the rows allow.
constexpr int CT = 256;       // threads of the chunk kernels: 8 warps
constexpr int PT = 64;        // columns of P per block
constexpr int PLD = PT + 8;   // row length of a staged P tile (bf16)

struct Ssd {
  const __nv_bfloat16* x;
  const float* dt;
  const float* a;
  const __nv_bfloat16* bm;
  const __nv_bfloat16* cm;
  const float* init;
  __nv_bfloat16* y;
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
template <int Q>
__device__ void chunk_seg(const Ssd& A, int b, int h, int t0, float* dtv,
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
// multiple of 8) by cp.async, which the caller waits for
__device__ __forceinline__ void stage(__nv_bfloat16* dst, int ld,
                                      const __nv_bfloat16* src, long long rs,
                                      long long cs, int rows_in, int rows,
                                      int cols_in, int cols, bool vec) {
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

template <int Q>
__global__ void __launch_bounds__(CT) ssd_chunk_kernel(Ssd A) {
  extern __shared__ float4 smem4[];
  const int ldn = A.np + 8;
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Q][ldn]
  __nv_bfloat16* r2 = bs + Q * ldn;
  const int b = blockIdx.z, c = blockIdx.y, t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows_in = min(Q, A.s - t0);
  stage(bs, ldn, A.bm + b * A.bsb + (long long)t0 * A.bss, A.bss, A.bsn,
        rows_in, Q, A.n, A.np, A.vec_b);

  if (blockIdx.x == A.nh * A.ptiles) {
    // -- (1) G_c = C_c B_c^T, blocks on or below the diagonal ------------
    __nv_bfloat16* cs = r2;                                     // [Q][ldn]
    stage(cs, ldn, A.cm + b * A.csb + (long long)t0 * A.css, A.css, A.csn,
          rows_in, Q, A.n, A.np, A.vec_c);
    cp_async_wait();
    __syncthreads();
    if (warp >= Q / 16) return;
    float acc[Q / 8][4];
#pragma unroll
    for (int j = 0; j < Q / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < A.np; k0 += 16) {
      uint32_t af[4];
      ldsm_x4(af, cs + (warp * 16 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < Q / 16; ++jp) {
        if (jp > warp) break;
        uint32_t bf[4];
        ldsm_x4(bf, bs + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + k0 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * jp], af, bf[0], bf[1]);
        mma_bf16(acc[2 * jp + 1], af, bf[2], bf[3]);
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
  __nv_bfloat16* xh = r2;                 // [Q][PLD]: x, then hi of w_j x_j
  __nv_bfloat16* xl = xh + Q * PLD;       // lo
  float* dtv = reinterpret_cast<float*>(xl + Q * PLD);
  float* seg = dtv + Q;
  float* wr = seg + Q;                    // w_j
  const int cols_in = min(PT, A.p - p0);
  stage(xh, PLD,
        A.x + b * A.xsb + h * A.xsh + (long long)t0 * A.xss +
            (long long)p0 * A.xsp,
        A.xss, A.xsp, rows_in, Q, cols_in, PT, A.vec_x);
  chunk_seg<Q>(A, b, h, t0, dtv, seg);
  __syncthreads();
  const float last = seg[Q - 1];
  if (threadIdx.x < Q)
    wr[threadIdx.x] = expf(last - seg[threadIdx.x]) * dtv[threadIdx.x];
  if (threadIdx.x == 0 && p0 == 0)
    A.dec[((long long)b * A.nh + h) * A.nc + c] = expf(last);
  cp_async_wait();
  __syncthreads();
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
    for (int e = 0; e < 8; ++e) split(__bfloat162float(xv[e]) * w, hv[e], lv[e]);
    *reinterpret_cast<uint4*>(xh + i * PLD + pp) = hi;
    *reinterpret_cast<uint4*>(xl + i * PLD + pp) = lo;
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
      uint32_t bf[4];   // B stored [j][n]: read transposed
      ldsm_x4_t(bf, bs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldn + n0 +
                        (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], ahi, bf[0], bf[1]);
      mma_bf16(acc[2 * jp], alo, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], ahi, bf[2], bf[3]);
      mma_bf16(acc[2 * jp + 1], alo, bf[2], bf[3]);
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
template <int V>
__global__ void __launch_bounds__(CT) ssd_state_kernel(Ssd A) {
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

// (4), one warp's 16 rows of the chunk: y into ys
template <int Q>
__device__ __forceinline__ void output_rows(
    const Ssd& A, int warp, int lane, const __nv_bfloat16* cs,
    const __nv_bfloat16* sh, const __nv_bfloat16* sl,
    const __nv_bfloat16* xs, __nv_bfloat16* ys, const float* dtv,
    const float* seg, int ldn, int b, int c) {
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
    uint32_t af[4];
    ldsm_x4(af, cs + (warp * 16 + (lane & 15)) * ldn + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      const int off = (jp * 16 + (lane & 7) + (lane >> 4) * 8) * ldn + k0 +
                      ((lane >> 3) & 1) * 8;
      uint32_t bh[4], bl[4];
      ldsm_x4(bh, sh + off);
      ldsm_x4(bl, sl + off);
      mma_bf16(acc[2 * jp], af, bh[0], bh[1]);
      mma_bf16(acc[2 * jp], af, bl[0], bl[1]);
      mma_bf16(acc[2 * jp + 1], af, bh[2], bh[3]);
      mma_bf16(acc[2 * jp + 1], af, bl[2], bl[3]);
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
      uint32_t bf[4];   // x stored [j][p]: read transposed
      ldsm_x4_t(bf, xs + (kb * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PLD +
                        jp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * jp], ahi, bf[0], bf[1]);
      mma_bf16(acc[2 * jp], alo, bf[0], bf[1]);
      mma_bf16(acc[2 * jp + 1], ahi, bf[2], bf[3]);
      mma_bf16(acc[2 * jp + 1], alo, bf[2], bf[3]);
    }
#pragma unroll
    for (int f = 0; f < 4; ++f) gv[f] = gn[f];
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<uint32_t*>(ys + (r ? rb : ra) * PLD + j * 8 +
                                   2 * tig) =
          pack2(__float2bfloat16_rn(acc[j][2 * r]),
                __float2bfloat16_rn(acc[j][2 * r + 1]));
}

// (4) y for one (b, c, h, 64 columns of P)
template <int Q>
__global__ void __launch_bounds__(CT) ssd_output_kernel(Ssd A) {
  extern __shared__ float4 smem4[];
  const int ldn = A.np + 8;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Q][ldn]
  __nv_bfloat16* sh = cs + Q * ldn;       // [PT][ldn] entry state, hi
  __nv_bfloat16* sl = sh + PT * ldn;      // lo
  __nv_bfloat16* xs = sl + PT * ldn;      // [Q][PLD]
  __nv_bfloat16* ys = xs + Q * PLD;       // [Q][PLD]: y, for the stores
  float* dtv = reinterpret_cast<float*>(ys + Q * PLD);
  float* seg = dtv + Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c = blockIdx.x / A.ptiles, p0 = (blockIdx.x % A.ptiles) * PT;
  const int t0 = c * Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_in = min(Q, A.s - t0), cols_in = min(PT, A.p - p0);

  stage(cs, ldn, A.cm + b * A.csb + (long long)t0 * A.css, A.css, A.csn,
        rows_in, Q, A.n, A.np, A.vec_c);
  stage(xs, PLD,
        A.x + b * A.xsb + h * A.xsh + (long long)t0 * A.xss +
            (long long)p0 * A.xsp,
        A.xss, A.xsp, rows_in, Q, cols_in, PT, A.vec_x);
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
  if (warp < Q / 16) output_rows<Q>(A, warp, lane, cs, sh, sl, xs, ys, dtv,
                                    seg, ldn, b, c);
  __syncthreads();
  // y rows of 64 columns, 16 bytes a store where the layout allows
  __nv_bfloat16* yb = A.y + b * A.ysb + h * A.ysh + (long long)t0 * A.yss +
                      (long long)p0 * A.ysp;
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

size_t chunk_smem(int q, int np) {
  const size_t ldn = np + 8;
  const size_t g_role = 2 * q * ldn * 2;
  const size_t d_role = q * ldn * 2 + 2 * q * PLD * 2 + 3 * q * 4;
  const size_t d_out = PT * (np + 4) * 4;   // the delta tile, staged last
  const size_t most = g_role > d_role ? g_role : d_role;
  return most > d_out ? most : d_out;
}

size_t output_smem(int q, int np) {
  const size_t ldn = np + 8;
  return (q * ldn + 2 * PT * ldn + 2 * q * PLD) * 2 + 2 * q * 4;
}

template <int Q>
int launch_chunked(Ssd A, int batch, cudaStream_t stream) {
  if (A.nc > 0) {
    const size_t sm2 = chunk_smem(Q, A.np), sm4 = output_smem(Q, A.np);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sm2);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_output_kernel<Q>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)sm4);
    if (err != cudaSuccess) return (int)err;
    ssd_chunk_kernel<Q><<<dim3(A.nh * A.ptiles + 1, A.nc, batch), CT, sm2,
                          stream>>>(A);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int pn = A.p * A.n;
  if (pn % 4 == 0)
    ssd_state_kernel<4><<<dim3((pn / 4 + CT - 1) / CT, A.nh, batch), CT, 0,
                          stream>>>(A);
  else
    ssd_state_kernel<1><<<dim3((pn + CT - 1) / CT, A.nh, batch), CT, 0,
                          stream>>>(A);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || A.nc == 0) return (int)err;
  ssd_output_kernel<Q><<<dim3(A.nc * A.ptiles, A.nh, batch), CT,
                         output_smem(Q, A.np), stream>>>(A);
  return (int)cudaGetLastError();
}

int launch_f32(const float* x, const float* dt, const float* a,
               const float* bm, const float* cm, const float* init, float* y,
               float* fstate, const long long* st, int batch, int nh, int s,
               int p, int n, int chunk, void* stream) {
  if (batch <= 0 || nh <= 0 || s < 0 || p <= 0 || n <= 0 || n > MAX_N ||
      batch > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return launch_q<1>(x, dt, a, bm, cm, init, y, fstate, st, batch,
                                nh, s, p, n, str);
    case 128:
      return launch_q<8>(x, dt, a, bm, cm, init, y, fstate, st, batch,
                                nh, s, p, n, str);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_bf16(const __nv_bfloat16* x, const float* dt, const float* a,
                const __nv_bfloat16* bm, const __nv_bfloat16* cm,
                const float* init, __nv_bfloat16* y, float* fstate,
                float* scratch, const long long* sd, int batch, int nh,
                int s, int p, int n, int chunk, void* stream) {
  if (batch <= 0 || nh <= 0 || s < 0 || p <= 0 || n <= 0 || n > MAX_N ||
      batch > 65535 || nh > 65535 || (chunk != 16 && chunk != 128))
    return (int)cudaErrorInvalidValue;
  Ssd A{x, dt, a, bm, cm, init, y, fstate, nullptr, nullptr, nullptr,
        nullptr, sd[0], sd[1], sd[2], sd[3], sd[4], sd[5], sd[6], sd[7], sd[8],
        sd[9], sd[10], sd[11], sd[12], sd[13], sd[14], sd[15], sd[16],
        nh, s, p, n, (s + chunk - 1) / chunk, (n + 15) / 16 * 16,
        (p + PT - 1) / PT};
  if (A.nc > 65535) return (int)cudaErrorInvalidValue;
  auto vec = [](const void* ptr, long long inner, long long s0, long long s1,
                long long s2, int cols) {
    return reinterpret_cast<unsigned long long>(ptr) % 16 == 0 &&
           inner == 1 && s0 % 8 == 0 && s1 % 8 == 0 && s2 % 8 == 0 &&
           cols % 8 == 0;
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
  return chunk == 16 ? launch_chunked<16>(A, batch, str)
                     : launch_chunked<128>(A, batch, str);
}

}  // namespace

// strides: 17 values in elements: x (batch, head, seq, p); dt (batch,
// head, seq); B (batch, seq, n); C (batch, seq, n); y (batch, head, seq,
// p). init (may be null) and fstate are contiguous (B, H, P, N) float32.
// ssd_scan_bf16's scratch holds ssd_scan_scratch(...) float32 values.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* bm, const float* cm,
                            const float* init, float* y, float* fstate,
                            const long long* strides, int batch, int nh,
                            int s, int p, int n, int chunk, void* stream) {
  return launch_f32(x, dt, a, bm, cm, init, y, fstate, strides, batch, nh, s,
                    p, n, chunk, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* a, const __nv_bfloat16* bm,
                             const __nv_bfloat16* cm, const float* init,
                             __nv_bfloat16* y, float* fstate, float* scratch,
                             const long long* strides, int batch, int nh,
                             int s, int p, int n, int chunk, void* stream) {
  return launch_bf16(x, dt, a, bm, cm, init, y, fstate, scratch, strides,
                     batch, nh, s, p, n, chunk, stream);
}
