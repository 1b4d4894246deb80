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
//
// What bounds it on an H100: reading x, B, C and dt once and writing y and
// the final state once (about 20 MB at B 1, S 1,024, H 64, P 64, N 128,
// bf16) against the operations the function needs, nc Q(Q+1) N for the
// causal C B^T shared by all heads plus H nc (Q(Q+1) P + 4 Q N P) for the
// causal W x, C state^T and x^T B (2.7 GFLOP): ~6 us by bytes. This first
// kernel runs its products as float32 FMAs on the CUDA cores from shared
// memory, and shared-memory loads bound it.
//
// Design. The TPU grid (batch, heads, chunks) runs its chunk axis in order
// with the state in VMEM scratch. Here one block of 256 threads (16 x 16)
// serves one (sequence, head, 32 columns of P) and walks the chunks
// itself, holding its (32, N) slice of the state in registers (a copy in
// shared memory feeds the off-diagonal product). Splitting P in 32-column
// slices gives B H P/32 blocks, 128 for one prompt at P 64 on 132 SMs, at
// the cost of computing C B^T again in each slice's block. Per chunk: the
// chunk's C, B, x and dt are staged in shared memory as float32 (rows past
// S as zeros, so dt = 0 leaves the state unchanged and nothing is written
// there; dt is read through its strides, not broadcast to lanes as on the
// TPU); warp 0 scans seg; then (1) the scores C B^T, only their lower
// 16 x 16 blocks, in registers, with exp(seg_i) C state^T beside them;
// (2) the decayed, masked scores W (Q x Q) over C's buffer; (3) y += W x,
// written out; (4) the state update x^T (w B) in registers. C B^T is the
// same for every head (ngroups = 1) and is computed again per head: sharing
// it, wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace {

constexpr int NT = 256;         // 16 x 16 threads
constexpr int TD = 16;
constexpr int MAX_N = 128;      // state width: 16 lanes x 8
constexpr int PB = 32;          // columns of P per block: 16 lanes x 2
constexpr int RN = MAX_N / TD;
constexpr int RP = PB / TD;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
template <typename T, int RQ>
__global__ void __launch_bounds__(NT) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const T* __restrict__ bm,
    const T* __restrict__ cm, const float* __restrict__ init,
    T* __restrict__ y, float* __restrict__ fstate, long long xsb,
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
      cs[i * L.ldn + nn] = in ? to_f(cm[b * csb + t * css + nn * csn]) : 0.f;
      bs[i * L.ldn + nn] = in ? to_f(bm[b * bsb + t * bss + nn * bsn]) : 0.f;
    }
    for (int idx = tid; idx < Q * PB; idx += NT) {
      const int i = idx / PB, pp = idx - i * PB, t = t0 + i;
      xs[idx] = t < s && p0 + pp < p
                    ? to_f(x[b * xsb + h * xsh + t * xss + (p0 + pp) * xsp])
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
          y[b * ysb + h * ysh + t * yss + pp * ysp] = from_f<T>(acc[r][c]);
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

template <typename T, int RQ>
int launch_q(const T* x, const float* dt, const float* a, const T* bm,
             const T* cm, const float* init, T* y, float* fstate,
             const long long* st, int batch, int nh, int s, int p, int n,
             cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)layout(RQ * TD, n).total;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, RQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p + PB - 1) / PB, nh, batch);
  ssd_kernel<T, RQ><<<grid, NT, smem, stream>>>(
      x, dt, a, bm, cm, init, y, fstate, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], st[9], st[10], st[11], st[12], st[13],
      st[14], st[15], st[16], nh, s, p, n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* x, const float* dt, const float* a, const T* bm,
           const T* cm, const float* init, T* y, float* fstate,
           const long long* st, int batch, int nh, int s, int p, int n,
           int chunk, void* stream) {
  if (batch <= 0 || nh <= 0 || s < 0 || p <= 0 || n <= 0 || n > MAX_N ||
      batch > 65535 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t str = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 16:
      return launch_q<T, 1>(x, dt, a, bm, cm, init, y, fstate, st, batch, nh,
                            s, p, n, str);
    case 128:
      return launch_q<T, 8>(x, dt, a, bm, cm, init, y, fstate, st, batch, nh,
                            s, p, n, str);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 17 values in elements: x (batch, head, seq, p); dt (batch,
// head, seq); B (batch, seq, n); C (batch, seq, n); y (batch, head, seq,
// p). init (may be null) and fstate are contiguous (B, H, P, N) float32.
extern "C" int ssd_scan_f32(const float* x, const float* dt, const float* a,
                            const float* bm, const float* cm,
                            const float* init, float* y, float* fstate,
                            const long long* strides, int batch, int nh,
                            int s, int p, int n, int chunk, void* stream) {
  return launch<float>(x, dt, a, bm, cm, init, y, fstate, strides, batch, nh,
                       s, p, n, chunk, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* a, const __nv_bfloat16* bm,
                             const __nv_bfloat16* cm, const float* init,
                             __nv_bfloat16* y, float* fstate,
                             const long long* strides, int batch, int nh,
                             int s, int p, int n, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, init, y, fstate, strides,
                               batch, nh, s, p, n, chunk, stream);
}
