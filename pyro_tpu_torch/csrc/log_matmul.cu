// log-matmul-exp on Hopper (sm_90a), forward and backward.
//
//   out[..., i, j] = log sum_k exp(x[..., i, k] + y[..., k, j])
//
// Replaces pyro_tpu/ops/log_matmul.py::logmatmulexp: its forward
// `_logmatmulexp_raw` and its analytic VJP `_bwd` (the stand-in for the
// retired Pallas kernel `_logmatmulexp_pallas`).  The arithmetic is the
// same: x is shifted by its row max xs, y by its column max ys (non-finite
// maxima become 0), the shifted exponentials are multiplied and summed in
// f32, and out = log(max(z, FLT_MIN)) + xs + ys.  An all -inf row therefore
// gives log(FLT_MIN), not -inf.
//
// Bound on an H100 SXM at the main path's first round, (2048, 256, 256) f32:
// 2*B*M*N*K = 6.9e10 flop, so 1.0 ms at the data-sheet 67 TFLOP/s f32 rate
// outside the tensor cores; x, y and out are 1.6 GB together, so 0.48 ms at
// 3.35 TB/s.  The op is bound by f32 arithmetic, not by memory.  This design
// keeps the product out of device memory: each block stages exp'd 64x16 and
// 16x64 tiles in shared memory and each thread accumulates a 4x4 block of
// outputs with FMAs, so device memory sees each input panel twice (once for
// the maxima, once for the product, the second mostly from L2) and each
// output once.  It does not use wgmma, TMA or online rescaling; the exp of
// each input element is recomputed by every block that reads it.
//
// Backward (the bounded form of `_bwd`, with E = -(out - xs - ys); the
// maxima cr and cc skip all -inf rows of x and columns of y, see
// lme_stats_kernel):
//   cr[i] = max_j E[i,j],  rx = (g * exp(E - cr)) @ exp(y - ys)^T,
//   dx    = sign(rx) * exp(x - xs + cr + log(|rx| + FLT_MIN))
//   cc[j] = max_i E[i,j],  ry = exp(x - xs)^T @ (g * exp(E - cc)),
//   dy    = sign(ry) * exp(y - ys + cc + log(|ry| + FLT_MIN))
// One kernel computes xs, ys, cr, cc per batch item into scratch; a second
// runs both products with the same tiling (blocks split between dx and dy).
// Both write per broadcast batch item; the caller sums broadcast dims.
//
// Every operand is read through element strides, with up to three batch
// dims, so strided views (the halves of a time-paired reshape) need no copy.
// Plain C interface for ctypes; each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define TM 64
#define TN 64
#define TK 16
#define NT 256

struct Mat {
  const float* p;
  long long sb0, sb1, sb2;  // batch strides
  long long sr, sc;         // row and column strides
};

struct Shape {
  int n0, n1, n2;  // batch sizes
  int M, K, N;
};

__device__ __forceinline__ long long batch_offset(const Mat& m, int b, const Shape& s) {
  int i2 = b % s.n2;
  int t = b / s.n2;
  int i1 = t % s.n1;
  int i0 = t / s.n1;
  return i0 * m.sb0 + i1 * m.sb1 + i2 * m.sb2;
}

__device__ __forceinline__ float ld(const Mat& m, long long base, int r, int c) {
  return m.p[base + r * m.sr + c * m.sc];
}

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// acc[4][4] += sum_t A(r, t) * B(t, c) over the tile at (r0, c0) of an
// R x C output with reduction length T.  `la(r, t)` and `lb(t, c)` return the
// (already transformed) operand elements; A_T_FAST / B_C_FAST say which index
// is contiguous in memory, so that neighbouring threads load neighbours.
template <bool A_T_FAST, bool B_C_FAST, class LA, class LB>
__device__ __forceinline__ void tile_product(const LA& la, const LB& lb, int R, int C, int T,
                                             int r0, int c0, float (&acc)[4][4],
                                             float (*As)[TM + 4], float (*Bs)[TN + 4]) {
  const int tid = threadIdx.x;
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  for (int t0 = 0; t0 < T; t0 += TK) {
    for (int e = tid; e < TM * TK; e += NT) {
      int r, t;
      if (A_T_FAST) { r = e / TK; t = e % TK; } else { t = e / TM; r = e % TM; }
      float v = 0.f;
      if (r0 + r < R && t0 + t < T) v = la(r0 + r, t0 + t);
      As[t][r] = v;
    }
    for (int e = tid; e < TK * TN; e += NT) {
      int t, c;
      if (B_C_FAST) { t = e / TN; c = e % TN; } else { c = e / TK; t = e % TK; }
      float v = 0.f;
      if (t0 + t < T && c0 + c < C) v = lb(t0 + t, c0 + c);
      Bs[t][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      float4 a = *reinterpret_cast<const float4*>(&As[t][tr]);
      float4 b = *reinterpret_cast<const float4*>(&Bs[t][tc]);
      float av[4] = {a.x, a.y, a.z, a.w};
      float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- forward --

__global__ void __launch_bounds__(NT) lme_forward_kernel(Mat x, Mat y, float* __restrict__ out,
                                                         Shape s) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  __shared__ float xs[TM], ys[TN], part[4][TN];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.y * TM, c0 = blockIdx.x * TN;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const long long xb = batch_offset(x, b, s), yb = batch_offset(y, b, s);
    // row maxima of this tile's x rows: one warp per row, lanes along k
    for (int r = warp; r < TM; r += NT / 32) {
      float m = -INFINITY;
      if (r0 + r < s.M)
        for (int k = lane; k < s.K; k += 32) m = fmaxf(m, ld(x, xb, r0 + r, k));
      m = warp_max(m);
      if (lane == 0) xs[r] = finite_or_zero(m);
    }
    // column maxima of this tile's y columns: 4 threads per column
    {
      const int c = tid % TN, q = tid / TN;
      float m = -INFINITY;
      if (c0 + c < s.N)
        for (int k = q; k < s.K; k += NT / TN) m = fmaxf(m, ld(y, yb, k, c0 + c));
      part[q][c] = m;
    }
    __syncthreads();
    if (tid < TN)
      ys[tid] = finite_or_zero(fmaxf(fmaxf(part[0][tid], part[1][tid]), fmaxf(part[2][tid], part[3][tid])));
    __syncthreads();

    float acc[4][4] = {};
    auto la = [&](int r, int k) { return expf(ld(x, xb, r, k) - xs[r - r0]); };
    auto lb = [&](int k, int c) { return expf(ld(y, yb, k, c) - ys[c - c0]); };
    tile_product<true, true>(la, lb, s.M, s.N, s.K, r0, c0, acc, As, Bs);

    const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
    float* o = out + (long long)b * s.M * s.N;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + tr + i, c = c0 + tc + j;
        if (r < s.M && c < s.N)
          o[(long long)r * s.N + c] = logf(fmaxf(acc[i][j], FLT_MIN)) + xs[tr + i] + ys[tc + j];
      }
    __syncthreads();
  }
}

// --------------------------------------------------------------- backward --

// Per batch item: xs (M), ys (N), cr (M), cc (N), written to scratch.  The
// shifts cr and cc skip all -inf columns of y and rows of x: those carry no
// weight, but their clipped out would make their E the largest and push
// every other term below the float32 range (the JAX package's _bwd keeps
// them in).
__global__ void __launch_bounds__(NT) lme_stats_kernel(Mat x, Mat y, Mat out, Shape s,
                                                       float* __restrict__ xs_g, float* __restrict__ ys_g,
                                                       float* __restrict__ cr_g, float* __restrict__ cc_g) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.x; b < nb; b += gridDim.x) {
    const long long xb = batch_offset(x, b, s), yb = batch_offset(y, b, s), ob = batch_offset(out, b, s);
    float* xs = xs_g + (long long)b * s.M;
    float* ys = ys_g + (long long)b * s.N;
    float* cr = cr_g + (long long)b * s.M;
    float* cc = cc_g + (long long)b * s.N;
    // raw maxima first; -inf marks a row (column) with no weight
    for (int i = warp; i < s.M; i += NT / 32) {
      float m = -INFINITY;
      for (int k = lane; k < s.K; k += 32) m = fmaxf(m, ld(x, xb, i, k));
      m = warp_max(m);
      if (lane == 0) xs[i] = m;
    }
    for (int j = tid; j < s.N; j += NT) {
      float m = -INFINITY;
      for (int k = 0; k < s.K; ++k) m = fmaxf(m, ld(y, yb, k, j));
      ys[j] = m;
    }
    __syncthreads();
    for (int i = warp; i < s.M; i += NT / 32) {
      float m = -INFINITY;
      const float xi = finite_or_zero(xs[i]);
      for (int j = lane; j < s.N; j += 32)
        if (ys[j] > -INFINITY) m = fmaxf(m, -(ld(out, ob, i, j) - xi - finite_or_zero(ys[j])));
      m = warp_max(m);
      if (lane == 0) cr[i] = finite_or_zero(m);
    }
    for (int j = tid; j < s.N; j += NT) {
      float m = -INFINITY;
      const float yj = finite_or_zero(ys[j]);
      for (int i = 0; i < s.M; ++i)
        if (xs[i] > -INFINITY) m = fmaxf(m, -(ld(out, ob, i, j) - finite_or_zero(xs[i]) - yj));
      cc[j] = finite_or_zero(m);
    }
    __syncthreads();
    for (int i = tid; i < s.M; i += NT) xs[i] = finite_or_zero(xs[i]);
    for (int j = tid; j < s.N; j += NT) ys[j] = finite_or_zero(ys[j]);
    __syncthreads();
  }
}

// Blocks [0, tiles_dx) compute dx tiles (M x K), the rest dy tiles (K x N).
__global__ void __launch_bounds__(NT) lme_grad_kernel(Mat x, Mat y, Mat out, Mat g, Shape s,
                                                      const float* __restrict__ xs_g, const float* __restrict__ ys_g,
                                                      const float* __restrict__ cr_g, const float* __restrict__ cc_g,
                                                      float* __restrict__ dx, float* __restrict__ dy) {
  __shared__ __align__(16) float As[TK][TM + 4];
  __shared__ __align__(16) float Bs[TK][TN + 4];
  const int tid = threadIdx.x;
  const int dx_cols = (s.K + TN - 1) / TN;
  const int tiles_dx = ((s.M + TM - 1) / TM) * dx_cols;
  const int dy_cols = (s.N + TN - 1) / TN;
  const bool is_dx = (int)blockIdx.x < tiles_dx;
  const int tile = is_dx ? blockIdx.x : blockIdx.x - tiles_dx;
  const int cols = is_dx ? dx_cols : dy_cols;
  const int r0 = (tile / cols) * TM, c0 = (tile % cols) * TN;
  const int tr = (tid / 16) * 4, tc = (tid % 16) * 4;
  const int nb = s.n0 * s.n1 * s.n2;
  for (int b = blockIdx.z; b < nb; b += gridDim.z) {
    const long long xb = batch_offset(x, b, s), yb = batch_offset(y, b, s);
    const long long ob = batch_offset(out, b, s), gb = batch_offset(g, b, s);
    const float* xs = xs_g + (long long)b * s.M;
    const float* ys = ys_g + (long long)b * s.N;
    const float* cr = cr_g + (long long)b * s.M;
    const float* cc = cc_g + (long long)b * s.N;
    float acc[4][4] = {};
    if (is_dx) {
      // rx[i, k] = sum_j g[i,j] exp(E[i,j] - cr[i]) * exp(y[k,j] - ys[j])
      auto la = [&](int i, int j) {
        const float e = -(ld(out, ob, i, j) - xs[i] - ys[j]);
        return ld(g, gb, i, j) * expf(e - cr[i]);
      };
      auto lb = [&](int j, int k) { return expf(ld(y, yb, k, j) - ys[j]); };
      tile_product<true, false>(la, lb, s.M, s.K, s.N, r0, c0, acc, As, Bs);
      float* d = dx + (long long)b * s.M * s.K;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + tr + i, c = c0 + tc + j;
          if (r < s.M && c < s.K) {
            const float a = acc[i][j];
            const float sg = (float)(a > 0.f) - (float)(a < 0.f);
            d[(long long)r * s.K + c] =
                sg * expf((ld(x, xb, r, c) - xs[r] + cr[r]) + logf(fabsf(a) + FLT_MIN));
          }
        }
    } else {
      // ry[k, j] = sum_i exp(x[i,k] - xs[i]) * g[i,j] exp(E[i,j] - cc[j])
      auto la = [&](int k, int i) { return expf(ld(x, xb, i, k) - xs[i]); };
      auto lb = [&](int i, int j) {
        const float e = -(ld(out, ob, i, j) - xs[i] - ys[j]);
        return ld(g, gb, i, j) * expf(e - cc[j]);
      };
      tile_product<false, true>(la, lb, s.K, s.N, s.M, r0, c0, acc, As, Bs);
      float* d = dy + (long long)b * s.K * s.N;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + tr + i, c = c0 + tc + j;
          if (r < s.K && c < s.N) {
            const float a = acc[i][j];
            const float sg = (float)(a > 0.f) - (float)(a < 0.f);
            d[(long long)r * s.N + c] =
                sg * expf((ld(y, yb, r, c) - ys[c] + cc[c]) + logf(fabsf(a) + FLT_MIN));
          }
        }
    }
  }
}

// ------------------------------------------------------------ C interface --

static Mat make_mat(const float* p, const long long* st) {
  Mat m;
  m.p = p;
  m.sb0 = st[0]; m.sb1 = st[1]; m.sb2 = st[2];
  m.sr = st[3]; m.sc = st[4];
  return m;
}

static Shape make_shape(const int* bshape, int M, int K, int N) {
  Shape s;
  s.n0 = bshape[0]; s.n1 = bshape[1]; s.n2 = bshape[2];
  s.M = M; s.K = K; s.N = N;
  return s;
}

static int grid_batch(const Shape& s) {
  const int nb = s.n0 * s.n1 * s.n2;
  return nb < 65535 ? nb : 65535;
}

extern "C" {

// strides: 5 element strides per operand (3 batch, row, column).
int lme_forward(const float* x, const long long* x_st, const float* y, const long long* y_st,
                float* out, const int* bshape, int M, int K, int N, void* stream) {
  const Shape s = make_shape(bshape, M, K, N);
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, grid_batch(s));
  lme_forward_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(make_mat(x, x_st), make_mat(y, y_st), out, s);
  return (int)cudaGetLastError();
}

// scratch holds B*(2M + 2N) floats; dx is (B, M, K) and dy (B, K, N), contiguous.
int lme_backward(const float* x, const long long* x_st, const float* y, const long long* y_st,
                 const float* out, const long long* out_st, const float* g, const long long* g_st,
                 float* scratch, float* dx, float* dy, const int* bshape, int M, int K, int N,
                 void* stream) {
  const Shape s = make_shape(bshape, M, K, N);
  const long long nb = (long long)s.n0 * s.n1 * s.n2;
  float* xs = scratch;
  float* ys = xs + nb * M;
  float* cr = ys + nb * N;
  float* cc = cr + nb * M;
  const Mat xm = make_mat(x, x_st), ym = make_mat(y, y_st), om = make_mat(out, out_st), gm = make_mat(g, g_st);
  lme_stats_kernel<<<grid_batch(s), NT, 0, (cudaStream_t)stream>>>(xm, ym, om, s, xs, ys, cr, cc);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int tiles = ((M + TM - 1) / TM) * ((K + TN - 1) / TN) + ((K + TM - 1) / TM) * ((N + TN - 1) / TN);
  dim3 grid(tiles, 1, grid_batch(s));
  lme_grad_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(xm, ym, om, gm, s, xs, ys, cr, cc, dx, dy);
  return (int)cudaGetLastError();
}

}  // extern "C"
