// Markov-chain scan on Hopper (sm_90a), forward and backward: the forward
// filter that eliminates a vectorized Markov chain,
//
//   h_t       = alpha_t + L_t
//   alpha_t+1 = R_t + logmatmulexp(h_t, A)          t = 0 .. T-1
//
// with alpha_t (B, S), A (S, S) shared by all B rows or one (S, S) per row,
// and R_t, L_t (B, S).  Replaces the scan of
// pyro_tpu/ops/markov_product.py::_try_scan_elimination (step at :406-424,
// `lax.scan(jax.checkpoint(step))` at :469), whose step is one call of
// pyro_tpu/ops/log_matmul.py::logmatmulexp.  Each step repeats that
// function's arithmetic: h is shifted by its row max m, A by its column max
// c (non-finite maxima become 0), z = sum_l exp(h - m) exp(A - c) in f32,
// and logmatmulexp = log(max(z, FLT_MIN)) + m + c.
//
// Bound on an H100 SXM at the main path's shape (B=32, T=127, S=256, f32):
// 2*T*B*S*S = 0.53 GFLOP of FMAs, 8 us at the data-sheet 67 TFLOP/s f32
// rate outside the tensor cores; the inputs and outputs are 4.4 MB, 1.3 us
// at 3.35 TB/s.  But the T steps depend on each other, and each is a tiny
// (B, S) @ (S, S) product, so latency sets the time, not either bound.
// This design: one launch for all T steps; one block owns one sequence
// (row b) and loops over t, since rows never interact, so no grid-wide
// sync is needed.  A (256 KB at S=256) does not fit in one block's 227 KB
// of shared memory, so a prologue kernel writes Q = exp(A - c) once, and
// every step re-reads Q from L2 (256 KB per step per block; 50 MB of L2
// holds it); the carry, the shifted exponentials and the reductions stay
// in shared memory.  The step time is then the time one SM takes to stream
// Q from L2, so the block has 1024 threads: each column's dot product is
// split in four quarters of l, which keeps four times as many L2 loads in
// flight as one thread per column would.  Splitting Q's columns over a
// thread-block cluster, each slice resident in one SM's shared memory and
// the carry exchanged through distributed shared memory, is the known next
// step.
//
// Backward (the reverse scan of the VJP): for t = T-1 .. 0, with g =
// dloss/dalpha_t+1, dR_t = g; the block recomputes h_t and exp(h_t - m)
// from the saved carry alpha_t and takes the forward's saved z_t (so out_t
// = log z + m + c is bit-identical to the forward's; saving z, 4 MB at the
// main path's shape, spares the backward one of its two products per step),
// then follows the bounded backward of logmatmulexp:
//   E  = -(out - m - c)        cr = max_r E
//   rx = (g * exp(E - cr)) @ Q^T
//   dh = sign(rx) * exp(h - m + cr + log(|rx| + FLT_MIN)),
// with the clipped entries (below) a class of their own: each class has its
// own cr and rx, and dh sums the classes' terms; the second product runs
// only at a step whose row holds a clipped entry.
// dL_t = dh, and g becomes dh; the last dh is dalpha_0.  The block writes
// exp(h_t - m) and E (-inf on a row whose h is all -inf) per step.  dA is
// then one fold over all T*B rows with one shift per column (split over
// blocks, partial sums in scratch):
//   ry = sum_rows exp(h - m)^T (g * exp(E - cc)),
//   dA = sign(ry) * exp(A - c + cc + log(|ry| + FLT_MIN)),
// which equals the sum over t of the per-step dA_t up to rounding.  An
// entry whose z was clipped at FLT_MIN (a state unreachable from the row's
// support, as structural zeros of A make it) has E = -log(FLT_MIN), the
// largest there is; in the shift of a column it would push the terms of
// every other row of that column below the float32 range.  So the fold
// keeps two classes, each with its own shift and sum: the clipped entries
// and the rest.
// Plain C interface for ctypes; each entry point launches on the given
// stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#define NT 256    // threads of the prologue, the fold and its epilogue
#define NTS 1024  // threads of the forward and backward scan blocks
#define NPART (NTS / 256)
#define CM_COLS 32       // columns of a block of the column-max kernel
#define CM_THREADS 1024  // its threads
#define TM 64
#define TN 64
#define TK 16

__device__ __forceinline__ float finite_or_zero(float v) { return isfinite(v) ? v : 0.f; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max of v over the block of NTS threads; `red` holds NTS/32 floats.
// Ends synchronised.
__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
#pragma unroll
  for (int w = 0; w < NTS / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// out[r] = sum_l p[l] * M[l * S + r] for every r < S, by the whole block:
// for 256 columns at a time, thread (part, c) sums the part-th quarter of l
// for column c with four interleaved partial sums (so a warp reads one
// 128-byte row segment of M per load, and each thread keeps several L2 loads
// in flight), then the quarters are added in a fixed order.  `part_sums`
// holds NTS floats.  Ends synchronised.
__device__ __forceinline__ void block_col_dot(const float* p, const float* __restrict__ M, int S, float* out,
                                              float* part_sums) {
  const int c = threadIdx.x & 255, part = threadIdx.x >> 8;
  const int per = (S + NPART - 1) / NPART;
  const int l_begin = part * per, l_end = min(S, l_begin + per);
  for (int rb = 0; rb < S; rb += 256) {
    const int r = rb + c;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    if (r < S) {
      int l = l_begin;
#pragma unroll 2
      for (; l + 4 <= l_end; l += 4) {
        a0 = fmaf(p[l], M[(long long)l * S + r], a0);
        a1 = fmaf(p[l + 1], M[(long long)(l + 1) * S + r], a1);
        a2 = fmaf(p[l + 2], M[(long long)(l + 2) * S + r], a2);
        a3 = fmaf(p[l + 3], M[(long long)(l + 3) * S + r], a3);
      }
      for (; l < l_end; ++l) a0 = fmaf(p[l], M[(long long)l * S + r], a0);
    }
    part_sums[threadIdx.x] = (a0 + a1) + (a2 + a3);
    __syncthreads();
    if (part == 0 && r < S) out[r] = (part_sums[c] + part_sums[256 + c]) + (part_sums[512 + c] + part_sums[768 + c]);
    __syncthreads();
  }
}

// ---------------------------------------------------------------- prologue --

// Per transition matrix a and column r: craw = max_l A[l, r] (may be -inf),
// Q[l, r] = exp(A[l, r] - c) and its transpose QT[r, l], c = finite craw.
__global__ void __launch_bounds__(NT) ms_prep_kernel(const float* __restrict__ A, int S,
                                                     float* __restrict__ Q, float* __restrict__ QT,
                                                     float* __restrict__ craw) {
  const int a = blockIdx.y, r = blockIdx.x * NT + threadIdx.x;
  if (r >= S) return;
  const float* Aa = A + (long long)a * S * S;
  float m = -INFINITY;
  for (int l = 0; l < S; ++l) m = fmaxf(m, Aa[(long long)l * S + r]);
  craw[(long long)a * S + r] = m;
  const float c = finite_or_zero(m);
  for (int l = 0; l < S; ++l) {
    const float q = expf(Aa[(long long)l * S + r] - c);
    Q[(long long)a * S * S + (long long)l * S + r] = q;
    QT[(long long)a * S * S + (long long)r * S + l] = q;
  }
}

// ----------------------------------------------------------------- forward --

// One block per row b.  Shared memory: alpha, p, z (S each), part_sums
// (NTS), red (NTS/32).  Writes the carry stack alphas and the stack of z,
// both (T, B, S), for the backward.
__global__ void __launch_bounds__(NTS) ms_forward_kernel(const float* __restrict__ alpha0,
                                                         const float* __restrict__ Q,
                                                         const float* __restrict__ craw,
                                                         const float* __restrict__ R,
                                                         const float* __restrict__ L, int B, int T, int S,
                                                         int per_row_A, float* __restrict__ alphas,
                                                         float* __restrict__ zs, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* alpha = smem;
  float* p = alpha + S;
  float* z = p + S;
  float* part_sums = z + S;
  float* red = part_sums + NTS;
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long a = per_row_A ? b : 0;
  const float* Qa = Q + a * S * S;
  const float* ca = craw + a * S;
  for (int l = tid; l < S; l += NTS) alpha[l] = alpha0[(long long)b * S + l];
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const long long row = ((long long)t * B + b) * S;
    float m = -INFINITY;
    for (int l = tid; l < S; l += NTS) {
      alphas[row + l] = alpha[l];
      const float h = L ? alpha[l] + L[row + l] : alpha[l];
      p[l] = h;
      m = fmaxf(m, h);
    }
    m = finite_or_zero(block_max(m, red));
    for (int l = tid; l < S; l += NTS) p[l] = expf(p[l] - m);
    __syncthreads();
    block_col_dot(p, Qa, S, z, part_sums);
    for (int r = tid; r < S; r += NTS) {
      zs[row + r] = z[r];
      alpha[r] = logf(fmaxf(z[r], FLT_MIN)) + m + finite_or_zero(ca[r]) + R[row + r];
    }
    __syncthreads();
  }
  for (int r = tid; r < S; r += NTS) out[(long long)b * S + r] = alpha[r];
}

// ---------------------------------------------------------------- backward --

// One block per row b, t from T-1 down to 0.  Shared memory: g, h, p, e,
// u, z (S each), part_sums (NTS), red (NTS/32).  Reads the forward's carry
// and z stacks; writes dR, dL (if L), the fold's inputs P, W (E of the
// unclipped entries) and Wc (E of the clipped ones), and dalpha0.
__global__ void __launch_bounds__(NTS) ms_backward_kernel(
    const float* __restrict__ alphas, const float* __restrict__ zs, const float* __restrict__ L,
    const float* __restrict__ Q,
    const float* __restrict__ QT, const float* __restrict__ craw, const float* __restrict__ gout, int B,
    int T, int S, int per_row_A, float* __restrict__ dR, float* __restrict__ dL, float* __restrict__ P,
    float* __restrict__ W, float* __restrict__ Wc, float* __restrict__ dalpha0) {
  extern __shared__ float smem[];
  float* g = smem;
  float* h = g + S;
  float* p = h + S;
  float* e = p + S;
  float* u = e + S;
  float* z = u + S;
  float* part_sums = z + S;
  float* red = part_sums + NTS;
  const int b = blockIdx.x, tid = threadIdx.x;
  const long long a = per_row_A ? b : 0;
  const float* Qa = Q + a * S * S;
  const float* QTa = QT + a * S * S;
  const float* ca = craw + a * S;
  for (int r = tid; r < S; r += NTS) g[r] = gout[(long long)b * S + r];
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const long long row = ((long long)t * B + b) * S;
    float xs_raw = -INFINITY;
    for (int l = tid; l < S; l += NTS) {
      dR[row + l] = g[l];
      const float hl = L ? alphas[row + l] + L[row + l] : alphas[row + l];
      h[l] = hl;
      xs_raw = fmaxf(xs_raw, hl);
    }
    xs_raw = block_max(xs_raw, red);
    const float xs = finite_or_zero(xs_raw);
    for (int l = tid; l < S; l += NTS) {
      const float pl = expf(h[l] - xs);
      p[l] = pl;
      P[row + l] = pl;
    }
    __syncthreads();
    // E = -log Z from the forward's z, with out rebuilt as the forward built
    // it; e keeps E of the unclipped entries (-inf for the clipped), z the
    // clipped ones', and each class gets its own shift (see the fold)
    float cr = -INFINITY, crc = -INFINITY;
    for (int r = tid; r < S; r += NTS) {
      const float c = finite_or_zero(ca[r]);
      const float zr = zs[row + r];
      const float o = logf(fmaxf(zr, FLT_MIN)) + xs + c;
      const float E = -(o - xs - c);
      const bool live = xs_raw > -INFINITY, clipped = zr <= FLT_MIN;
      e[r] = clipped ? -INFINITY : E;
      z[r] = clipped ? E : -INFINITY;
      W[row + r] = live && !clipped ? E : -INFINITY;
      Wc[row + r] = live && clipped ? E : -INFINITY;
      if (clipped) crc = fmaxf(crc, E); else cr = fmaxf(cr, E);
    }
    cr = finite_or_zero(block_max(cr, red));
    crc = block_max(crc, red);
    const bool two = crc > -INFINITY;  // block-uniform: a clipped entry exists
    for (int r = tid; r < S; r += NTS) u[r] = g[r] * expf(e[r] - cr);
    __syncthreads();
    block_col_dot(u, QTa, S, e, part_sums);  // e now holds rx of class 0
    if (two) {
      for (int r = tid; r < S; r += NTS) u[r] = g[r] * expf(z[r] - crc);
      __syncthreads();
      block_col_dot(u, QTa, S, z, part_sums);  // z now holds rx of class 1
    }
    for (int l = tid; l < S; l += NTS) {
      const float rx = e[l];
      const float sg = (float)(rx > 0.f) - (float)(rx < 0.f);
      float dh = sg * expf((h[l] - xs + cr) + logf(fabsf(rx) + FLT_MIN));
      if (two) {
        const float rc = z[l];
        const float sc = (float)(rc > 0.f) - (float)(rc < 0.f);
        dh += sc * expf((h[l] - xs + crc) + logf(fabsf(rc) + FLT_MIN));
      }
      if (dL) dL[row + l] = dh;
      g[l] = dh;
    }
    __syncthreads();
  }
  for (int l = tid; l < S; l += NTS) dalpha0[(long long)b * S + l] = g[l];
}

// The rows (t, b) that use transition matrix a: all T*B rows when A is
// shared, the T rows of b == a when each row has its own.
__device__ __forceinline__ long long fold_row(int i, int a, int B, int per_row_A) {
  return per_row_A ? (long long)i * B + a : (long long)i;
}

// cc[a, r] = max over the group's rows of W[row, r], made finite, and
// cc[nA + a, r] = that of Wc, left -inf where no entry of the column was
// clipped.  A block takes CM_COLS columns, one per lane, and its warps
// take every (CM_THREADS / 32)-th row, so each load is one 128-byte
// segment and many are in flight.
__global__ void __launch_bounds__(CM_THREADS) ms_colmax_kernel(const float* __restrict__ W,
                                                               const float* __restrict__ Wc, int B, int T, int S,
                                                               int per_row_A, float* __restrict__ cc) {
  __shared__ float red[2][CM_THREADS / 32][CM_COLS];
  const int a = blockIdx.y, nA = gridDim.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = blockIdx.x * CM_COLS + lane;
  const int rows = per_row_A ? T : T * B;
  float m = -INFINITY, mc = -INFINITY;
  if (r < S) {
    for (int i = warp; i < rows; i += CM_THREADS / 32) {
      const long long o = fold_row(i, a, B, per_row_A) * S + r;
      m = fmaxf(m, W[o]);
      mc = fmaxf(mc, Wc[o]);
    }
  }
  red[0][warp][lane] = m;
  red[1][warp][lane] = mc;
  __syncthreads();
  if (warp == 0 && r < S) {
    for (int w = 1; w < CM_THREADS / 32; ++w) {
      m = fmaxf(m, red[0][w][lane]);
      mc = fmaxf(mc, red[1][w][lane]);
    }
    cc[(long long)a * S + r] = finite_or_zero(m);
    cc[((long long)nA + a) * S + r] = mc;
  }
}

// partial[cls, k, a, l, r] = sum over split k of the group's rows of
// P[row, l] * dR[row, r] * exp(W[row, r] - cc[a, r]) for class 0, and the
// same with Wc and its shift for class 1 (only in a tile whose columns hold
// a clipped entry; the epilogue reads class 1 only there).  A block
// computes one 64x64 (l, r) tile with 16-row steps staged in shared memory,
// 4x4 outputs per thread.
__global__ void __launch_bounds__(NT) ms_fold_kernel(const float* __restrict__ P, const float* __restrict__ G,
                                                     const float* __restrict__ W, const float* __restrict__ Wc,
                                                     const float* __restrict__ cc, int B, int T, int S,
                                                     int per_row_A, int splits, float* __restrict__ partial) {
  __shared__ __align__(16) float Ps[TK][TM + 4];
  __shared__ __align__(16) float Gs[TK][TN + 4];
  const int tid = threadIdx.x;
  const int col_tiles = (S + TN - 1) / TN;
  const int l0 = (blockIdx.x / col_tiles) * TM, r0 = (blockIdx.x % col_tiles) * TN;
  const int k = blockIdx.y, a = blockIdx.z, nA = gridDim.z;
  const int rows = per_row_A ? T : T * B;
  const int per_split = (rows + splits - 1) / splits;
  const int i_begin = k * per_split, i_end = min(rows, i_begin + per_split);
  const float* cc_clip = cc + ((long long)nA + a) * S;
  const int classes = 1 + (__syncthreads_or(tid < TN && r0 + tid < S && cc_clip[r0 + tid] > -INFINITY) != 0);
  const int tl = (tid / 16) * 4, tr = (tid % 16) * 4;
  for (int cls = 0; cls < classes; ++cls) {
    const float* Wk = cls ? Wc : W;
    const float* cck = cc + ((long long)cls * nA + a) * S;
    float acc[4][4] = {};
    for (int i0 = i_begin; i0 < i_end; i0 += TK) {
      for (int x = tid; x < TK * TM; x += NT) {
        const int i = x / TM, l = x % TM;
        float v = 0.f;
        if (i0 + i < i_end && l0 + l < S) v = P[fold_row(i0 + i, a, B, per_row_A) * S + l0 + l];
        Ps[i][l] = v;
      }
      for (int x = tid; x < TK * TN; x += NT) {
        const int i = x / TN, r = x % TN;
        float v = 0.f;
        if (i0 + i < i_end && r0 + r < S) {
          const long long o = fold_row(i0 + i, a, B, per_row_A) * S + r0 + r;
          v = G[o] * expf(Wk[o] - finite_or_zero(cck[r0 + r]));
        }
        Gs[i][r] = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const float4 pv = *reinterpret_cast<const float4*>(&Ps[i][tl]);
        const float4 gv = *reinterpret_cast<const float4*>(&Gs[i][tr]);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(pa[x], ga[y], acc[x][y]);
      }
      __syncthreads();
    }
    float* out = partial + (((long long)cls * splits + k) * nA + a) * S * S;
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int l = l0 + tl + x, r = r0 + tr + y;
        if (l < S && r < S) out[(long long)l * S + r] = acc[x][y];
      }
  }
}

// dA[a, l, r] = sum over the classes present in column r of
// sign(ry) * exp(A - c + cc + log(|ry| + FLT_MIN)), ry the sum of the
// class's split partials and cc its shift.
__global__ void __launch_bounds__(NT) ms_dA_kernel(const float* __restrict__ A, const float* __restrict__ craw,
                                                   const float* __restrict__ cc, const float* __restrict__ partial,
                                                   int nA, int S, int splits, float* __restrict__ dA) {
  const long long n = (long long)nA * S * S;
  for (long long x = (long long)blockIdx.x * NT + threadIdx.x; x < n; x += (long long)gridDim.x * NT) {
    const long long ar = x / ((long long)S * S) * S + x % S;
    const float shifted = A[x] - finite_or_zero(craw[ar]);
    const int classes = cc[nA * S + ar] > -INFINITY ? 2 : 1;
    float d = 0.f;
    for (int cls = 0; cls < classes; ++cls) {
      float ry = 0.f;
      for (int k = 0; k < splits; ++k) ry += partial[((long long)cls * splits + k) * n + x];
      const float sg = (float)(ry > 0.f) - (float)(ry < 0.f);
      d += sg * expf((shifted + cc[cls * nA * S + ar]) + logf(fabsf(ry) + FLT_MIN));
    }
    dA[x] = d;
  }
}

// ------------------------------------------------------------ C interface --

extern "C" {

// alpha0 (B, S); A (nA, S, S), nA 1 or B; R and L (T, B, S), L may be null;
// outputs: alphas and zs (T, B, S), out (B, S); scratch kept for the
// backward: Q and QT (nA, S, S), craw (nA, S).
int ms_forward(const float* alpha0, const float* A, const float* R, const float* L, int B, int T, int S, int nA,
               float* alphas, float* zs, float* out, float* Q, float* QT, float* craw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 prep_grid((S + NT - 1) / NT, nA);
  ms_prep_kernel<<<prep_grid, NT, 0, st>>>(A, S, Q, QT, craw);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = (3 * (size_t)S + NTS + NTS / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(ms_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  ms_forward_kernel<<<B, NTS, smem, st>>>(alpha0, Q, craw, R, L, B, T, S, nA > 1, alphas, zs, out);
  return (int)cudaGetLastError();
}

// gout (B, S) is dloss/dalpha_T; alphas and zs are the forward's.
// Outputs dalpha0 (B, S), dR (T, B, S), dL (T, B, S) or null, dA (nA, S, S).
// Scratch: P, W and Wc (T, B, S), cc (2, nA, S), partial (2, splits, nA, S, S).
int ms_backward(const float* A, const float* alphas, const float* zs, const float* L, const float* Q,
                const float* QT,
                const float* craw, const float* gout, int B, int T, int S, int nA, int splits,
                float* dalpha0, float* dR, float* dL, float* dA, float* P, float* W, float* Wc, float* cc,
                float* partial, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int per_row_A = nA > 1;
  const size_t smem = (6 * (size_t)S + NTS + NTS / 32) * sizeof(float);
  int err = 0;
  if (smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(ms_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  ms_backward_kernel<<<B, NTS, smem, st>>>(alphas, zs, L, Q, QT, craw, gout, B, T, S, per_row_A, dR, dL, P, W,
                                           Wc, dalpha0);
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 colmax_grid((S + CM_COLS - 1) / CM_COLS, nA);
  ms_colmax_kernel<<<colmax_grid, CM_THREADS, 0, st>>>(W, Wc, B, T, S, per_row_A, cc);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int tiles = ((S + TM - 1) / TM) * ((S + TN - 1) / TN);
  dim3 fold_grid(tiles, splits, nA);
  ms_fold_kernel<<<fold_grid, NT, 0, st>>>(P, dR, W, Wc, cc, B, T, S, per_row_A, splits, partial);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long n = (long long)nA * S * S;
  const int blocks = (int)((n + NT - 1) / NT < 1024 ? (n + NT - 1) / NT : 1024);
  ms_dA_kernel<<<blocks, NT, 0, st>>>(A, craw, cc, partial, nA, S, splits, dA);
  return (int)cudaGetLastError();
}

}  // extern "C"
