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
// The carry is kept shifted: the kernels carry alpha_t+1 - (m_0 + .. + m_t),
// that is log(max(z, FLT_MIN)) + c + R_t, and each row's shifts add up
// beside it in double; alpha_T is the shifted carry plus that sum.  The
// true carry drifts like T times the emission scale (about -4400 on the
// main path), where float32 rounds h - m, and with it the backward's
// softmax weights, to about 1e-3 of the gradient; the shifted carry stays
// within one step's factors.  The backward reads the shifted carry stack
// as it is: its weights exp(h - m) and E do not change when a row is
// shifted, so neither do the statistics, the reverse scan or the dA fold.
//
// Bound on an H100 SXM at the main path's shape (B=32, T=127, S=256, f32):
// 2*T*B*S*S = 0.53 GFLOP of FMAs, 8 us at the data-sheet 67 TFLOP/s f32
// rate outside the tensor cores; the inputs and outputs are 4.4 MB, 1.3 us
// at 3.35 TB/s.  But the T steps depend on each other, and each is a tiny
// (B, S) @ (S, S) product, so latency sets the time, not either bound.
//
// Two routes, chosen by shape in the wrapper before the launch
// (ops/markov_scan.py::plan_scan):
//
// The cluster route (msc_*), for every S whose Q = exp(A - c) fits in the
// shared memory of a thread-block cluster.  A cluster of C CTAs takes a
// group of rows (all of them share A, or one row with its own A); CTA k
// owns the columns r in [k W, (k+1) W), W = ceil(S / C), and keeps its
// slice Q[:, slice] in shared memory for all T steps (read from A once, in
// the prologue; its column maxima are local to the slice).  A step is
// latency, not arithmetic, so the design removes waits from the step:
// - Forward step: every CTA holds the full carry rows, takes their max
//   itself (each row cut into segments over the warps), computes its slice
//   of z = exp(h - m) @ Q on the f32 CUDA cores (register-blocked, p read
//   as 16-byte vectors), and stores its slice of alpha_t+1 into every
//   peer's copy of the rows with st.async, each store counted on the
//   receiver's mbarrier (transaction bytes).  The carry rows are
//   double-buffered, so the one wait a step is the receiver's wait on that
//   mbarrier: no cluster barrier.  A peer can write a buffer again only
//   after it has this CTA's next carry, which this CTA sends after reading
//   the buffer, so the data dependencies order every reuse.
// - Backward: the per-step statistics (the maxima xs, cr, crc and the clip
//   classes) come from the saved stacks, not from the gradient, so one
//   parallel kernel (msc_stats_kernel) computes them for all T*B rows
//   first, a warp per row with the streaming kernel's float expressions
//   (one decision per row, so the clip classes agree across the cluster),
//   together with the fold's inputs.  The reverse scan then reads only its
//   own columns' factors, a step ahead.  rx[l] = sum_r u[r] Q[l, r] is a
//   sum over every CTA's own columns r, so each CTA pushes its partial sums
//   to the CTA that owns l (a reduce-scatter through distributed shared
//   memory with st.async, double-buffered, one mbarrier wait a step; the
//   second clip class rides on the same phase) and adds the C partials in
//   rank order, which makes the result the same run to run.  Every CTA
//   must own a column: one without would wait for nothing and run ahead of
//   its peers' buffers.
//
// The streaming route (ms_forward_kernel, ms_backward_kernel), for larger S
// up to the wrapper's MAX_STATES: one block owns one row b and loops over t.
// Q does not fit in one block's 227 KB of shared memory at S=256 (256 KB),
// so a prologue kernel writes Q once, and every step re-reads Q from L2
// (S*S*4 bytes per step per block); the carry, the shifted exponentials
// and the reductions stay in shared memory.  The block has 1024 threads:
// each column's dot product is split in four quarters of l, which keeps
// four times as many L2 loads in flight as one thread per column would.
//
// Backward (the reverse scan of the VJP), both routes: for t = T-1 .. 0,
// with g = dloss/dalpha_t+1, dR_t = g; h_t and exp(h_t - m) are recomputed
// from the saved carry alpha_t, and the forward's saved z_t is read (so
// out_t = log z + m + c is bit-identical to the forward's; saving z spares
// the backward one of its two products per step); then the bounded
// backward of logmatmulexp:
//   E  = -(out - m - c)        cr = max_r E
//   rx = (g * exp(E - cr)) @ Q^T
//   dh = sign(rx) * exp(h - m + cr + log(|rx| + FLT_MIN)),
// with the clipped entries (below) a class of their own: each class has its
// own cr and rx, and dh sums the classes' terms; the second product runs
// only at a step whose rows hold a clipped entry.
// dL_t = dh, and g becomes dh; the last dh is dalpha_0.  The scan writes
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
// stream and returns the launch's error code (a refused launch, for too
// large a cluster or too much shared memory, among them).

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its encoder's types; the encoder itself comes from the runtime
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <string.h>

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
  double norm = 0.0;  // the row's shifts so far (the same in every thread)
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
    norm += (double)m;
    for (int l = tid; l < S; l += NTS) p[l] = expf(p[l] - m);
    __syncthreads();
    block_col_dot(p, Qa, S, z, part_sums);
    for (int r = tid; r < S; r += NTS) {
      zs[row + r] = z[r];
      alpha[r] = logf(fmaxf(z[r], FLT_MIN)) + finite_or_zero(ca[r]) + R[row + r];
    }
    __syncthreads();
  }
  for (int r = tid; r < S; r += NTS) out[(long long)b * S + r] = (float)((double)alpha[r] + norm);
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

// ----------------------------------------------------------- cluster route --

namespace cg = cooperative_groups;

#define NTC 256   // threads of a CTA of the cluster kernels
#define MAXE 8    // elements of a CTA's rows that one thread takes in the row passes
#define MAXO 4    // outputs of a CTA that one thread takes in the forward's epilogue

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }
// Columns per CTA, W; rows of the Q slice and of the exchanged vectors are
// padded to W4 = round4(W) columns (zeros), and Q's row stride is W4 + 1,
// odd, so that lanes that walk down a column (the backward) and lanes that
// walk along a row (the forward) both hit distinct banks.
__host__ __device__ __forceinline__ int cl_width(int S, int C) { return (S + C - 1) / C; }

// The row passes cut each of a CTA's nr rows into wpr segments, one warp
// each (wpr a power of two, as large as the 8 warps allow); a lane takes
// every 32nd element of its segment.  Elements per lane:
__host__ __device__ __forceinline__ int cl_wpr(int nr) {
  int w = 1;
  while (2 * w * nr <= NTC / 32) w *= 2;
  return w;
}
__host__ __device__ __forceinline__ int cl_slots(int S, int nr) {
  const int wpr = cl_wpr(nr), groups = NTC / 32 / wpr, seglen = (S + wpr - 1) / wpr;
  return (nr + groups - 1) / groups * ((seglen + 31) / 32);
}
// Whether the kernels take (S, C, rows): every CTA owns a column (a CTA
// without one would wait for no partials in the backward and run ahead of
// its peers, whose receive buffers are safe to reuse only because every
// CTA waits for every step's partials), the row passes and the forward's
// epilogue fit the threads' registers, and the forward's product has a
// thread for each padded column.
__host__ __device__ __forceinline__ bool cl_takes(int S, int C, int rows) {
  return C >= 1 && rows >= 1 && (C - 1) * cl_width(S, C) < S && cl_slots(S, rows) <= MAXE &&
         rows * cl_width(S, C) <= MAXO * NTC && round4(cl_width(S, C)) <= NTC;
}

// Dynamic shared memory, in floats, of a CTA of each cluster kernel; the
// kernels below cut it in this order, every part a multiple of 16 bytes.
__host__ __device__ __forceinline__ long long cl_forward_floats(int S, int C, int rows) {
  const long long W4 = round4(cl_width(S, C)), S4 = round4(S), R = rows;
  return 4                          // the mbarriers of the two carry buffers
         + round4(S4 * (W4 + 1))    // Q slice
         + 3 * R * S4               // carry rows (two buffers), p
         + R * NTC                  // the product's partial sums
         + R * W4                   // the new carry's own columns
         + 8 * R + round4(2 * R) + W4;  // segment maxima, the rows' summed shifts (double), column shifts
}
__host__ __device__ __forceinline__ long long cl_backward_floats(int S, int C, int rows) {
  const long long W4 = round4(cl_width(S, C)), S4 = round4(S), R = rows;
  return 4                          // the mbarriers of the two receive buffers
         + round4(S4 * (W4 + 1))    // Q slice
         + 4 * C * R * W4           // received partials: two buffers, two classes, C sources
         + 2 * R * S4               // the product's partials of both classes, before they are sent
         + 2 * R * W4;              // u of both classes
}

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// The same shared-memory address in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// The local arrival of a phase that completes when `bytes` more have come.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Store 4 or 16 bytes at cluster address `addr` and count them on the
// mbarrier at cluster address `bar` (both in the same CTA).
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async4(unsigned addr, float4 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)), "r"(__float_as_uint(v.z)),
               "r"(__float_as_uint(v.w)), "r"(bar)
               : "memory");
}

// A thread's elements of the CTA's rows in the row passes: element i is
// (row, l) = (rows_[i], ls[i]), l < 0 where the thread has none.
template <int ME>
struct RowSlots {
  int wpr, seg, js, n;
  unsigned starts, ends;  // bit i: slot i is the first, the last of its row in this thread
  int rows_[ME], ls[ME];
  __device__ __forceinline__ RowSlots(int S, int nr) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    wpr = cl_wpr(nr);
    const int groups = NTC / 32 / wpr, seglen = (S + wpr - 1) / wpr;
    seg = warp % wpr;
    js = (seglen + 31) / 32;
    n = cl_slots(S, nr);
    const int end = min(S, (seg + 1) * seglen);
    starts = ends = 0;
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      const int row = warp / wpr + (i / js) * groups, l = seg * seglen + lane + 32 * (i % js);
      rows_[i] = row;
      ls[i] = (i < n && row < nr && l < end) ? l : -1;
      if (i < n && i % js == 0) starts |= 1u << i;
      if (i < n && (i + 1) % js == 0) ends |= 1u << i;
    }
  }
};

// The maxima over each (row, segment) of the values v[i] of the row
// passes' elements (-inf where a thread has none) into
// seg_max[row * wpr + segment]; ends synchronised.
template <int ME>
__device__ __forceinline__ void segment_max(const RowSlots<ME>& e, const float (&v)[ME], int nr, float* seg_max) {
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < ME; ++i) {
    if (i < e.n) {
      mx = fmaxf(mx, v[i]);
      if (e.ends >> i & 1) {
        mx = warp_max(mx);
        if ((threadIdx.x & 31) == 0 && e.rows_[i] < nr) seg_max[e.rows_[i] * e.wpr + e.seg] = mx;
        mx = -INFINITY;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float row_max(const float* seg_max, int row, int wpr) {
  float m = -INFINITY;
  for (int s = 0; s < wpr; ++s) m = fmaxf(m, seg_max[row * wpr + s]);
  return m;
}

// A thread's outputs (row, w) of the CTA's own columns, o = tid + i NTC
// over the nr x W outputs; w < 0 where it has none.
struct OwnOutputs {
  int row[MAXO], w[MAXO];
  __device__ __forceinline__ OwnOutputs(int nr, int W, int wn) {
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int o = threadIdx.x + i * NTC;
      row[i] = o / W;
      w[i] = (o < nr * W && o % W < wn) ? o % W : -1;
    }
  }
};

#define MAXS 2  // send items of a thread with precomputed addresses; more go through a plain loop

// Grid: clusters of C CTAs along x; cluster i takes rows [i rows, (i+1)
// rows) of a shared A, or row i and its own A (per_row_A, rows == 1).
// Writes alphas and zs (T, B, S) and out (B, S) for each CTA's own
// columns, and craw (nA, S), the raw column maxima of A, for the backward.
// out[r * ostride] = sum over l in [l_begin, l_end) of p[r * pstride + l] *
// q[l * qstride] for NR rows r: the forward's product over one chunk of l,
// p read as 16-byte vectors (l_begin and l_end multiples of 4).
template <int NR>
__device__ __forceinline__ void chunk_product(const float* q, int qstride, const float* p, int pstride, int l_begin,
                                              int l_end, float* out, int ostride) {
  float acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.f;
#pragma unroll 2
  for (int l = l_begin; l < l_end; l += 4) {
    const float q0 = q[l * qstride], q1 = q[(l + 1) * qstride], q2 = q[(l + 2) * qstride], q3 = q[(l + 3) * qstride];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float4 pv = *reinterpret_cast<const float4*>(p + r * pstride + l);
      acc[r] = fmaf(pv.x, q0, acc[r]);
      acc[r] = fmaf(pv.y, q1, acc[r]);
      acc[r] = fmaf(pv.z, q2, acc[r]);
      acc[r] = fmaf(pv.w, q3, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) out[r * ostride] = acc[r];
}

template <int ME>
__global__ void __launch_bounds__(NTC, 1) msc_forward_kernel(const float* __restrict__ alpha0,
                                                          const float* __restrict__ A,
                                                          const float* __restrict__ R,
                                                          const float* __restrict__ L, int B, int T, int S,
                                                          int per_row_A, int rows, float* __restrict__ alphas,
                                                          float* __restrict__ zs, float* __restrict__ out,
                                                          float* __restrict__ craw) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C;
  const int W = cl_width(S, C), W4 = round4(W), QP = W4 + 1, S4 = round4(S);
  const int r0 = k * W, wn = max(0, min(W, S - r0));
  const int b0 = cid * rows, nr = min(rows, B - b0);
  const long long a = per_row_A ? cid : 0;
  const int tid = threadIdx.x;
  // the carry goes to the peers as 16-byte vectors where the columns allow
  const bool vec = W % 4 == 0 && S % 4 == 0;
  extern __shared__ float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // [2]
  float* Qs = smem + 4;                            // [S4][QP]
  float* hbuf = Qs + round4(S4 * QP);              // [2][rows][S4]
  float* p = hbuf + 2 * rows * S4;                 // [rows][S4]
  float* red = p + rows * S4;                      // [parts][rows][W4]
  float* vbuf = red + rows * NTC;                  // [rows][W4]
  float* seg_max = vbuf + rows * W4;               // [rows][8]
  double* nrm = reinterpret_cast<double*>(seg_max + 8 * rows);  // [rows], 16-byte aligned
  float* cs = seg_max + 8 * rows + round4(2 * rows);  // [W4]
  const RowSlots<ME> e(S, nr);
  const OwnOutputs own(nr, W, wn);
  // the sends of a step: item x = (peer j, row, column or vector of 4
  // columns q) into the peer's carry row at r0 + q (4 q), from vbuf
  const int nq = vec ? (wn + 3) / 4 : wn, nsend = C * nr * nq;
  int send_j[MAXS], send_dst[MAXS], send_src[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int x = tid + i * NTC, j = x % C, row = (x / C) / max(nq, 1), q = (x / C) % max(nq, 1);
    send_j[i] = x < nsend ? j : -1;
    send_dst[i] = row * S4 + r0 + (vec ? 4 * q : q);
    send_src[i] = row * W4 + (vec ? 4 * q : q);
  }

  // prologue: A's slice, its column maxima, Q = exp(A - c) in place
  const float* Aa = A + a * S * S;
  for (int x = tid; x < S4 * W4; x += NTC) {
    const int l = x / W4, w = x % W4;
    Qs[l * QP + w] = (w < wn && l < S) ? Aa[(long long)l * S + r0 + w] : -INFINITY;
  }
  for (int x = tid; x < rows * S4; x += NTC) p[x] = 0.f;  // the padding columns stay 0
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]));
    mbar_init(smem_addr(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int np = NTC / W4;
  for (int x = tid; x < np * W4; x += NTC) {
    const int w = x % W4, part = x / W4;
    float mx = -INFINITY;
    for (int l = part; l < S; l += np) mx = fmaxf(mx, Qs[l * QP + w]);
    red[part * W4 + w] = mx;
  }
  __syncthreads();
  for (int w = tid; w < W4; w += NTC) {
    float mx = -INFINITY;
    for (int part = 0; part < np; ++part) mx = fmaxf(mx, red[part * W4 + w]);
    if (w < wn && (per_row_A || cid == 0)) craw[a * S + r0 + w] = mx;
    cs[w] = finite_or_zero(mx);
  }
  __syncthreads();
  for (int x = tid; x < S4 * W4; x += NTC) {
    const int l = x / W4, w = x % W4;
    Qs[l * QP + w] = (w < wn && l < S) ? expf(Qs[l * QP + w] - cs[w]) : 0.f;
  }
  for (int x = tid; x < nr * S; x += NTC) hbuf[(x / S) * S4 + x % S] = alpha0[(long long)b0 * S + x];
  for (int x = tid; x < rows; x += NTC) nrm[x] = 0.0;
  // the first step's L, in the registers of the row passes
  float lv[ME];
#pragma unroll
  for (int i = 0; i < ME; ++i)
    lv[i] = (L && e.ls[i] >= 0) ? L[(long long)b0 * S + e.rows_[i] * S + e.ls[i]] : 0.f;
  // each step's carry comes from the cluster's CTAs: nr rows of their
  // columns (whole vectors of 4 where vec)
  unsigned carry_bytes = 0;
  for (int j = 0; j < C; ++j) {
    const int wj = max(0, min(W, S - j * W));
    carry_bytes += 4u * nr * (vec ? round4(wj) : wj);
  }
  if (tid == 0 && T > 1) mbar_expect(smem_addr(&bars[1]), carry_bytes);
  cluster.sync();  // every peer runs, its mbarriers initialised, before the first remote store

  // the product: thread (w, part) sums l over its part's chunk of S4
  const int nparts = NTC / W4, chunk = round4((S4 + nparts - 1) / nparts);
  const int pw = tid % W4, part = tid / W4;
  const int l_begin = min(S4, part * chunk), l_end = min(S4, l_begin + chunk);
  for (int t = 0; t < T; ++t) {
    const float* cur = hbuf + (t & 1) * rows * S4;
    const unsigned nxt = smem_addr(hbuf + ((t + 1) & 1) * rows * S4);
    const unsigned nxt_bar = smem_addr(&bars[(t + 1) & 1]);
    const long long step = ((long long)t * B + b0) * S;
    float rv[MAXO];
#pragma unroll
    for (int i = 0; i < MAXO; ++i) rv[i] = own.w[i] >= 0 ? R[step + (long long)own.row[i] * S + r0 + own.w[i]] : 0.f;
    if (t > 0) mbar_wait(smem_addr(&bars[t & 1]), ((t - 1) >> 1) & 1);
    // the step after next comes into the buffer this step reads
    if (tid == 0 && t + 2 < T) mbar_expect(smem_addr(&bars[t & 1]), carry_bytes);
    // h = alpha + L, its row max m, p = exp(h - m); the carry stack for
    // the own columns.  Loads first, then arithmetic, then stores.
    float h[ME];
#pragma unroll
    for (int i = 0; i < ME; ++i) h[i] = e.ls[i] >= 0 ? cur[e.rows_[i] * S4 + e.ls[i]] : -INFINITY;
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      if (e.ls[i] >= 0) {
        if ((unsigned)(e.ls[i] - r0) < (unsigned)wn) alphas[step + e.rows_[i] * S + e.ls[i]] = h[i];
        if (L) h[i] += lv[i];
      }
    }
    if (L && t + 1 < T) {
#pragma unroll
      for (int i = 0; i < ME; ++i)
        if (e.ls[i] >= 0) lv[i] = L[step + (long long)B * S + e.rows_[i] * S + e.ls[i]];
    }
    segment_max(e, h, nr, seg_max);
    float m[ME];
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      if (i < e.n) {
        m[i] = (e.starts >> i & 1 && e.rows_[i] < nr) ? finite_or_zero(row_max(seg_max, e.rows_[i], e.wpr))
                                                   : m[i > 0 ? i - 1 : 0];
        h[i] = expf(h[i] - m[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      if (e.ls[i] >= 0) {
        p[e.rows_[i] * S4 + e.ls[i]] = h[i];
        if (e.ls[i] == 0) nrm[e.rows_[i]] += (double)m[i];
      }
    }
    __syncthreads();
    // z[row, w] over the thread's chunk of l, four rows at a time, p read
    // as 16-byte vectors
    if (part < nparts) {
      for (int rc = 0; rc < nr; rc += 4) {
        float* dst = red + (part * rows + rc) * W4 + pw;
        const float* pr = p + rc * S4;
        switch (min(4, nr - rc)) {
          case 1: chunk_product<1>(Qs + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          case 2: chunk_product<2>(Qs + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          case 3: chunk_product<3>(Qs + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          default: chunk_product<4>(Qs + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
        }
      }
    }
    __syncthreads();
    // the parts in a fixed order; alpha_t+1 of the own columns into vbuf
    // (into out at the last step)
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int row = own.row[i], w = own.w[i];
      if (w < 0) continue;
      float z = red[row * W4 + w];
      for (int q = 1; q < nparts; ++q) z += red[(q * rows + row) * W4 + w];
      const int r = r0 + w;
      zs[step + (long long)row * S + r] = z;
      const float v = logf(fmaxf(z, FLT_MIN)) + cs[w] + rv[i];
      if (t == T - 1) out[(long long)(b0 + row) * S + r] = (float)((double)v + nrm[row]);
      else vbuf[row * W4 + w] = v;
    }
    if (t + 1 < T) {
      __syncthreads();
      // vbuf into every peer's next carry buffer, counted on its mbarrier
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        const int j = send_j[i];
        if (j < 0) continue;
        if (vec)
          st_async4(peer_addr(nxt + 4u * send_dst[i], j), *reinterpret_cast<const float4*>(vbuf + send_src[i]),
                    peer_addr(nxt_bar, j));
        else
          st_async(peer_addr(nxt + 4u * send_dst[i], j), vbuf[send_src[i]], peer_addr(nxt_bar, j));
      }
      for (int x = tid + MAXS * NTC; x < nsend; x += NTC) {
        const int j = x % C, row = (x / C) / nq, q = (x / C) % nq;
        if (vec)
          st_async4(peer_addr(nxt + 4u * (row * S4 + r0 + 4 * q), j),
                    *reinterpret_cast<const float4*>(vbuf + row * W4 + 4 * q), peer_addr(nxt_bar, j));
        else
          st_async(peer_addr(nxt + 4u * (row * S4 + r0 + q), j), vbuf[row * W4 + q], peer_addr(nxt_bar, j));
      }
    }
    __syncthreads();
  }
}

// The statistics of the reverse scan's steps, which the saved stacks fix
// before the scan starts: one warp per row (t, b) computes xs, cr and crc
// over the full row with the streaming kernel's float expressions, and
// writes per entry the fold's inputs P, W, Wc and the scan's factors
//   G0 = h - xs + cr,  G1 = h - xs + crc,
//   F0 = exp(E0 - cr), F1 = exp(E1 - crc) (0 without a clipped entry),
// E0 and E1 the unclipped and clipped classes of E (-inf outside them),
// crcs[t, b] = crc, and two[t, group] = 1 where a row of the cluster's
// group of `rows` rows holds a clipped entry.
__global__ void __launch_bounds__(NT) msc_stats_kernel(
    const float* __restrict__ alphas, const float* __restrict__ zs, const float* __restrict__ L,
    const float* __restrict__ craw, int B, int T, int S, int per_row_A, int rows, int* __restrict__ two,
    float* __restrict__ G0, float* __restrict__ G1, float* __restrict__ F0, float* __restrict__ F1,
    float* __restrict__ crcs, float* __restrict__ P, float* __restrict__ Wo, float* __restrict__ Wc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (NT / 32) + warp;
  if (i >= (long long)T * B) return;
  const int b = (int)(i % B);
  const float* ca = craw + (per_row_A ? (long long)b * S : 0);
  const long long base = i * S;
  float xr = -INFINITY;
  for (int l = lane; l < S; l += 32) xr = fmaxf(xr, L ? alphas[base + l] + L[base + l] : alphas[base + l]);
  xr = warp_max(xr);
  const float xs = finite_or_zero(xr);
  const bool live = xr > -INFINITY;
  float cr = -INFINITY, crc = -INFINITY;
  for (int r = lane; r < S; r += 32) {
    const float c = finite_or_zero(ca[r]);
    const float zr = zs[base + r];
    const float o = logf(fmaxf(zr, FLT_MIN)) + xs + c;
    const float E = -(o - xs - c);
    if (zr <= FLT_MIN) crc = fmaxf(crc, E); else cr = fmaxf(cr, E);
  }
  cr = finite_or_zero(warp_max(cr));
  crc = warp_max(crc);
  for (int l = lane; l < S; l += 32) {
    const float h = L ? alphas[base + l] + L[base + l] : alphas[base + l];
    const float c = finite_or_zero(ca[l]);
    const float zr = zs[base + l];
    const float o = logf(fmaxf(zr, FLT_MIN)) + xs + c;
    const float E = -(o - xs - c);
    const bool clipped = zr <= FLT_MIN;
    P[base + l] = expf(h - xs);
    Wo[base + l] = live && !clipped ? E : -INFINITY;
    Wc[base + l] = live && clipped ? E : -INFINITY;
    G0[base + l] = h - xs + cr;
    G1[base + l] = h - xs + crc;
    F0[base + l] = expf((clipped ? -INFINITY : E) - cr);
    F1[base + l] = crc > -INFINITY ? expf((clipped ? E : -INFINITY) - crc) : 0.f;
  }
  if (lane == 0) {
    crcs[i] = crc;
    if (crc > -INFINITY) atomicOr(&two[(i / B) * ((B + rows - 1) / rows) + b / rows], 1);
  }
}

// The reverse scan on the forward's cluster layout, after msc_stats_kernel.
// Writes dR, dL (if L) and dalpha0 for each CTA's own columns.
__global__ void __launch_bounds__(NTC, 1) msc_backward_kernel(
    const float* __restrict__ G0, const float* __restrict__ G1, const float* __restrict__ F0,
    const float* __restrict__ F1, const float* __restrict__ crcs, const int* __restrict__ two_of,
    const float* __restrict__ A, const float* __restrict__ craw, const float* __restrict__ gout, int B, int T,
    int S, int per_row_A, int rows, float* __restrict__ dR, float* __restrict__ dL,
    float* __restrict__ dalpha0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, groups = gridDim.x / C;
  const int W = cl_width(S, C), W4 = round4(W), QP = W4 + 1, S4 = round4(S);
  const int r0 = k * W, wn = max(0, min(W, S - r0));
  const int b0 = cid * rows, nr = min(rows, B - b0);
  const long long a = per_row_A ? cid : 0;
  const int tid = threadIdx.x, RW = rows * W4;
  // the partials go to their owners as 16-byte vectors where the columns allow
  const bool vec = W % 4 == 0;
  extern __shared__ float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // [2]
  float* Qs = smem + 4;                  // [S4][QP]
  float* recv = Qs + round4(S4 * QP);    // [2 buffers][2 classes][C sources][rows][W4]
  float* stage = recv + 4 * C * RW;      // [2 classes][rows][S4]
  float* u0 = stage + 2 * rows * S4;     // [rows][W4]
  float* u1 = u0 + RW;
  const OwnOutputs own(nr, W, wn);
  // the sends of a step, per class: item x = (row, l or vector of 4 l) to
  // the owner j of l, into the source's place of its receive buffer
  const int nq = vec ? (S + 3) / 4 : S, nsend = nr * nq;
  int send_j[MAXS], send_dst[MAXS], send_src[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int x = tid + i * NTC, row = x / nq, l = vec ? 4 * (x % nq) : x % nq, j = l / W;
    send_j[i] = x < nsend ? j : -1;
    send_dst[i] = row * W4 + l - j * W;
    send_src[i] = row * S4 + l;
  }
  // the factors of the own outputs at step t, in registers
  float g0[MAXO], g1[MAXO], cc[MAXO], f0[MAXO], f1[MAXO];
  auto load_factors = [&](int t) {
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      if (own.w[i] >= 0) {
        const long long row = (long long)t * B + b0 + own.row[i], x = row * S + r0 + own.w[i];
        g0[i] = G0[x];
        g1[i] = G1[x];
        f0[i] = F0[x];
        f1[i] = F1[x];
        cc[i] = crcs[row];
      }
    }
  };

  // prologue: Q's slice from A and the forward's column maxima (the same
  // float expression as the forward's), u of step T-1
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]));
    mbar_init(smem_addr(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const float* Aa = A + a * S * S;
  for (int x = tid; x < S4 * W4; x += NTC) {
    const int l = x / W4, w = x % W4;
    Qs[l * QP + w] = (w < wn && l < S) ? expf(Aa[(long long)l * S + r0 + w] - finite_or_zero(craw[a * S + r0 + w]))
                                        : 0.f;
  }
  for (int o = tid; o < RW; o += NTC) u0[o] = u1[o] = 0.f;
  __syncthreads();
  load_factors(T - 1);
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int row = own.row[i], w = own.w[i];
    if (w < 0) continue;
    const float g = gout[(long long)(b0 + row) * S + r0 + w];
    dR[((long long)(T - 1) * B + b0 + row) * S + r0 + w] = g;
    u0[row * W4 + w] = g * f0[i];
    u1[row * W4 + w] = cc[i] > -INFINITY ? g * f1[i] : 0.f;
  }
  // what each step brings: the C sources' partials of this CTA's columns
  const unsigned part_bytes = 4u * C * nr * (vec ? round4(wn) : wn);
  // each step's phase is expected a step ahead, before any of its data can
  // come: a peer sends step t's partials only after it has this CTA's of
  // step t + 1
  int two = two_of[(long long)(T - 1) * groups + cid];
  int two_next = T > 1 ? two_of[(long long)(T - 2) * groups + cid] : 0;
  if (tid == 0) mbar_expect(smem_addr(&bars[(T - 1) & 1]), part_bytes * (two ? 2 : 1));
  cluster.sync();  // every peer runs, its mbarriers initialised, before the first remote store

  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    const unsigned bar = smem_addr(&bars[par]);
    if (tid == 0 && t > 0) mbar_expect(smem_addr(&bars[par ^ 1]), part_bytes * (two_next ? 2 : 1));
    const int two_after = t > 1 ? two_of[(long long)(t - 2) * groups + cid] : 0;
    float dh_g0[MAXO], dh_g1[MAXO], dh_cc[MAXO];
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      dh_g0[i] = g0[i];
      dh_g1[i] = g1[i];
      dh_cc[i] = cc[i];
    }
    if (t > 0) load_factors(t - 1);  // in flight during the product
    // partial rx[row, l] over the own columns, four rows at a time, u read
    // as 16-byte vectors
    for (int l = tid; l < S; l += NTC) {
      const float* q = Qs + l * QP;
      for (int rc = 0; rc < nr; rc += 4) {
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
        for (int w = 0; w < W4; w += 4) {
          const float q0 = q[w], q1 = q[w + 1], q2 = q[w + 2], q3 = q[w + 3];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (rc + r < nr) {
              const float4 v = *reinterpret_cast<const float4*>(u0 + (rc + r) * W4 + w);
              a0[r] = fmaf(v.x, q0, a0[r]);
              a0[r] = fmaf(v.y, q1, a0[r]);
              a0[r] = fmaf(v.z, q2, a0[r]);
              a0[r] = fmaf(v.w, q3, a0[r]);
              if (two) {
                const float4 v1 = *reinterpret_cast<const float4*>(u1 + (rc + r) * W4 + w);
                a1[r] = fmaf(v1.x, q0, a1[r]);
                a1[r] = fmaf(v1.y, q1, a1[r]);
                a1[r] = fmaf(v1.z, q2, a1[r]);
                a1[r] = fmaf(v1.w, q3, a1[r]);
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (rc + r < nr) {
            stage[(rc + r) * S4 + l] = a0[r];
            if (two) stage[(rows + rc + r) * S4 + l] = a1[r];
          }
        }
      }
    }
    __syncthreads();
    // the partials to the owners of their l, into the source's place of
    // their receive buffer, counted on their mbarrier
    const unsigned rbase = smem_addr(recv + par * 2 * C * RW + k * RW);
    for (int cls = 0; cls < (two ? 2 : 1); ++cls) {
      const unsigned dst = rbase + 4u * cls * C * RW;
      const float* src = stage + cls * rows * S4;
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        const int j = send_j[i];
        if (j < 0) continue;
        if (vec)
          st_async4(peer_addr(dst + 4u * send_dst[i], j), *reinterpret_cast<const float4*>(src + send_src[i]),
                    peer_addr(bar, j));
        else
          st_async(peer_addr(dst + 4u * send_dst[i], j), src[send_src[i]], peer_addr(bar, j));
      }
      for (int x = tid + MAXS * NTC; x < nsend; x += NTC) {
        const int row = x / nq, l = vec ? 4 * (x % nq) : x % nq, j = l / W;
        if (vec)
          st_async4(peer_addr(dst + 4u * (row * W4 + l - j * W), j),
                    *reinterpret_cast<const float4*>(src + row * S4 + l), peer_addr(bar, j));
        else
          st_async(peer_addr(dst + 4u * (row * W4 + l - j * W), j), src[row * S4 + l], peer_addr(bar, j));
      }
    }
    mbar_wait(bar, ((T - 1 - t) >> 1) & 1);
    // rx of the own rows l: the C sources in rank order; dh, then u of the
    // step before
    const float* rb = recv + par * 2 * C * RW;
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int row = own.row[i], w = own.w[i], x = row * W4 + w;
      if (w < 0) continue;
      float rx = 0.f;
      for (int j = 0; j < C; ++j) rx += rb[j * RW + x];
      const float sg = (float)(rx > 0.f) - (float)(rx < 0.f);
      float dh = sg * expf(dh_g0[i] + logf(fabsf(rx) + FLT_MIN));
      if (dh_cc[i] > -INFINITY) {
        float rc = 0.f;
        for (int j = 0; j < C; ++j) rc += rb[(C + j) * RW + x];
        const float sc = (float)(rc > 0.f) - (float)(rc < 0.f);
        dh += sc * expf(dh_g1[i] + logf(fabsf(rc) + FLT_MIN));
      }
      const int r = r0 + w;
      if (dL) dL[((long long)t * B + b0 + row) * S + r] = dh;
      if (t > 0) {
        dR[((long long)(t - 1) * B + b0 + row) * S + r] = dh;
        u0[x] = dh * f0[i];
        u1[x] = cc[i] > -INFINITY ? dh * f1[i] : 0.f;
      } else {
        dalpha0[(long long)(b0 + row) * S + r] = dh;
      }
    }
    two = two_next;
    two_next = two_after;
    __syncthreads();
  }
}

// ------------------------------------------------------------ C interface --

// Each kernel's attributes, set once per device and process: the largest
// dynamic shared memory the device grants a block, and, for the cluster
// kernels, clusters of more than 8 CTAs (the non-portable sizes).
static int set_attributes(void) {
  static bool done[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && done[dev]) return 0;
  int optin = 0;
  err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  const void* dynamic[] = {(const void*)ms_forward_kernel, (const void*)ms_backward_kernel,
                           (const void*)msc_forward_kernel<4>, (const void*)msc_forward_kernel<8>,
                           (const void*)msc_backward_kernel};
  for (const void* f : dynamic) {
    err = (int)cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err) return err;
  }
  const void* clustered[] = {(const void*)msc_forward_kernel<4>, (const void*)msc_forward_kernel<8>,
                             (const void*)msc_backward_kernel};
  for (const void* f : clustered) {
    err = (int)cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  if (dev < 64) done[dev] = true;
  return 0;
}

// The launch configuration of a cluster kernel: `clusters` clusters of C
// CTAs of NTC threads.
// Each entry point reads its launches' errors with cudaGetLastError, which
// also returns an error an earlier call of this library left unread (a
// refused cluster launch returns its error without reading it): clear that
// first, so that a refused launch does not fail the next one.
static void clear_last_error(void) { (void)cudaGetLastError(); }

struct ClusterLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  ClusterLaunch(int C, int clusters, size_t smem, cudaStream_t st) : cfg(), attr() {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(C * clusters);
    cfg.blockDim = dim3(NTC);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

// The dA fold after either route's reverse scan: column maxima of W and
// Wc, the split products, the epilogue.
static int fold_dA(const float* A, const float* craw, const float* dR, int B, int T, int S, int nA, int splits,
                   float* dA, const float* P, const float* W, const float* Wc, float* cc, float* partial,
                   cudaStream_t st) {
  const int per_row_A = nA > 1;
  dim3 colmax_grid((S + CM_COLS - 1) / CM_COLS, nA);
  ms_colmax_kernel<<<colmax_grid, CM_THREADS, 0, st>>>(W, Wc, B, T, S, per_row_A, cc);
  int err = (int)cudaGetLastError();
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

// ------------------------------------------------- time-varying scan (K2g) --
//
// The general body of pyro_tpu/ops/markov_product.py:427-451 (scanned at
// :469), for a transition that varies with time:
//
//   alpha_t+1 = R_t + logsumexp_l(alpha_t + L_t + A_t)     t = 0 .. T-1
//
// with A_t (T, S, S) shared by the B rows or (T, B, S, S) one per row.
// Unlike K2 its values are the body's own, -inf for a state that no path
// reaches (not log(FLT_MIN)), so each column's logsumexp is shifted by the
// column's own max, term by term (an online max with one rescale per four
// terms): no term underflows where a column has a finite one, and a column
// that has none is -inf.  The gradient through such a column, and through
// every -inf entry, is 0 (the reference's NaN there is a fault of
// jax.scipy.special.logsumexp, not copied).  The carry is kept shifted as
// K2's: the kernels carry alpha less the row maxima so far (hs = h - m is
// what a step adds to A_t) and sum the shifts in double.
//
// Bound on an H100 SXM at model_1vt's shape (B=32, T=127, S=256, A_t shared,
// f32): the bytes, 33.3 MB of A_t plus 4.2 MB of R, 11 us at 3.35 TB/s (the
// backward also writes dA_t: about 24 us); 0.53 G exponentials and adds.
// As K2's, each step is a chain of dependent block phases, so latency, and
// the SFU's 16 exponentials a clock per SM, set the time at 32 SMs.
//
// Two routes, chosen by shape in the wrapper before the launch
// (ops/markov_scan.py::plan_scan_tv), as K2's: the cluster route (mstvc_*,
// below), wherever a CTA's staged slice of A_t and its E fit in shared
// memory, and the streaming route (mstv_*, here) for larger S.  Both read
// A_t by its strides (TvStrides).
//
// Streaming forward (mstv_forward_kernel): one block of NTS threads per row b, as K2's
// streaming route; thread (part, c) runs the online logsumexp of column c
// over the part-th quarter of l, A_t read from L2/HBM each step (A_t does
// not fit one block's shared memory at S=256), the quarters merged in a
// fixed order.  It writes hs_t and o_t = logsumexp_l(hs_t + A_t) (T, B, S)
// for the backward.
//
// Streaming backward: the reverse scan (mstv_backward_kernel, a block per row) with
// w_t[l, r] = exp(hs_t[l] + A_t[l, r] - o_t[r]) recomputed from the stacks
// (0 where o_t[r] is -inf): dR_t = g, dh[l] = sum_r g[r] w[l, r] by a warp
// per l (lanes over r, a shuffle tree), dL_t = dh, g = dh.  Then the fold
// (mstv_fold_kernel), fully parallel: dA_t[l, r] = sum of g_t[r] w_t[l, r]
// over the rows that use A_t, in row order: no atomics, so two runs give
// the same bits.

#define FOLD_L 16  // rows l of dA_t a thread of the fold takes

// A_t's strides in elements: A_t[l, r] of row b is A[t sa.t + b sa.b + l sa.l + r]
// (sa.b unused where A_t is shared), so a transition constant in time
// (sa.t = 0) is read in place.
struct TvStrides {
  long long t, b;
  int l;  // below 2^31 (the wrapper copies A otherwise)
};

// Ask L2 for the S rows (l stride sl) of S floats at `next`, the transition
// of the step after this one, which does not depend on the carry: block
// `part` of `parts` blocks reading the same matrix asks for every
// parts-th line of 32 floats.
__device__ __forceinline__ void prefetch_next(const float* next, int S, int sl, int part, int parts) {
  const int per_row = (S + 31) / 32, lines = S * per_row;
  for (int i = part + threadIdx.x * parts; i < lines; i += NTS * parts) {
    const int l = i / per_row, j = i - l * per_row;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(next + (long long)l * sl + min(32 * j, S - 1)));
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Online logsumexp: (mx, s) holds sum exp(x - mx) of the terms so far; mx
// is -inf (and s 0) until a finite term comes.
__device__ __forceinline__ void lse_add4(float& mx, float& s, float x0, float x1, float x2, float x3) {
  const float m4 = fmaxf(fmaxf(x0, x1), fmaxf(x2, x3));
  if (m4 > mx) {
    s *= expf(mx - m4);
    mx = m4;
  }
  if (mx > -INFINITY) s += (expf(x0 - mx) + expf(x1 - mx)) + (expf(x2 - mx) + expf(x3 - mx));
}
__device__ __forceinline__ void lse_add1(float& mx, float& s, float x) {
  if (x > mx) {
    s *= expf(mx - x);
    mx = x;
  }
  if (mx > -INFINITY) s += expf(x - mx);
}

// One block per row b.  Shared memory: alpha, hs (S each), the quarters'
// maxima and sums (NTS each), red (NTS/32).
template <bool CONTIG>
__global__ void __launch_bounds__(NTS) mstv_forward_kernel(const float* __restrict__ alpha0,
                                                           const float* __restrict__ A, TvStrides sa,
                                                           const float* __restrict__ R,
                                                           const float* __restrict__ L, int B, int T, int S,
                                                           int per_row_A, float* __restrict__ hs_out,
                                                           float* __restrict__ o_out, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* alpha = smem;
  float* hs = alpha + S;
  float* pmx = hs + S;
  float* ps = pmx + NTS;
  float* red = ps + NTS;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int c = tid & 255, part = tid >> 8;
  const int sl = CONTIG ? S : sa.l;  // a compile-time alias of S where the rows are contiguous
  const int per = (S + NPART - 1) / NPART;
  const int l_begin = min(S, part * per), l_end = min(S, l_begin + per);
  for (int l = tid; l < S; l += NTS) alpha[l] = alpha0[(long long)b * S + l];
  __syncthreads();
  double norm = 0.0;  // the row's shifts so far (the same in every thread)
  for (int t = 0; t < T; ++t) {
    const long long row = ((long long)t * B + b) * S;
    const float* At = A + t * sa.t + (per_row_A ? b * sa.b : 0);
    if (t + 1 < T && sa.t) prefetch_next(At + sa.t, S, sl, per_row_A ? 0 : b, per_row_A ? 1 : B);
    float m = -INFINITY;
    for (int l = tid; l < S; l += NTS) {
      const float h = L ? alpha[l] + L[row + l] : alpha[l];
      hs[l] = h;
      m = fmaxf(m, h);
    }
    m = finite_or_zero(block_max(m, red));
    norm += (double)m;
    for (int l = tid; l < S; l += NTS) {
      const float v = hs[l] - m;
      hs[l] = v;
      hs_out[row + l] = v;
    }
    __syncthreads();
    for (int rb = 0; rb < S; rb += 256) {
      const int r = rb + c;
      float mx = -INFINITY, s = 0.f;
      if (r < S) {
        const float* Ar = At + r;
        int l = l_begin;
#pragma unroll 2
        for (; l + 4 <= l_end; l += 4)
          lse_add4(mx, s, hs[l] + Ar[(long long)l * sl], hs[l + 1] + Ar[(long long)(l + 1) * sl],
                   hs[l + 2] + Ar[(long long)(l + 2) * sl], hs[l + 3] + Ar[(long long)(l + 3) * sl]);
        for (; l < l_end; ++l) lse_add1(mx, s, hs[l] + Ar[(long long)l * sl]);
      }
      pmx[tid] = mx;
      ps[tid] = s;
      __syncthreads();
      if (part == 0 && r < S) {
        const float M = fmaxf(fmaxf(pmx[c], pmx[256 + c]), fmaxf(pmx[512 + c], pmx[768 + c]));
        float o = -INFINITY;
        if (M > -INFINITY) {
          const float tot = (ps[c] * expf(pmx[c] - M) + ps[256 + c] * expf(pmx[256 + c] - M)) +
                            (ps[512 + c] * expf(pmx[512 + c] - M) + ps[768 + c] * expf(pmx[768 + c] - M));
          o = logf(tot) + M;
        }
        o_out[row + r] = o;
        alpha[r] = o + R[row + r];
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < S; r += NTS) out[(long long)b * S + r] = (float)((double)alpha[r] + norm);
}

// One block per row b, t from T-1 down to 0.  Shared memory: g and the next
// g (S each), hs (S) and o with -inf read as +inf (S).  Writes dR, dL (if
// L) and dalpha0.
__global__ void __launch_bounds__(NTS) mstv_backward_kernel(const float* __restrict__ A, TvStrides sa,
                                                            const float* __restrict__ hs_in,
                                                            const float* __restrict__ o_in,
                                                            const float* __restrict__ gout, int B, int T, int S,
                                                            int per_row_A, float* __restrict__ dR,
                                                            float* __restrict__ dL, float* __restrict__ dalpha0) {
  extern __shared__ float smem[];
  float* g = smem;
  float* gn = g + S;
  float* hs = gn + S;
  float* og = hs + S;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < S; r += NTS) g[r] = gout[(long long)b * S + r];
  __syncthreads();
  for (int t = T - 1; t >= 0; --t) {
    const long long row = ((long long)t * B + b) * S;
    const float* At = A + t * sa.t + (per_row_A ? b * sa.b : 0);
    if (t > 0 && sa.t) prefetch_next(At - sa.t, S, sa.l, per_row_A ? 0 : b, per_row_A ? 1 : B);
    for (int l = tid; l < S; l += NTS) {
      dR[row + l] = g[l];
      hs[l] = hs_in[row + l];
      const float o = o_in[row + l];
      og[l] = o == -INFINITY ? INFINITY : o;
    }
    __syncthreads();
    for (int l = warp; l < S; l += NTS / 32) {
      const float hl = hs[l];
      float acc = 0.f;
      if (hl > -INFINITY) {  // warp-uniform
        const float* Al = At + (long long)l * sa.l;
#pragma unroll 4
        for (int r = lane; r < S; r += 32) acc = fmaf(g[r], expf(hl + Al[r] - og[r]), acc);
      }
      acc = warp_sum(acc);
      if (lane == 0) {
        gn[l] = acc;
        if (dL) dL[row + l] = acc;
      }
    }
    __syncthreads();
    float* tmp = g;
    g = gn;
    gn = tmp;
  }
  for (int l = tid; l < S; l += NTS) dalpha0[(long long)b * S + l] = g[l];
}

// dA[t, a, l, r] = sum over the rows b that use A[t, a] (all B when A_t is
// shared, b = a when each row has its own) of
// G[t, b, r] * exp(hs[t, b, l] + A[t, a, l, r] - o[t, b, r]), in row order.
// Grid: x over (t, a), y over tiles of 256 columns r and FOLD_L rows l; a
// thread takes one r and FOLD_L l.
__global__ void __launch_bounds__(256) mstv_fold_kernel(const float* __restrict__ A, TvStrides sa,
                                                        const float* __restrict__ hs,
                                                        const float* __restrict__ os, const float* __restrict__ G,
                                                        int B, int T, int S, int nA, float* __restrict__ dA) {
  const int col_tiles = (S + 255) / 256;
  const int r = (blockIdx.y % col_tiles) * 256 + threadIdx.x, l0 = (blockIdx.y / col_tiles) * FOLD_L;
  const int t = blockIdx.x / nA, a = blockIdx.x % nA;
  if (r >= S) return;
  const int nl = min(FOLD_L, S - l0);
  const long long base = ((long long)t * nA + a) * S * S + (long long)l0 * S + r;
  const float* Aa = A + t * sa.t + a * sa.b + (long long)l0 * sa.l + r;
  float av[FOLD_L], acc[FOLD_L];
#pragma unroll
  for (int i = 0; i < FOLD_L; ++i) {
    av[i] = i < nl ? Aa[(long long)i * sa.l] : 0.f;
    acc[i] = 0.f;
  }
  const int b_begin = nA > 1 ? a : 0, b_end = nA > 1 ? a + 1 : B;
  for (int b = b_begin; b < b_end; ++b) {
    const long long row = ((long long)t * B + b) * S;
    const float gr = G[row + r], o = os[row + r];
    if (gr == 0.f || o == -INFINITY) continue;  // the row adds nothing to column r
    const float* hb = hs + row + l0;
#pragma unroll
    for (int i = 0; i < FOLD_L; ++i)
      if (i < nl) acc[i] = fmaf(gr, expf(hb[i] + av[i] - o), acc[i]);
  }
#pragma unroll
  for (int i = 0; i < FOLD_L; ++i)
    if (i < nl) dA[base + (long long)i * S] = acc[i];
}

// ------------------------------ time-varying scan (K2g), the cluster route --
//
// K2g on K2's cluster layout (mstvc_*): a cluster of C CTAs takes a group of
// `rows` rows (all of them share A_t, or one row with its own A_t), and CTA
// k owns the columns r in [k W, (k+1) W), W = ceil(S / C).  K2's cluster
// kernels hold one slice exp(A - c) for all T steps; here A_t changes every
// step, so each step's slice is streamed one step ahead, off the carry's
// chain:
// - A_t[:, own columns] is copied into a staging buffer in shared memory
//   while the step before runs, completing on the buffer's mbarrier: by
//   tensor copies (TMA) of the S x W tile where the rows are 16-byte
//   aligned (one a step on the main path; 256 one-row bulk copies a step
//   were 3.6x slower, and issuing cp.async in every thread sits on the
//   carry's chain), else by cp.async of 4 bytes (TvCopy).  A is read by its strides,
//   so a transition constant in time is not copied.
// - After a step has sent its carry, the CTA turns the staged slice into
//   the next step's column maxima c[r] = max_l A_t+1[l, r] (local to the
//   slice, as K2's) and E = exp(A_t+1 - c), and starts the copy of the
//   slice after it.  The transition's loads and exponentials thus leave the
//   step's product, and with A_t shared they are taken once a cluster, not
//   once a row; but at 8 warps an SM this prep (S W exponentials) is still
//   on the carry's chain, about a third of a step.
// Forward step, as K2's: h = alpha + L, m its row max (the carry kept
// shifted, the shifts summed in double), hs = h - m, p = exp(hs),
// z[r] = sum_l p[l] E[l, r] over the own columns on the f32 CUDA cores
// (register-blocked, p read as 16-byte vectors), o = log z + c, and the own
// columns of alpha_t+1 = o + R sent to every peer with st.async on its
// mbarrier: one wait a step and no cluster barrier.
// Exactness: the general body's logsumexp is exact, not K1's clip at
// FLT_MIN, and the factored sum loses the terms p[l] E[l, r] below the
// float32 range.  A column whose c is -inf gives o = -inf; a column with
// z < TV_TAU = 2^-60 is recomputed by the online logsumexp of the streaming
// kernel (lse_add4) over hs + A_t, A_t read from global memory (L2): the
// at most S lost terms, each below 2^-126, cannot move a z >= 2^-60 by
// 2^-24 relative.  So o is -inf exactly where no term is finite.
// Backward: the per-step statistics come from the forward's stacks (hs, o
// and c), so one parallel kernel (mstvc_stats_kernel, a warp a row) sorts
// the columns first.  Class 0, the columns with finite c and o and
// e = c - o <= 60 ln 2 (z >= 2^-60, the factored weights exact to float32),
// with cr = max over them of e:
//   F0[r] = exp(e - cr),  P0[l] = exp(hs[l] + cr),
//   w[l, r] = exp(hs[l] + A[l, r] - o[r]) = P0[l] E[l, r] F0[r].
// Class 1, the other columns with a finite o (those the forward may have
// recomputed): exact per-term weights exp(hs + A - o), as K2's clipped
// class.  Columns with o = -inf have weight 0.  The reverse scan
// (mstvc_backward_kernel) then computes dR_t = g and
//   dh[l] = P0[l] sum_r E[l, r] (g F0)[r] + sum_{r in class 1} g[r] w[l, r]
// for the own columns r, reduce-scatters both partials to the owner of l
// through distributed shared memory as K2's (added in rank order), with
// the slices of A_t streamed in reverse order one step ahead and E formed
// from the forward's c.  Class 1's sum runs only at a step whose group of
// rows holds such a column.  dL_t = dh, and g becomes dh.  The fold
// (mstvc_fold_kernel), parallel over t and tiles of dA_t, is a (S x B) by
// (B x S) product a step with no exponential a term:
//   dA_t[l, r] = E[l, r] sum_b P0_b[l] (G_b F0_b)[r]
//              + sum_{b: r in class 1} G_b[r] exp(hs_b[l] + A[l, r] - o_b[r]),
// rows in order, no atomics, so two runs give the same bits.
//
// Bound at model_1vt's shape: as the streaming route's above.  What the
// design does about latency: 88 SMs (11 clusters of 8 CTAs, 3 rows each)
// in place of 32, the transition's exponentials once a cluster and S / C a
// column, the slices' copies off the chain.  Measured on an H100 (PERF.md):
// a step takes some 7300 cycles forward and 6400 backward, of which the
// slice's c and E about 2350 and 2100.

#define TV_TAU 8.67361737988403547e-19f  // 2^-60: below it, the forward recomputes a column exactly
#define TV_LOG_TAU 41.5888308335967186f  // 60 ln 2

// Dynamic shared memory, in floats, of a CTA of the cluster route's kernels;
// the kernels cut it in this order, every part a multiple of 16 bytes.
__host__ __device__ __forceinline__ long long tvc_forward_floats(int S, int C, int rows) {
  const long long W4 = round4(cl_width(S, C)), S4 = round4(S), R = rows;
  return S4 * W4                    // the staged slice of A_t+1
         + 8                        // the mbarriers: two carry buffers, the staged slice
         + round4(S4 * (W4 + 1))    // E = exp(A_t - c)
         + 4 * R * S4               // carry rows (two buffers), p, hs
         + R * NTC                  // the product's partial sums (and the column maxima's)
         + R * W4                   // the new carry's own columns
         + 8 * R + round4(2 * R)    // segment maxima, the rows' summed shifts (double)
         + NTC + W4;                // the column maxima of the product's parts, and c
}
__host__ __device__ __forceinline__ long long tvc_backward_floats(int S, int C, int rows) {
  const long long W4 = round4(cl_width(S, C)), S4 = round4(S), R = rows;
  return S4 * W4                    // the staged slice of A_t-1
         + 8                        // the mbarriers: two receive buffers, the staged slice
         + round4(S4 * (W4 + 1))    // E
         + 4 * C * R * W4           // received partials: two buffers, two classes, C sources
         + 2 * R * S4               // the product's partials of both classes, before they are sent
         + 3 * R * W4;              // u of both classes, class 1's o
}

__device__ __forceinline__ void mbar_init_count(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// How a launch copies A's slices: by tensor copies (TMA) of the S x W
// tile, one a step for S <= 256 (the main path) and 2 or 4 of S/2 or S/4
// rows above, where every row of every slice is 16-byte aligned; else by
// cp.async of 4 bytes an element.
struct TvCopy {
  CUtensorMap map;   // A as (r, l[, row][, t]): the row and time dims only where their strides are not 0
  int tma;           // whether the slices go by tensor copies (the map is set)
  int box_rows;      // rows l of a tensor copy: S, S / 2 or S / 4
  int has_b, has_t;  // whether the map has the row dim, the time dim
};

// Start the copy of A_t's S x wn slice of row b (columns from r0; `src` its
// first element, row stride sl) into `stage` (S4 x W4), completing a phase
// of the mbarrier `bar`: by thread 0's tensor copies (the mbarrier
// initialised with one arrival: its own, with the bytes), or by every
// thread's cp.async, each thread arriving when its copies have landed
// (initialised with NTC).  A tensor copy fills the columns past S with 0;
// the preps mask them.  Called by every thread after a barrier that follows
// the last read of `stage`.
__device__ __forceinline__ void tv_stage_slice(const TvCopy& cp, const float* src, int sl, int S, int wn, int W4,
                                               float* stage, unsigned bar, int r0, int b, int t) {
  const int tid = threadIdx.x;
  if (cp.tma) {
    if (tid == 0) {  // no proxy fence: every read of `stage` retired before the barrier before this call
      mbar_expect(bar, 4u * S * W4);
      const unsigned long long map = reinterpret_cast<unsigned long long>(&cp.map);
      for (int l0 = 0; l0 < S; l0 += cp.box_rows) {
        const unsigned dst = smem_addr(stage + l0 * W4);
        if (cp.has_b && cp.has_t)
          asm volatile(
              "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
              "%4, %5}], [%6];\n" ::"r"(dst),
              "l"(map), "r"(r0), "r"(l0), "r"(b), "r"(t), "r"(bar)
              : "memory");
        else if (cp.has_b || cp.has_t)
          asm volatile(
              "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, "
              "%4}], [%5];\n" ::"r"(dst),
              "l"(map), "r"(r0), "r"(l0), "r"(cp.has_b ? b : t), "r"(bar)
              : "memory");
        else
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, "
              "%3}], [%4];\n" ::"r"(dst),
              "l"(map), "r"(r0), "r"(l0), "r"(bar)
              : "memory");
      }
    }
    return;
  }
  const int per = NTC / wn;
  if (tid < per * wn) {
    const int w = tid % wn;
    for (int l = tid / wn; l < S; l += per) cp_async4(stage + l * W4 + w, src + (long long)l * sl + w);
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// The forward's c and E of the staged slice, by the parts of its product:
// thread (part, w), part < nparts, takes the l of its part's chunk
// [l_begin, l_end) of column w (both multiples of 4), their maximum into
// pm[part * W4 + w]; after a barrier the column's maximum c over the parts
// (-inf for a column of -inf) into cs[w] and E[l * (W4 + 1) + w] =
// exp(stage[l * W4 + w] - c), c made finite (the padding rows are -inf in
// `stage`, so 0 in E; the columns past S, w >= wn, are 0 in E).  With 8 warps an SM the latency of dependent loads
// sets the time, so each thread keeps 16 loads, maxima and exponentials in
// flight (the pointers restrict: no store to E aliases a load of `stage`).
// Ends synchronised.
__device__ __forceinline__ void tv_prep_forward(const float* __restrict__ stage, int W4, int wn, int nparts, int part,
                                                int w, int l_begin, int l_end, float* __restrict__ pm,
                                                float* __restrict__ cs, float* __restrict__ E) {
  if (part < nparts && w >= wn) {  // a column past S
    pm[part * W4 + w] = -INFINITY;
    for (int l = l_begin; l < l_end; ++l) E[l * (W4 + 1) + w] = 0.f;
  } else if (part < nparts) {
    float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
#pragma unroll 4
    for (int l = l_begin; l < l_end; l += 4) {
      m0 = fmaxf(m0, stage[l * W4 + w]);
      m1 = fmaxf(m1, stage[(l + 1) * W4 + w]);
      m2 = fmaxf(m2, stage[(l + 2) * W4 + w]);
      m3 = fmaxf(m3, stage[(l + 3) * W4 + w]);
    }
    pm[part * W4 + w] = fmaxf(fmaxf(m0, m1), fmaxf(m2, m3));
  }
  __syncthreads();
  if (part < nparts && w < wn) {
    float c = pm[w];
    for (int q = 1; q < nparts; ++q) c = fmaxf(c, pm[q * W4 + w]);
    if (part == 0) cs[w] = c;
    c = finite_or_zero(c);
    float* __restrict__ Ew = E + w;
#pragma unroll 4
    for (int l = l_begin; l < l_end; l += 4) {
      const float v0 = stage[l * W4 + w], v1 = stage[(l + 1) * W4 + w], v2 = stage[(l + 2) * W4 + w],
                  v3 = stage[(l + 3) * W4 + w];
      Ew[l * (W4 + 1)] = expf(v0 - c);
      Ew[(l + 1) * (W4 + 1)] = expf(v1 - c);
      Ew[(l + 2) * (W4 + 1)] = expf(v2 - c);
      Ew[(l + 3) * (W4 + 1)] = expf(v3 - c);
    }
  }
  __syncthreads();
}

// The backward's E = exp(stage - c) from the forward's maxima c (craw, the
// own columns' wn), made finite: thread (l0, w) takes the rows l0 + k per.
// Four rows a time without a guard, so that their exponentials interleave
// (a guard a row makes each a branch of its own, run one after another).
// Ends synchronised.
__device__ __forceinline__ void tv_prep_backward(const float* __restrict__ stage, int S4, int W4, int wn,
                                                 const float* __restrict__ craw, float* __restrict__ E) {
  const int tid = threadIdx.x, per = NTC / W4, QP = W4 + 1;
  if (tid < per * W4 && tid % W4 >= wn) {  // a column past S
    for (int l = tid / W4; l < S4; l += per) E[l * QP + tid % W4] = 0.f;
  } else if (tid < per * W4) {
    const int w = tid % W4;
    const float c = finite_or_zero(craw[w]);
    int l = tid / W4;
#pragma unroll 2
    for (; l + 3 * per < S4; l += 4 * per) {
      const float v0 = stage[l * W4 + w], v1 = stage[(l + per) * W4 + w], v2 = stage[(l + 2 * per) * W4 + w],
                  v3 = stage[(l + 3 * per) * W4 + w];
      E[l * QP + w] = expf(v0 - c);
      E[(l + per) * QP + w] = expf(v1 - c);
      E[(l + 2 * per) * QP + w] = expf(v2 - c);
      E[(l + 3 * per) * QP + w] = expf(v3 - c);
    }
    for (; l < S4; l += per) E[l * QP + w] = expf(stage[l * W4 + w] - c);
  }
  __syncthreads();
}

// Grid: clusters of C CTAs along x; cluster i takes rows [i rows, (i+1)
// rows) of a shared A_t, or row i and its own A_t (per_row_A, rows == 1).
// Writes, for each CTA's own columns, hs and o (T, B, S), out (B, S) and c
// (T, nA, S), the raw column maxima of each A_t, for the backward.
template <int ME>
__global__ void __launch_bounds__(NTC, 1) mstvc_forward_kernel(
    const float* __restrict__ alpha0, const float* __restrict__ A, TvStrides sa, const float* __restrict__ R,
    const float* __restrict__ L, int B, int T, int S, int per_row_A, int rows, const __grid_constant__ TvCopy cp,
    float* __restrict__ hs_out,
    float* __restrict__ o_out, float* __restrict__ c_out, float* __restrict__ out) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C;
  const int W = cl_width(S, C), W4 = round4(W), QP = W4 + 1, S4 = round4(S);
  const int r0 = k * W, wn = max(0, min(W, S - r0));
  const int b0 = cid * rows, nr = min(rows, B - b0);
  const long long a = per_row_A ? cid : 0, nA = per_row_A ? B : 1;
  // A_t[l, r0 + w] = As[t sa.t + l sa.l + w]
  const float* As = A + a * sa.b + r0;
  const int tid = threadIdx.x;
  const bool vec = W % 4 == 0 && S % 4 == 0;
  extern __shared__ __align__(128) float tv_smem[];
  float* stage = tv_smem;                          // [S4][W4], 128-byte aligned for the tensor copy
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(stage + S4 * W4);  // [2] carry, [2] the slice
  float* E = stage + S4 * W4 + 8;                  // [S4][QP]
  float* hbuf = E + round4(S4 * QP);               // [2][rows][S4]
  float* p = hbuf + 2 * rows * S4;                 // [rows][S4]
  float* hsb = p + rows * S4;                      // [rows][S4]
  float* red = hsb + rows * S4;                    // [parts][rows][W4]
  float* vbuf = red + rows * NTC;                  // [rows][W4]
  float* seg_max = vbuf + rows * W4;               // [rows][8]
  double* nrm = reinterpret_cast<double*>(seg_max + 8 * rows);  // [rows], 16-byte aligned
  float* pm = seg_max + 8 * rows + round4(2 * rows);  // [parts][W4]
  float* cs = pm + NTC;                                // [W4]
  const unsigned sbar = smem_addr(&bars[2]);
  const RowSlots<ME> e(S, nr);
  const OwnOutputs own(nr, W, wn);
  // the sends of a step, as K2's: item x = (peer j, row, column or vector
  // of 4 columns q) into the peer's carry row at r0 + q (4 q), from vbuf
  const int nq = vec ? (wn + 3) / 4 : wn, nsend = C * nr * nq;
  int send_j[MAXS], send_dst[MAXS], send_src[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int x = tid + i * NTC, j = x % C, row = (x / C) / max(nq, 1), q = (x / C) % max(nq, 1);
    send_j[i] = x < nsend ? j : -1;
    send_dst[i] = row * S4 + r0 + (vec ? 4 * q : q);
    send_src[i] = row * W4 + (vec ? 4 * q : q);
  }

  // the product's parts: thread (part, pw) sums l over its part's chunk of
  // S4 for column pw, and forms c and E there
  const int nparts = NTC / W4, chunk = round4((S4 + nparts - 1) / nparts);
  const int pw = tid % W4, part = tid / W4;
  const int l_begin = min(S4, part * chunk), l_end = min(S4, l_begin + chunk);

  // prologue: the staging buffer's padding, the mbarriers, A_0's slice and
  // its E, the copy of A_1's started
  for (int x = tid; x < S4 * W4; x += NTC)
    if (x / W4 >= S || x % W4 >= wn) stage[x] = -INFINITY;
  for (int x = tid; x < rows * S4; x += NTC) p[x] = 0.f;  // the padding columns stay 0
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]));
    mbar_init(smem_addr(&bars[1]));
    mbar_init_count(sbar, cp.tma ? 1 : NTC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  tv_stage_slice(cp, As, sa.l, S, wn, W4, stage, sbar, r0, (int)a, 0);
  for (int x = tid; x < nr * S; x += NTC) hbuf[(x / S) * S4 + x % S] = alpha0[(long long)b0 * S + x];
  for (int x = tid; x < rows; x += NTC) nrm[x] = 0.0;
  float lv[ME];
#pragma unroll
  for (int i = 0; i < ME; ++i)
    lv[i] = (L && e.ls[i] >= 0) ? L[(long long)b0 * S + e.rows_[i] * S + e.ls[i]] : 0.f;
  unsigned carry_bytes = 0;
  for (int j = 0; j < C; ++j) {
    const int wj = max(0, min(W, S - j * W));
    carry_bytes += 4u * nr * (vec ? round4(wj) : wj);
  }
  if (tid == 0 && T > 1) mbar_expect(smem_addr(&bars[1]), carry_bytes);
  mbar_wait(sbar, 0);
  tv_prep_forward(stage, W4, wn, nparts, part, pw, l_begin, l_end, pm, cs, E);
  if (T > 1) tv_stage_slice(cp, As + sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, 1);
  cluster.sync();  // every peer runs, its mbarriers initialised, before the first remote store

  const bool writes_c = per_row_A || cid == 0;
  for (int t = 0; t < T; ++t) {
    const float* cur = hbuf + (t & 1) * rows * S4;
    const unsigned nxt = smem_addr(hbuf + ((t + 1) & 1) * rows * S4);
    const unsigned nxt_bar = smem_addr(&bars[(t + 1) & 1]);
    const long long step = ((long long)t * B + b0) * S;
    float rv[MAXO];
#pragma unroll
    for (int i = 0; i < MAXO; ++i) rv[i] = own.w[i] >= 0 ? R[step + (long long)own.row[i] * S + r0 + own.w[i]] : 0.f;
    if (t > 0) mbar_wait(smem_addr(&bars[t & 1]), ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 2 < T) mbar_expect(smem_addr(&bars[t & 1]), carry_bytes);
    // h = alpha + L, its row max m, hs = h - m and p = exp(hs); hs of the
    // own columns into the stack
    float h[ME];
#pragma unroll
    for (int i = 0; i < ME; ++i) h[i] = e.ls[i] >= 0 ? cur[e.rows_[i] * S4 + e.ls[i]] + lv[i] : -INFINITY;
    if (L && t + 1 < T) {
#pragma unroll
      for (int i = 0; i < ME; ++i)
        if (e.ls[i] >= 0) lv[i] = L[step + (long long)B * S + e.rows_[i] * S + e.ls[i]];
    }
    segment_max(e, h, nr, seg_max);
    float m[ME];
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      if (i < e.n) {
        m[i] = (e.starts >> i & 1 && e.rows_[i] < nr) ? finite_or_zero(row_max(seg_max, e.rows_[i], e.wpr))
                                                   : m[i > 0 ? i - 1 : 0];
        h[i] -= m[i];
      }
    }
#pragma unroll
    for (int i = 0; i < ME; ++i) {
      if (e.ls[i] >= 0) {
        const int x = e.rows_[i] * S4 + e.ls[i];
        hsb[x] = h[i];
        p[x] = expf(h[i]);
        if ((unsigned)(e.ls[i] - r0) < (unsigned)wn) hs_out[step + e.rows_[i] * S + e.ls[i]] = h[i];
        if (e.ls[i] == 0) nrm[e.rows_[i]] += (double)m[i];
      }
    }
    __syncthreads();
    if (part < nparts) {
      for (int rc = 0; rc < nr; rc += 4) {
        float* dst = red + (part * rows + rc) * W4 + pw;
        const float* pr = p + rc * S4;
        switch (min(4, nr - rc)) {
          case 1: chunk_product<1>(E + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          case 2: chunk_product<2>(E + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          case 3: chunk_product<3>(E + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
          default: chunk_product<4>(E + pw, QP, pr, S4, l_begin, l_end, dst, W4); break;
        }
      }
    }
    __syncthreads();
    // o of the own columns (exact where z < TV_TAU), alpha_t+1 into vbuf
    // (into out at the last step)
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int row = own.row[i], w = own.w[i];
      if (w < 0) continue;
      const float c = cs[w];
      if (row == 0 && writes_c) c_out[((long long)t * nA + a) * S + r0 + w] = c;
      float o;
      if (c == -INFINITY) {
        o = -INFINITY;
      } else {
        float z = red[row * W4 + w];
        for (int q = 1; q < nparts; ++q) z += red[(q * rows + row) * W4 + w];
        if (z >= TV_TAU) {
          o = logf(z) + c;
        } else {
          const float* Ac = As + t * sa.t + w;
          const float* hr = hsb + row * S4;
          float mx = -INFINITY, s = 0.f;
          int l = 0;
          for (; l + 4 <= S; l += 4)
            lse_add4(mx, s, hr[l] + Ac[(long long)l * sa.l], hr[l + 1] + Ac[(long long)(l + 1) * sa.l],
                     hr[l + 2] + Ac[(long long)(l + 2) * sa.l], hr[l + 3] + Ac[(long long)(l + 3) * sa.l]);
          for (; l < S; ++l) lse_add1(mx, s, hr[l] + Ac[(long long)l * sa.l]);
          o = mx > -INFINITY ? logf(s) + mx : -INFINITY;
        }
      }
      const int r = r0 + w;
      o_out[step + (long long)row * S + r] = o;
      const float v = o + rv[i];
      if (t == T - 1) out[(long long)(b0 + row) * S + r] = (float)((double)v + nrm[row]);
      else vbuf[row * W4 + w] = v;
    }
    if (t + 1 < T) {
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        const int j = send_j[i];
        if (j < 0) continue;
        if (vec)
          st_async4(peer_addr(nxt + 4u * send_dst[i], j), *reinterpret_cast<const float4*>(vbuf + send_src[i]),
                    peer_addr(nxt_bar, j));
        else
          st_async(peer_addr(nxt + 4u * send_dst[i], j), vbuf[send_src[i]], peer_addr(nxt_bar, j));
      }
      for (int x = tid + MAXS * NTC; x < nsend; x += NTC) {
        const int j = x % C, row = (x / C) / nq, q = (x / C) % nq;
        if (vec)
          st_async4(peer_addr(nxt + 4u * (row * S4 + r0 + 4 * q), j),
                    *reinterpret_cast<const float4*>(vbuf + row * W4 + 4 * q), peer_addr(nxt_bar, j));
        else
          st_async(peer_addr(nxt + 4u * (row * S4 + r0 + q), j), vbuf[row * W4 + q], peer_addr(nxt_bar, j));
      }
      // while the carry is in flight: the next step's c and E, and the
      // copy of the slice after it
      mbar_wait(sbar, (t + 1) & 1);
      tv_prep_forward(stage, W4, wn, nparts, part, pw, l_begin, l_end, pm, cs, E);
      if (t + 2 < T) tv_stage_slice(cp, As + (t + 2) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, t + 2);
    }
    __syncthreads();
  }
}

// The classes of the reverse scan's columns and their factors, from the
// forward's stacks: one warp per row (t, b) writes F0 (0 outside class 0),
// X1 (o in class 1, +inf elsewhere) and P0 = exp(hs + cr), and sets
// two[t, group] where a row of the cluster's group of `rows` rows has a
// column in class 1.
__global__ void __launch_bounds__(NT) mstvc_stats_kernel(const float* __restrict__ hs, const float* __restrict__ os,
                                                         const float* __restrict__ c_in, int B, int T, int S,
                                                         int per_row_A, int rows, int* __restrict__ two,
                                                         float* __restrict__ P0, float* __restrict__ F0,
                                                         float* __restrict__ X1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * (NT / 32) + warp;
  if (i >= (long long)T * B) return;
  const int b = (int)(i % B);
  const long long t = i / B;
  const float* ca = c_in + (t * (per_row_A ? B : 1) + (per_row_A ? b : 0)) * S;
  const long long base = i * S;
  float cr = -INFINITY;
  for (int r = lane; r < S; r += 32) {
    const float c = ca[r], o = os[base + r], e = c - o;
    if (c > -INFINITY && o > -INFINITY && e <= TV_LOG_TAU) cr = fmaxf(cr, e);
  }
  cr = finite_or_zero(warp_max(cr));
  bool any1 = false;
  for (int r = lane; r < S; r += 32) {
    const float c = ca[r], o = os[base + r], e = c - o;
    const bool class0 = c > -INFINITY && o > -INFINITY && e <= TV_LOG_TAU, class1 = !class0 && o > -INFINITY;
    F0[base + r] = class0 ? expf(e - cr) : 0.f;
    X1[base + r] = class1 ? o : INFINITY;
    any1 |= class1;
  }
  for (int l = lane; l < S; l += 32) P0[base + l] = expf(hs[base + l] + cr);
  if (__any_sync(0xffffffffu, any1) && lane == 0) atomicOr(&two[t * ((B + rows - 1) / rows) + b / rows], 1);
}

// The reverse scan on the forward's cluster layout, after mstvc_stats_kernel.
// Writes dR, dL (if L) and dalpha0 for each CTA's own columns.
__global__ void __launch_bounds__(NTC, 1) mstvc_backward_kernel(
    const float* __restrict__ A, TvStrides sa, const float* __restrict__ c_in, const float* __restrict__ hs,
    const float* __restrict__ P0, const float* __restrict__ F0, const float* __restrict__ X1,
    const int* __restrict__ two_of, const float* __restrict__ gout, int B, int T, int S, int per_row_A, int rows,
    const __grid_constant__ TvCopy cp, float* __restrict__ dR, float* __restrict__ dL, float* __restrict__ dalpha0) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), k = (int)cluster.block_rank();
  const int cid = blockIdx.x / C, groups = gridDim.x / C;
  const int W = cl_width(S, C), W4 = round4(W), QP = W4 + 1, S4 = round4(S);
  const int r0 = k * W, wn = max(0, min(W, S - r0));
  const int b0 = cid * rows, nr = min(rows, B - b0);
  const long long a = per_row_A ? cid : 0, nA = per_row_A ? B : 1;
  const float* As = A + a * sa.b + r0;
  const int tid = threadIdx.x, RW = rows * W4;
  const bool vec = W % 4 == 0;
  extern __shared__ __align__(128) float tv_smem[];
  float* stage = tv_smem;                      // [S4][W4], 128-byte aligned for the tensor copy
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(stage + S4 * W4);  // [2] receive, [2] the slice
  float* E = stage + S4 * W4 + 8;              // [S4][QP]
  float* recv = E + round4(S4 * QP);           // [2 buffers][2 classes][C sources][rows][W4]
  float* part = recv + 4 * C * RW;             // [2 classes][rows][S4]
  float* u0 = part + 2 * rows * S4;            // [rows][W4]
  float* u1 = u0 + RW;
  float* x1s = u1 + RW;
  const unsigned sbar = smem_addr(&bars[2]);
  const OwnOutputs own(nr, W, wn);
  // the sends of a step, per class, as K2's: item x = (row, l or vector of
  // 4 l) to the owner j of l, into the source's place of its receive buffer
  const int nq = vec ? (S + 3) / 4 : S, nsend = nr * nq;
  int send_j[MAXS], send_dst[MAXS], send_src[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) {
    const int x = tid + i * NTC, row = x / nq, l = vec ? 4 * (x % nq) : x % nq, j = l / W;
    send_j[i] = x < nsend ? j : -1;
    send_dst[i] = row * W4 + l - j * W;
    send_src[i] = row * S4 + l;
  }
  // the factors of the own outputs at step t, in registers
  float f0[MAXO], x1[MAXO], p0[MAXO];
  auto load_factors = [&](int t) {
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      if (own.w[i] >= 0) {
        const long long x = ((long long)t * B + b0 + own.row[i]) * S + r0 + own.w[i];
        f0[i] = F0[x];
        x1[i] = X1[x];
        p0[i] = P0[x];
      }
    }
  };

  // prologue: the staging buffer's padding, the mbarriers, A_T-1's slice
  // and its E (with the forward's c), the copy of A_T-2's started, u of
  // step T-1
  for (int x = tid; x < S4 * W4; x += NTC)
    if (x / W4 >= S || x % W4 >= wn) stage[x] = -INFINITY;
  for (int o = tid; o < RW; o += NTC) {
    u0[o] = u1[o] = 0.f;
    x1s[o] = INFINITY;
  }
  if (tid == 0) {
    mbar_init(smem_addr(&bars[0]));
    mbar_init(smem_addr(&bars[1]));
    mbar_init_count(sbar, cp.tma ? 1 : NTC);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  tv_stage_slice(cp, As + (T - 1) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, T - 1);
  load_factors(T - 1);
#pragma unroll
  for (int i = 0; i < MAXO; ++i) {
    const int row = own.row[i], w = own.w[i];
    if (w < 0) continue;
    const float g = gout[(long long)(b0 + row) * S + r0 + w];
    dR[((long long)(T - 1) * B + b0 + row) * S + r0 + w] = g;
    u0[row * W4 + w] = g * f0[i];
    u1[row * W4 + w] = x1[i] < INFINITY ? g : 0.f;
    x1s[row * W4 + w] = x1[i];
  }
  mbar_wait(sbar, 0);
  tv_prep_backward(stage, S4, W4, wn, c_in + ((T - 1) * nA + a) * S + r0, E);
  if (T > 1) tv_stage_slice(cp, As + (T - 2) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, T - 2);
  const unsigned part_bytes = 4u * C * nr * (vec ? round4(wn) : wn);
  int two = two_of[(long long)(T - 1) * groups + cid];
  int two_next = T > 1 ? two_of[(long long)(T - 2) * groups + cid] : 0;
  if (tid == 0) mbar_expect(smem_addr(&bars[(T - 1) & 1]), part_bytes * (two ? 2 : 1));
  cluster.sync();  // every peer runs, its mbarriers initialised, before the first remote store

  for (int t = T - 1; t >= 0; --t) {
    const int par = t & 1;
    const unsigned bar = smem_addr(&bars[par]);
    if (tid == 0 && t > 0) mbar_expect(smem_addr(&bars[par ^ 1]), part_bytes * (two_next ? 2 : 1));
    const int two_after = t > 1 ? two_of[(long long)(t - 2) * groups + cid] : 0;
    float gain[MAXO];
#pragma unroll
    for (int i = 0; i < MAXO; ++i) gain[i] = p0[i];
    if (t > 0) load_factors(t - 1);  // in flight during the product
    // partial rx of both classes over the own columns, for every l
    const float* hst = hs + ((long long)t * B + b0) * S;
    const float* At = As + t * sa.t;
    for (int l = tid; l < S; l += NTC) {
      const float* q = E + l * QP;
      for (int rc = 0; rc < nr; rc += 4) {
        float a0[4] = {0.f, 0.f, 0.f, 0.f};
        for (int w = 0; w < W4; w += 4) {
          const float q0 = q[w], q1 = q[w + 1], q2 = q[w + 2], q3 = q[w + 3];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if (rc + r < nr) {
              const float4 v = *reinterpret_cast<const float4*>(u0 + (rc + r) * W4 + w);
              a0[r] = fmaf(v.x, q0, a0[r]);
              a0[r] = fmaf(v.y, q1, a0[r]);
              a0[r] = fmaf(v.z, q2, a0[r]);
              a0[r] = fmaf(v.w, q3, a0[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (rc + r < nr) part[(rc + r) * S4 + l] = a0[r];
      }
      if (two) {
        for (int row = 0; row < nr; ++row) {
          const float hl = hst[(long long)row * S + l];
          float a1 = 0.f;
          for (int w = 0; w < wn; ++w) {
            const float xo = x1s[row * W4 + w];
            if (xo < INFINITY) a1 = fmaf(u1[row * W4 + w], expf(hl + At[(long long)l * sa.l + w] - xo), a1);
          }
          part[(rows + row) * S4 + l] = a1;
        }
      }
    }
    __syncthreads();
    const unsigned rbase = smem_addr(recv + par * 2 * C * RW + k * RW);
    for (int cls = 0; cls < (two ? 2 : 1); ++cls) {
      const unsigned dst = rbase + 4u * cls * C * RW;
      const float* src = part + cls * rows * S4;
#pragma unroll
      for (int i = 0; i < MAXS; ++i) {
        const int j = send_j[i];
        if (j < 0) continue;
        if (vec)
          st_async4(peer_addr(dst + 4u * send_dst[i], j), *reinterpret_cast<const float4*>(src + send_src[i]),
                    peer_addr(bar, j));
        else
          st_async(peer_addr(dst + 4u * send_dst[i], j), src[send_src[i]], peer_addr(bar, j));
      }
      for (int x = tid + MAXS * NTC; x < nsend; x += NTC) {
        const int row = x / nq, l = vec ? 4 * (x % nq) : x % nq, j = l / W;
        if (vec)
          st_async4(peer_addr(dst + 4u * (row * W4 + l - j * W), j),
                    *reinterpret_cast<const float4*>(src + row * S4 + l), peer_addr(bar, j));
        else
          st_async(peer_addr(dst + 4u * (row * W4 + l - j * W), j), src[row * S4 + l], peer_addr(bar, j));
      }
    }
    // while the partials are in flight: E of the step before, and the
    // copy of the slice before that
    if (t > 0) {
      mbar_wait(sbar, (T - t) & 1);
      tv_prep_backward(stage, S4, W4, wn, c_in + ((t - 1) * nA + a) * S + r0, E);
      if (t > 1) tv_stage_slice(cp, As + (t - 2) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, t - 2);
    }
    mbar_wait(bar, ((T - 1 - t) >> 1) & 1);
    // rx of the own rows l: the C sources in rank order; dh, then u of the
    // step before
    const float* rb = recv + par * 2 * C * RW;
#pragma unroll
    for (int i = 0; i < MAXO; ++i) {
      const int row = own.row[i], w = own.w[i], x = row * W4 + w;
      if (w < 0) continue;
      float rx = 0.f;
      for (int j = 0; j < C; ++j) rx += rb[j * RW + x];
      float dh = gain[i] * rx;
      if (two) {
        float rc = 0.f;
        for (int j = 0; j < C; ++j) rc += rb[(C + j) * RW + x];
        dh += rc;
      }
      const int r = r0 + w;
      if (dL) dL[((long long)t * B + b0 + row) * S + r] = dh;
      if (t > 0) {
        dR[((long long)(t - 1) * B + b0 + row) * S + r] = dh;
        u0[x] = dh * f0[i];
        u1[x] = x1[i] < INFINITY ? dh : 0.f;
        x1s[x] = x1[i];
      } else {
        dalpha0[(long long)(b0 + row) * S + r] = dh;
      }
    }
    two = two_next;
    two_next = two_after;
    __syncthreads();
  }
}

// dA[t, a, l, r] = E[l, r] sum_b P0[t, b, l] G[t, b, r] F0[t, b, r] plus
// the class-1 terms G[t, b, r] exp(hs[t, b, l] + A[l, r] - X1[t, b, r]),
// over the rows b that use A[t, a] (all B when A_t is shared, b = a when
// each row has its own), in row order.  A block computes one 64x64 (l, r)
// tile of one dA_t with 16-row steps staged in shared memory, 4x4 outputs
// per thread; grid (T nA, tiles).
__global__ void __launch_bounds__(NT) mstvc_fold_kernel(const float* __restrict__ A, TvStrides sa,
                                                        const float* __restrict__ c_in, const float* __restrict__ hs,
                                                        const float* __restrict__ P0, const float* __restrict__ F0,
                                                        const float* __restrict__ X1, const float* __restrict__ G,
                                                        int B, int T, int S, int nA, float* __restrict__ dA) {
  __shared__ __align__(16) float Ps[TK][TM + 4];
  __shared__ __align__(16) float Us[TK][TN + 4];
  const int tid = threadIdx.x;
  const int col_tiles = (S + TN - 1) / TN;
  const int l0 = (blockIdx.y / col_tiles) * TM, r0 = (blockIdx.y % col_tiles) * TN;
  const long long ta = blockIdx.x, t = ta / nA, a = ta % nA;
  const int b_begin = nA > 1 ? (int)a : 0, nb = nA > 1 ? 1 : B;
  const int tl = (tid / 16) * 4, tr = (tid % 16) * 4;
  float acc[4][4] = {};
  bool any1 = false;
  for (int i0 = 0; i0 < nb; i0 += TK) {
    for (int x = tid; x < TK * TM; x += NT) {
      const int i = x / TM, l = x % TM;
      Ps[i][l] = (i0 + i < nb && l0 + l < S) ? P0[(t * B + b_begin + i0 + i) * S + l0 + l] : 0.f;
    }
    for (int x = tid; x < TK * TN; x += NT) {
      const int i = x / TN, r = x % TN;
      float v = 0.f;
      if (i0 + i < nb && r0 + r < S) {
        const long long o = (t * B + b_begin + i0 + i) * S + r0 + r;
        v = G[o] * F0[o];
        any1 |= X1[o] < INFINITY;
      }
      Us[i][r] = v;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TK; ++i) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[i][tl]);
      const float4 uv = *reinterpret_cast<const float4*>(&Us[i][tr]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float ua[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(pa[x], ua[y], acc[x][y]);
    }
    __syncthreads();
  }
  const bool class1 = __syncthreads_or(any1) != 0;
  const float* At = A + t * sa.t + a * sa.b;
  const float* ca = c_in + ta * S;
  float* out = dA + ta * S * S;
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) {
      const int l = l0 + tl + x, r = r0 + tr + y;
      if (l >= S || r >= S) continue;
      const float av = At[(long long)l * sa.l + r];
      float d = expf(av - finite_or_zero(ca[r])) * acc[x][y];
      if (class1) {
        for (int i = 0; i < nb; ++i) {
          const long long o = (t * B + b_begin + i) * S;
          const float xo = X1[o + r];
          if (xo < INFINITY) d = fmaf(G[o + r], expf(hs[o + l] + av - xo), d);
        }
      }
      out[(long long)l * S + r] = d;
    }
}

// Each cluster kernel's attributes, set once per device and process, as
// set_attributes does for K2's.
static int set_tv_attributes(void) {
  static bool done[64] = {};
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev < 64 && done[dev]) return 0;
  int optin = 0;
  err = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err) return err;
  const void* kernels[] = {(const void*)mstvc_forward_kernel<4>, (const void*)mstvc_forward_kernel<8>,
                           (const void*)mstvc_backward_kernel};
  for (const void* f : kernels) {
    err = (int)cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err) return err;
    err = (int)cudaFuncSetAttribute(f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err) return err;
  }
  if (dev < 64) done[dev] = true;
  return 0;
}

typedef CUresult (*TvEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of the CUDA library, got through the runtime (no
// link to libcuda), or null.
static TvEncodeTiled tv_encoder(void) {
  static TvEncodeTiled fn = nullptr;
  static bool tried = false;
  if (!tried) {
    tried = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = (TvEncodeTiled)p;
  }
  return fn;
}

// The copy of A's slices for a launch (TvCopy): a tensor map of tiles of W
// columns and S, S / 2 or S / 4 rows (a box dim is at most 256) where every
// row of every CTA's slice is 16-byte aligned and a multiple of 16 bytes
// (S a multiple of 4, so S / 4 divides it: up to 1024) and every box lands
// 128-byte aligned, else cp.async of 4 bytes (or where the encoder is
// missing or refuses the map).
static TvCopy tv_copy(const float* A, TvStrides sa, int S, int C, int per_row_A, int B, int T) {
  TvCopy cp;
  memset(&cp, 0, sizeof cp);
  const int W = cl_width(S, C);
  const bool vec = W % 4 == 0 && S % 4 == 0 && sa.t % 4 == 0 && sa.b % 4 == 0 && sa.l % 4 == 0 &&
                   (unsigned long long)A % 16 == 0;
  const TvEncodeTiled encode = tv_encoder();
  const int box_rows = S <= 256 ? S : S <= 512 ? S / 2 : S / 4;
  // every box's destination 128-byte aligned, as a tensor copy needs
  if (!vec || S > 1024 || (box_rows < S && box_rows * W % 32) || !encode) return cp;
  cp.box_rows = box_rows;
  cp.has_b = per_row_A && sa.b != 0;
  cp.has_t = sa.t != 0;
  cuuint64_t dims[4] = {(cuuint64_t)S, (cuuint64_t)S, 1, 1}, strides[3] = {4ull * sa.l, 0, 0};
  cuuint32_t box[4] = {(cuuint32_t)W, (cuuint32_t)cp.box_rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  int rank = 2;
  if (cp.has_b) {
    dims[rank] = B;
    strides[rank - 1] = 4ull * sa.b;
    ++rank;
  }
  if (cp.has_t) {
    dims[rank] = T;
    strides[rank - 1] = 4ull * sa.t;
    ++rank;
  }
  if (encode(&cp.map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, (void*)A, dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS)
    cp.tma = 1;
  return cp;
}

extern "C" {

// Dynamic shared memory in bytes of a CTA of the cluster route's forward
// (backward = 0) or backward kernel.
long long msc_smem_bytes(int S, int C, int rows, int backward) {
  return 4 * (backward ? cl_backward_floats(S, C, rows) : cl_forward_floats(S, C, rows));
}

// The shared memory in bytes a block of the current device may opt in to.
int msc_smem_limit(int* bytes) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// How many clusters of C CTAs the device runs at once, for both cluster
// kernels at their shared memory for (S, rows): the smaller count.
int msc_active_clusters(int S, int C, int rows, int* count) {
  int err = set_attributes();
  if (err) return err;
  int n[2] = {0, 0};
  const void* kernels[2] = {cl_slots(S, rows) <= 4 ? (const void*)msc_forward_kernel<4>
                                                   : (const void*)msc_forward_kernel<8>,
                            (const void*)msc_backward_kernel};
  for (int i = 0; i < 2; ++i) {
    ClusterLaunch launch(C, 1, (size_t)msc_smem_bytes(S, C, rows, i), 0);
    err = (int)cudaOccupancyMaxActiveClusters(&n[i], kernels[i], &launch.cfg);
    if (err) return err;
  }
  *count = n[0] < n[1] ? n[0] : n[1];
  return 0;
}

// Streaming route.  alpha0 (B, S); A (nA, S, S), nA 1 or B; R and L
// (T, B, S), L may be null; outputs: alphas and zs (T, B, S), out (B, S);
// scratch kept for the backward: Q and QT (nA, S, S), craw (nA, S).
int ms_forward(const float* alpha0, const float* A, const float* R, const float* L, int B, int T, int S, int nA,
               float* alphas, float* zs, float* out, float* Q, float* QT, float* craw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  clear_last_error();
  int err = set_attributes();
  if (err) return err;
  dim3 prep_grid((S + NT - 1) / NT, nA);
  ms_prep_kernel<<<prep_grid, NT, 0, st>>>(A, S, Q, QT, craw);
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem = (3 * (size_t)S + NTS + NTS / 32) * sizeof(float);
  ms_forward_kernel<<<B, NTS, smem, st>>>(alpha0, Q, craw, R, L, B, T, S, nA > 1, alphas, zs, out);
  return (int)cudaGetLastError();
}

// gout (B, S) is dloss/dalpha_T; alphas and zs are the forward's.
// Outputs dalpha0 (B, S), dR (T, B, S), dL (T, B, S) or null, dA (nA, S, S).
// Scratch: P, W and Wc (T, B, S), cc (2, nA, S), partial (2, splits, nA, S, S).
int ms_backward(const float* A, const float* alphas, const float* zs, const float* L, const float* Q,
                const float* QT, const float* craw, const float* gout, int B, int T, int S, int nA, int splits,
                float* dalpha0, float* dR, float* dL, float* dA, float* P, float* W, float* Wc, float* cc,
                float* partial, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  clear_last_error();
  int err = set_attributes();
  if (err) return err;
  const size_t smem = (6 * (size_t)S + NTS + NTS / 32) * sizeof(float);
  ms_backward_kernel<<<B, NTS, smem, st>>>(alphas, zs, L, Q, QT, craw, gout, B, T, S, nA > 1, dR, dL, P, W,
                                           Wc, dalpha0);
  err = (int)cudaGetLastError();
  if (err) return err;
  return fold_dA(A, craw, dR, B, T, S, nA, splits, dA, P, W, Wc, cc, partial, st);
}

// Cluster route, clusters of C CTAs, each taking `rows` rows (1 when
// nA = B).  Arguments as ms_forward's, without Q and QT: craw (nA, S) is
// an output, kept for the backward.
int msc_forward(const float* alpha0, const float* A, const float* R, const float* L, int B, int T, int S, int nA,
                int C, int rows, float* alphas, float* zs, float* out, float* craw, void* stream) {
  if (!cl_takes(S, C, rows)) return (int)cudaErrorInvalidValue;
  clear_last_error();
  int err = set_attributes();
  if (err) return err;
  ClusterLaunch launch(C, (B + rows - 1) / rows, (size_t)msc_smem_bytes(S, C, rows, 0), (cudaStream_t)stream);
  // the row passes' registers sized to the slots a thread needs
  err = (int)cudaLaunchKernelEx(&launch.cfg, cl_slots(S, rows) <= 4 ? msc_forward_kernel<4> : msc_forward_kernel<8>,
                                alpha0, A, R, L, B, T, S, (int)(nA > 1), rows, alphas, zs, out, craw);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Arguments as ms_backward's, without Q and QT; C and rows as the forward's.
// Scratch besides: G0, G1, F0, F1 (T, B, S), crcs (T, B) and two
// (T, ceil(B / rows)) ints.
int msc_backward(const float* A, const float* alphas, const float* zs, const float* L, const float* craw,
                 const float* gout, int B, int T, int S, int nA, int C, int rows, int splits, float* dalpha0,
                 float* dR, float* dL, float* dA, float* P, float* W, float* Wc, float* cc, float* partial,
                 float* G0, float* G1, float* F0, float* F1, float* crcs, int* two, void* stream) {
  if (!cl_takes(S, C, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  clear_last_error();
  int err = set_attributes();
  if (err) return err;
  const int groups = (B + rows - 1) / rows;
  err = (int)cudaMemsetAsync(two, 0, sizeof(int) * (size_t)T * groups, st);
  if (err) return err;
  const long long nrows = (long long)T * B;
  msc_stats_kernel<<<(unsigned)((nrows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(
      alphas, zs, L, craw, B, T, S, nA > 1, rows, two, G0, G1, F0, F1, crcs, P, W, Wc);
  err = (int)cudaGetLastError();
  if (err) return err;
  ClusterLaunch launch(C, groups, (size_t)msc_smem_bytes(S, C, rows, 1), st);
  err = (int)cudaLaunchKernelEx(&launch.cfg, msc_backward_kernel, (const float*)G0, (const float*)G1,
                                (const float*)F0, (const float*)F1, (const float*)crcs, (const int*)two, A, craw,
                                gout, B, T, S, (int)(nA > 1), rows, dR, dL, dalpha0);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  return fold_dA(A, craw, dR, B, T, S, nA, splits, dA, P, W, Wc, cc, partial, st);
}

// Time-varying scan (K2g).  alpha0 (B, S); A (T, nA, S, S), nA 1 or B; R and
// L (T, B, S), L may be null; outputs: hs and o (T, B, S), kept for the
// backward, and out (B, S).
// Streaming route.  A_t[l, r] of row b at A[t sAt + b sAb + l sAl + r].
int mstv_forward(const float* alpha0, const float* A, long long sAt, long long sAb, long long sAl, const float* R,
                 const float* L, int B, int T, int S, int nA, float* hs, float* o, float* out, void* stream) {
  clear_last_error();
  const size_t smem = (2 * (size_t)S + 2 * NTS + NTS / 32) * sizeof(float);
  const TvStrides sa = {sAt, sAb, (int)sAl};
  cudaStream_t st = (cudaStream_t)stream;
  if (sAl == S)
    mstv_forward_kernel<true><<<B, NTS, smem, st>>>(alpha0, A, sa, R, L, B, T, S, nA > 1, hs, o, out);
  else
    mstv_forward_kernel<false><<<B, NTS, smem, st>>>(alpha0, A, sa, R, L, B, T, S, nA > 1, hs, o, out);
  return (int)cudaGetLastError();
}

// gout (B, S) is dloss/dalpha_T; hs and o are the forward's.  Outputs
// dalpha0 (B, S), dR (T, B, S), dL (T, B, S) or null, dA (T, nA, S, S)
// (contiguous, whatever A's strides).
int mstv_backward(const float* A, long long sAt, long long sAb, long long sAl, const float* hs, const float* o,
                  const float* gout, float* dL, int B, int T, int S, int nA, float* dalpha0, float* dR, float* dA,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  clear_last_error();
  const size_t smem = 4 * (size_t)S * sizeof(float);
  const TvStrides sa = {sAt, sAb, (int)sAl};
  mstv_backward_kernel<<<B, NTS, smem, st>>>(A, sa, hs, o, gout, B, T, S, nA > 1, dR, dL, dalpha0);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((unsigned)T * nA, ((S + 255) / 256) * ((S + FOLD_L - 1) / FOLD_L));
  mstv_fold_kernel<<<grid, 256, 0, st>>>(A, sa, hs, o, dR, B, T, S, nA, dA);
  return (int)cudaGetLastError();
}

// Dynamic shared memory in bytes of a CTA of K2g's cluster route, forward
// (backward = 0) or backward.
long long mstvc_smem_bytes(int S, int C, int rows, int backward) {
  return 4 * (backward ? tvc_backward_floats(S, C, rows) : tvc_forward_floats(S, C, rows));
}

// How many clusters of C CTAs the device runs at once, for both of K2g's
// cluster kernels at their shared memory for (S, rows): the smaller count.
int mstvc_active_clusters(int S, int C, int rows, int* count) {
  int err = set_tv_attributes();
  if (err) return err;
  int n[2] = {0, 0};
  const void* kernels[2] = {cl_slots(S, rows) <= 4 ? (const void*)mstvc_forward_kernel<4>
                                                   : (const void*)mstvc_forward_kernel<8>,
                            (const void*)mstvc_backward_kernel};
  for (int i = 0; i < 2; ++i) {
    ClusterLaunch launch(C, 1, (size_t)mstvc_smem_bytes(S, C, rows, i), 0);
    err = (int)cudaOccupancyMaxActiveClusters(&n[i], kernels[i], &launch.cfg);
    if (err) return err;
  }
  *count = n[0] < n[1] ? n[0] : n[1];
  return 0;
}

// Cluster route, clusters of C CTAs, each taking `rows` rows (1 when
// nA = B).  Arguments as mstv_forward's; c (T, nA, S), the raw column
// maxima of each A_t, is an output kept for the backward.
int mstvc_forward(const float* alpha0, const float* A, long long sAt, long long sAb, long long sAl, const float* R,
                  const float* L, int B, int T, int S, int nA, int C, int rows, float* hs, float* o, float* c,
                  float* out, void* stream) {
  if (!cl_takes(S, C, rows)) return (int)cudaErrorInvalidValue;
  clear_last_error();
  int err = set_tv_attributes();
  if (err) return err;
  const TvStrides sa = {sAt, sAb, (int)sAl};
  ClusterLaunch launch(C, (B + rows - 1) / rows, (size_t)mstvc_smem_bytes(S, C, rows, 0), (cudaStream_t)stream);
  err = (int)cudaLaunchKernelEx(&launch.cfg,
                                cl_slots(S, rows) <= 4 ? mstvc_forward_kernel<4> : mstvc_forward_kernel<8>, alpha0,
                                A, sa, R, L, B, T, S, (int)(nA > 1), rows, tv_copy(A, sa, S, C, nA > 1, B, T), hs, o,
                                c, out);
  if (err) return err;
  return (int)cudaGetLastError();
}

// Arguments as mstv_backward's, with the forward's c; C and rows as the
// forward's.  Scratch: P0, F0, X1 (T, B, S) and two (T, ceil(B / rows)) ints.
int mstvc_backward(const float* A, long long sAt, long long sAb, long long sAl, const float* hs, const float* o,
                   const float* c, const float* gout, float* dL, int B, int T, int S, int nA, int C, int rows,
                   float* dalpha0, float* dR, float* dA, float* P0, float* F0, float* X1, int* two, void* stream) {
  if (!cl_takes(S, C, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  clear_last_error();
  int err = set_tv_attributes();
  if (err) return err;
  const TvStrides sa = {sAt, sAb, (int)sAl};
  const int groups = (B + rows - 1) / rows;
  err = (int)cudaMemsetAsync(two, 0, sizeof(int) * (size_t)T * groups, st);
  if (err) return err;
  const long long nrows = (long long)T * B;
  mstvc_stats_kernel<<<(unsigned)((nrows + NT / 32 - 1) / (NT / 32)), NT, 0, st>>>(hs, o, c, B, T, S, nA > 1, rows,
                                                                                   two, P0, F0, X1);
  err = (int)cudaGetLastError();
  if (err) return err;
  ClusterLaunch launch(C, groups, (size_t)mstvc_smem_bytes(S, C, rows, 1), st);
  err = (int)cudaLaunchKernelEx(&launch.cfg, mstvc_backward_kernel, A, sa, c, hs, (const float*)P0,
                                (const float*)F0, (const float*)X1, (const int*)two, gout, B, T, S, (int)(nA > 1),
                                rows, tv_copy(A, sa, S, C, nA > 1, B, T), dR, dL, dalpha0);
  if (err) return err;
  err = (int)cudaGetLastError();
  if (err) return err;
  dim3 grid((unsigned)T * nA, ((S + TM - 1) / TM) * ((S + TN - 1) / TN));
  mstvc_fold_kernel<<<grid, NT, 0, st>>>(A, sa, c, hs, P0, F0, X1, dR, B, T, S, nA, dA);
  return (int)cudaGetLastError();
}

}  // extern "C"
