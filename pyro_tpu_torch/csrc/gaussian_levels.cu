// The halving levels of the information-form Gaussian algebra on Hopper
// (sm_90a), forward only: K4a, K4b and K4c.  A Gaussian over x is
// exp(c + i.x - x'Px/2) with log normaliser c, info vector i and precision
// P; a factor of a Markov chain is a Gaussian over (z_t, z_t+1), 2n dims.
// Time is contracted by pairwise halving: each level joins adjacent
// factors and integrates out their shared state, which needs the n x n
// Cholesky factor of the shared block and solves against it.
//
// K4a, gl_halving_kernel: one level of a time-homogeneous chain, where every
//   factor shares one precision P (2n x 2n) and only info vectors and log
//   normalisers vary.  Replaces the loop body of reduce_pow2_block and
//   build_block in pyro_tpu/ops/gaussian.py (:448-475, :561-596).  With
//   A, B, D the blocks of P: L = chol(D + A), Kt = L^-1 [B^T | B] (n x 2n),
//   P' = diag(A, D) - Kt' Kt, and per pair (i1, i2): ib = i1[n:] + i2[:n],
//   s = L^-1 ib, info' = [i1[:n], i2[n:]] - s Kt, logZ' = logZ1 + logZ2 +
//   n/2 log 2pi - sum log diag L + |s|^2 / 2.  Every CTA factorises the one
//   shared matrix itself in shared memory (no launch of its own for it),
//   CTA 0 writes P' and L, then a warp takes a pair at a time: lane i holds
//   row i of the substitution (n <= 32), the columns of s Kt read Kt from
//   shared memory.
// K4b, gl_contract_kernel: the contraction of adjacent pairs of a chain
//   whose precision varies with time.  Replaces the mid-block elimination of
//   sequential_gaussian_filter_sample's forward (:726-787) and the work of
//   gaussian_tensordot(x, y, n) (:367-413) in sequential_gaussian_tensordot's
//   level (:501-526).  Per pair of x over (l, m) and y over (m, r): P_mm =
//   Px[mm] + Py[mm], P_mk = [Px[lm]^T | Py[mr]] (n x 2n), i_m = ix[m] +
//   iy[m]; L = chol(P_mm), X = L^-1 [P_mk | i_m]; the contracted Gaussian
//   over (l, r) is P_kk - X' X, i_k - X' X[:, 2n], and its normaliser.  One
//   CTA takes a pair at a time: the matrices in shared memory, the Cholesky
//   and the solve with 2n + 1 right-hand sides by the whole block.  For the
//   sampler it keeps a tape of L, P_mk and i_m (the reference keeps the
//   whole 3n x 3n joint; the descent reads only these).
// K4c, gl_mids_kernel: a level's midpoint draws, the descent of both
//   samplers (:623-654 with L and B shared, :790-843 with L per pair).  Per
//   (draw, pair): info_c = i_m - P_mk (l, r), mid = L^-T (L^-1 info_c + eps),
//   written with the left points into their interleaved places of the next
//   level's points; L and P_mk are read with stride 0 where they are shared
//   (never broadcast into memory).  A warp per (draw, pair), lane i row i.
//
// What bounds them on an H100 (700 W): K4a over a whole log_prob at B=8,
// T=10,000, n=32 is about 0.4 GFLOP (6 us on the f32 CUDA cores) against
// about 60 MB of info read and written (18 us), K4b at T=4000, n=16 about
// 60 MB, K4c at 64 draws about 50 MB: bytes, some 15-20 us each over a
// call.  But a level depends on the one before, and a call has 12-13
// levels of short kernels, so launch and the per-level latency of the small
// factorisations set the time.  The kernels are plain f32 code with the
// small matrices in shared memory and registers.
//
// Plain C interface for ctypes; each entry point launches on the given
// stream and returns the launch's error code.

#include <cuda_runtime.h>
#include <math.h>

#define NMAX 32        // the largest state dim n the kernels take
#define NT_HALVE 256   // threads of K4a's CTA: 8 warps
#define NT_PAIR 128    // threads of K4b's CTA
#define NT_MIDS 256    // threads of K4c's CTA: 8 warps
#define FULL 0xffffffffu
#define HALF_LOG_2PI 0.91893853320467274178f

// Cholesky of the n x n matrix in M (row stride ld, lower part read) in
// place, by the whole block of nt threads: M becomes L with zeros above the
// diagonal.  Right-looking: column j is divided by sqrt of its pivot, then
// the trailing lower triangle takes the rank-1 update.  Ends synchronised.
__device__ void block_cholesky(float* M, int ld, int n, int nt) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    const float d = sqrtf(M[j * ld + j]);
    for (int i = j + 1 + tid; i < n; i += nt) M[i * ld + j] /= d;
    __syncthreads();
    if (tid == 0) M[j * ld + j] = d;
    const int w = n - j - 1;
    for (int x = tid; x < w * w; x += nt) {
      const int i = j + 1 + x / w, k = j + 1 + x % w;
      if (k <= i) M[i * ld + k] -= M[i * ld + j] * M[k * ld + j];
    }
  }
  __syncthreads();
  for (int x = tid; x < n * n; x += nt) {
    const int i = x / n, k = x % n;
    if (k > i) M[i * ld + k] = 0.f;
  }
  __syncthreads();
}

// X <- L^-1 X for the n x nc matrix X (row stride ldx) with L lower (row
// stride ld), by the whole block: row j is final once divided by L[j][j],
// then every later row subtracts its multiple.  Ends synchronised.
__device__ void block_solve_lower(const float* L, int ld, float* X, int ldx, int n, int nc, int nt) {
  const int tid = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    const float d = L[j * ld + j];
    for (int c = tid; c < nc; c += nt) X[j * ldx + c] /= d;
    __syncthreads();
    const int w = n - j - 1;
    for (int x = tid; x < w * nc; x += nt) {
      const int i = j + 1 + x / nc, c = x % nc;
      X[i * ldx + c] -= L[i * ld + j] * X[j * ldx + c];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ------------------------------------------------------------------- K4a --

// P (2n, 2n); info (R, 2m, 2n) and logZ (R, 2m) with row strides info_rs
// and logZ_rs (elements); outputs P_out (2n, 2n), L_out (n, n) (CTA 0),
// info_out (R, m, 2n), logZ_out (R, m), and ib_out (R, m, n) unless null.
__global__ void __launch_bounds__(NT_HALVE) gl_halving_kernel(
    const float* __restrict__ P, const float* __restrict__ info, long long info_rs,
    const float* __restrict__ logZ, long long logZ_rs, int R, int m, int n, float* __restrict__ P_out,
    float* __restrict__ L_out, float* __restrict__ info_out, float* __restrict__ logZ_out,
    float* __restrict__ ib_out) {
  __shared__ float Ls[NMAX][NMAX + 1];
  __shared__ float Kt[NMAX][2 * NMAX + 1];
  __shared__ float sv[NT_HALVE / 32][NMAX];
  __shared__ float inv_diag[NMAX];
  __shared__ float half_logdet;
  const int tid = threadIdx.x, n2 = 2 * n;
  // J = D + A, and [B^T | B] into Kt
  for (int x = tid; x < n * n; x += NT_HALVE) {
    const int i = x / n, j = x % n;
    Ls[i][j] = P[(n + i) * n2 + n + j] + P[i * n2 + j];
  }
  for (int x = tid; x < n * n2; x += NT_HALVE) {
    const int i = x / n2, j = x % n2;
    Kt[i][j] = j < n ? P[j * n2 + n + i] : P[i * n2 + j];
  }
  block_cholesky(&Ls[0][0], NMAX + 1, n, NT_HALVE);
  block_solve_lower(&Ls[0][0], NMAX + 1, &Kt[0][0], 2 * NMAX + 1, n, n2, NT_HALVE);
  if (tid < 32) {
    float v = 0.f;
    for (int i = tid; i < n; i += 32) {
      v += logf(Ls[i][i]);
      inv_diag[i] = 1.f / Ls[i][i];
    }
    v = warp_sum(v);
    if (tid == 0) half_logdet = v;
  }
  if (blockIdx.x == 0) {
    for (int x = tid; x < n2 * n2; x += NT_HALVE) {
      const int i = x / n2, j = x % n2;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(Kt[k][i], Kt[k][j], acc);
      const bool diag_block = (i < n) == (j < n);
      P_out[x] = (diag_block ? P[x] : 0.f) - acc;
    }
    for (int x = tid; x < n * n; x += NT_HALVE) L_out[x] = Ls[x / n][x % n];
  }
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5;
  const long long pairs = (long long)R * m;
  const float c0 = (float)n * HALF_LOG_2PI;
  for (long long q = (long long)blockIdx.x * (NT_HALVE / 32) + warp; q < pairs;
       q += (long long)gridDim.x * (NT_HALVE / 32)) {
    const long long r = q / m, p = q % m;
    const float* i1 = info + r * info_rs + 2 * p * n2;
    const float* i2 = i1 + n2;
    const float ib = lane < n ? i1[n + lane] + i2[lane] : 0.f;
    if (ib_out && lane < n) ib_out[q * n + lane] = ib;
    // s = L^-1 ib, lane i holding row i
    float res = ib, s = 0.f;
    for (int j = 0; j < n; ++j) {
      const float sj = __shfl_sync(FULL, res, j) * inv_diag[j];
      if (lane == j) s = sj;
      if (lane > j && lane < n) res = fmaf(-Ls[lane][j], sj, res);
    }
    sv[warp][lane] = s;
    __syncwarp();
    for (int c = lane; c < n2; c += 32) {
      float acc = c < n ? i1[c] : i2[c];
      for (int k = 0; k < n; ++k) acc = fmaf(-sv[warp][k], Kt[k][c], acc);
      info_out[q * n2 + c] = acc;
    }
    const float ss = warp_sum(lane < n ? s * s : 0.f);
    if (lane == 0) {
      const float* lz = logZ + r * logZ_rs + 2 * p;
      logZ_out[q] = lz[0] + lz[1] + c0 - half_logdet + 0.5f * ss;
    }
    __syncwarp();
  }
}

// ------------------------------------------------------------------- K4b --

// P (R, t, 2n, 2n), info (R, t, 2n), logZ (R, t), contiguous; the t / 2
// pairs (2p, 2p + 1) of each row go to P_out (R, t_out, 2n, 2n), info_out
// (R, t_out, 2n), logZ_out (R, t_out) at p; the tape, unless L_tape is
// null: L_tape (R, t / 2, n, n), Pmk_tape (R, t / 2, n, 2n), im_tape
// (R, t / 2, n).
__global__ void __launch_bounds__(NT_PAIR) gl_contract_kernel(
    const float* __restrict__ P, const float* __restrict__ info, const float* __restrict__ logZ, int R, int t,
    int n, int t_out, float* __restrict__ P_out, float* __restrict__ info_out, float* __restrict__ logZ_out,
    float* __restrict__ L_tape, float* __restrict__ Pmk_tape, float* __restrict__ im_tape) {
  __shared__ float M[NMAX][NMAX + 1];
  __shared__ float X[NMAX][2 * NMAX + 2];  // [P_mk | i_m], then L^-1 of it
  __shared__ float lz_terms;  // sum log diag L - |L^-1 i_m|^2 / 2
  const int tid = threadIdx.x, n2 = 2 * n, nc = n2 + 1;
  const long long np = t / 2, pairs = (long long)R * np;
  for (long long q = blockIdx.x; q < pairs; q += gridDim.x) {
    const long long r = q / np, p = q % np;
    const float* Px = P + ((r * t + 2 * p) * n2) * n2;
    const float* Py = Px + n2 * n2;
    const float* ix = info + (r * t + 2 * p) * n2;
    const float* iy = ix + n2;
    for (int x = tid; x < n * n; x += NT_PAIR) {
      const int i = x / n, j = x % n;
      M[i][j] = Px[(n + i) * n2 + n + j] + Py[i * n2 + j];
    }
    for (int x = tid; x < n * nc; x += NT_PAIR) {
      const int i = x / nc, c = x % nc;
      const float v = c < n ? Px[c * n2 + n + i] : c < n2 ? Py[i * n2 + c] : ix[n + i] + iy[i];
      X[i][c] = v;
      if (L_tape) {
        if (c < n2) Pmk_tape[(q * n + i) * n2 + c] = v;
        else im_tape[q * n + i] = v;
      }
    }
    block_cholesky(&M[0][0], NMAX + 1, n, NT_PAIR);
    if (L_tape)
      for (int x = tid; x < n * n; x += NT_PAIR) L_tape[q * n * n + x] = M[x / n][x % n];
    block_solve_lower(&M[0][0], NMAX + 1, &X[0][0], 2 * NMAX + 2, n, nc, NT_PAIR);
    if (tid < 32) {
      float v = 0.f;
      for (int i = tid; i < n; i += 32) v += logf(M[i][i]) - 0.5f * X[i][n2] * X[i][n2];
      v = warp_sum(v);
      if (tid == 0) lz_terms = v;
    }
    const long long o = r * t_out + p;
    for (int x = tid; x < n2 * n2; x += NT_PAIR) {
      const int i = x / n2, j = x % n2;
      float acc = 0.f;
      for (int k = 0; k < n; ++k) acc = fmaf(X[k][i], X[k][j], acc);
      const float kk = (i < n && j < n) ? Px[i * n2 + j] : (i >= n && j >= n) ? Py[i * n2 + j] : 0.f;
      P_out[o * n2 * n2 + x] = kk - acc;
    }
    for (int i = tid; i < n2; i += NT_PAIR) {
      float acc = i < n ? ix[i] : iy[i];
      for (int k = 0; k < n; ++k) acc = fmaf(-X[k][i], X[k][n2], acc);
      info_out[o * n2 + i] = acc;
    }
    __syncthreads();
    if (tid == 0) {
      const float* lz = logZ + r * t + 2 * p;
      logZ_out[o] = lz[0] + lz[1] + (float)n * HALF_LOG_2PI - lz_terms;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------- K4c --

// cur (D, R, m_cur, n) points; per pair pr = r Np + p of the R rows: L
// (n, n) at L + pr L_stride, P_mk (n, 2n) at Pmk + pr Pmk_stride (stride 0
// where shared), i_m (R, Np, n); eps (D, R, Np, n).  out (D, R, m_out, n),
// m_out = Np + m_cur: out[2p] = cur[p], out[2p + 1] = the mid of the pair
// (cur[p], cur[p + 1]), and out[2 Np + q] = cur[Np + q] for the tail.
__global__ void __launch_bounds__(NT_MIDS) gl_mids_kernel(
    const float* __restrict__ cur, int m_cur, const float* __restrict__ L, long long L_stride,
    const float* __restrict__ Pmk, long long Pmk_stride, const float* __restrict__ im,
    const float* __restrict__ eps, int D, int R, int Np, int n, float* __restrict__ out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n2 = 2 * n;
  const int m_out = Np + m_cur, tail = m_cur - Np;
  const long long items = (long long)D * R * Np;
  for (long long w = (long long)blockIdx.x * (NT_MIDS / 32) + warp; w < items;
       w += (long long)gridDim.x * (NT_MIDS / 32)) {
    const long long dr = w / Np, p = w % Np, pr = (dr % R) * Np + p;
    const float* c = cur + dr * m_cur * n;
    float* o = out + dr * m_out * n;
    const float* Lp = L + pr * L_stride;
    const float* Pm = Pmk + pr * Pmk_stride;
    const float left = lane < n ? c[p * n + lane] : 0.f;
    const float right = lane < n ? c[(p + 1) * n + lane] : 0.f;
    // info_c = i_m - P_mk (l, r), lane i row i
    float res = lane < n ? im[pr * n + lane] : 0.f;
    for (int j = 0; j < n; ++j) {
      const float lj = __shfl_sync(FULL, left, j), rj = __shfl_sync(FULL, right, j);
      if (lane < n) res = fmaf(-Pm[lane * n2 + j], lj, fmaf(-Pm[lane * n2 + n + j], rj, res));
    }
    // y = L^-1 info_c + eps
    float y = 0.f;
    for (int j = 0; j < n; ++j) {
      const float yj = __shfl_sync(FULL, res, j) / Lp[j * n + j];
      if (lane == j) y = yj;
      if (lane > j && lane < n) res = fmaf(-Lp[lane * n + j], yj, res);
    }
    if (lane < n) y += eps[w * n + lane];
    // mid = L^-T y: column j of L^T is row j of L
    float mid = 0.f;
    for (int j = n - 1; j >= 0; --j) {
      const float xj = __shfl_sync(FULL, y, j) / Lp[j * n + j];
      if (lane == j) mid = xj;
      if (lane < j) y = fmaf(-Lp[j * n + lane], xj, y);
    }
    if (lane < n) {
      o[2 * p * n + lane] = left;
      o[(2 * p + 1) * n + lane] = mid;
      for (long long q = p; q < tail; q += Np) o[(2 * Np + q) * n + lane] = c[(Np + q) * n + lane];
    }
  }
}

extern "C" {

int gl_halving(const float* P, const float* info, long long info_rs, const float* logZ, long long logZ_rs, int R,
               int m, int n, int blocks, float* P_out, float* L_out, float* info_out, float* logZ_out,
               float* ib_out, cudaStream_t st) {
  gl_halving_kernel<<<blocks, NT_HALVE, 0, st>>>(P, info, info_rs, logZ, logZ_rs, R, m, n, P_out, L_out, info_out,
                                                 logZ_out, ib_out);
  return (int)cudaGetLastError();
}

int gl_contract(const float* P, const float* info, const float* logZ, int R, int t, int n, int t_out, int blocks,
                float* P_out, float* info_out, float* logZ_out, float* L_tape, float* Pmk_tape, float* im_tape,
                cudaStream_t st) {
  gl_contract_kernel<<<blocks, NT_PAIR, 0, st>>>(P, info, logZ, R, t, n, t_out, P_out, info_out, logZ_out, L_tape,
                                                 Pmk_tape, im_tape);
  return (int)cudaGetLastError();
}

int gl_mids(const float* cur, int m_cur, const float* L, long long L_stride, const float* Pmk, long long Pmk_stride,
            const float* im, const float* eps, int D, int R, int Np, int n, int blocks, float* out, cudaStream_t st) {
  gl_mids_kernel<<<blocks, NT_MIDS, 0, st>>>(cur, m_cur, L, L_stride, Pmk, Pmk_stride, im, eps, D, R, Np, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
