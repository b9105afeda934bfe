// The halving levels of the information-form Gaussian algebra on Hopper
// (sm_90a): K4a, K4b and K4c, the backward of K4a and K4b, and the
// gamma-Gaussian levels K5a and K5b.  A Gaussian over x is
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
//   shared matrix itself (no launch of its own for it), warp 0 by shuffles,
//   and forms L^-1; CTA 0 writes P' and L; then the CTAs walk tiles of 64
//   pairs, every solve a product with L^-1 on the tensor cores (the design
//   and what bounds it: the K4a and K5a section below).
// K4b, gl_contract_kernel: the contraction of adjacent pairs of a chain
//   whose precision varies with time.  Replaces the mid-block elimination of
//   sequential_gaussian_filter_sample's forward (:726-787) and the work of
//   gaussian_tensordot(x, y, n) (:367-413) in sequential_gaussian_tensordot's
//   level (:501-526).  Per pair of x over (l, m) and y over (m, r): P_mm =
//   Px[mm] + Py[mm], P_mk = [Px[lm]^T | Py[mr]] (n x 2n), i_m = ix[m] +
//   iy[m]; L = chol(P_mm), X = L^-1 [P_mk | i_m]; the contracted Gaussian
//   over (l, r) is P_kk - X' X, i_k - X' X[:, 2n], and its normaliser.  A
//   persistent grid walks the pairs with the blocks brought by TMA bulk
//   copy, warp 0 factorising one pair ahead of the warps that solve and
//   multiply (the design and what bounds it: the K4b section below).  For
//   the sampler it keeps a tape of L, P_mk and i_m (the reference keeps the
//   whole 3n x 3n joint; the descent reads only these).
// K4c, gl_mids_kernel: a level's midpoint draws, the descent of both
//   samplers (:623-654 with L and B shared, :790-843 with L per pair).  Per
//   (draw, pair): info_c = i_m - P_mk (l, r), mid = L^-T (L^-1 info_c + eps),
//   written with the left points into their interleaved places of the next
//   level's points; L and P_mk are read with stride 0 where they are shared
//   (never broadcast into memory).  Tiles of pairs of one row, L^-1 formed
//   once a pair (or once a CTA where shared), a thread a (draw, pair) (the
//   design and what bounds it: the K4c section below).
// K5a and K5b, gl_halving_kernel<true> and gl_contract_kernel<true>: the
//   same levels of the gamma-Gaussian algebra (Student-t state-space
//   models), exp(c) s^alpha exp(s (i.x - x'Px/2 - beta)) with a shared
//   mixing variable s.  K5a replaces the loop body of reduce_pow2_block in
//   pyro_tpu/ops/gamma_gaussian.py (:401-439), K5b the pairwise
//   gamma_gaussian_tensordot of sequential_gamma_gaussian_tensordot
//   (:464-486, marginalize :237-275).  Each does its K4 kernel's work and
//   reads per factor alpha and beta as well: alpha' = alpha_1 + alpha_2 -
//   n/2, beta' = beta_1 + beta_2 - |s|^2 / 2 (s = L^-1 ib, or L^-1 i_m), and
//   logZ' leaves out the |s|^2 / 2 completion, which the Gaussian levels add
//   (it is scaled by s here).  The kernel writes beta' itself: recovering it
//   from logZ differences would cancel.  The Gaussian instantiations compile
//   the gamma work away (if constexpr) and do K4's arithmetic unchanged.
//   What bounds them is K4's (below): a call's levels move some 60 MB
//   (K5a) or, for the filter's chain at n = 32, 2.7 GB (K5b; its first
//   level reads the one precision the chain shares in place), and the
//   latency of the small factorisations sets the time.
//
// The backward (training through log_prob) recomputes from the forward's
// tape (K4a: L and ib; K4b: L, P_mk and i_m) and returns the gradient of
// each precision symmetrised, (g + g^T) / 2 of the gradient of the blocks
// the forward reads:
// K4b, gl_contract_bwd_kernel: a warp an item, every solve a product with
//   L^-1 (the design and what bounds it: the K4b backward section below).  Per pair,
//   X = L^-1 [P_mk | i_m]; from the upstream gP', gi', gZ': gX1 = -X1 (gP' +
//   gP'^T) - x2 gi'^T, gx2 = -X1 gi' + gZ' x2; gB = L^-T [gX1 | gx2] (the
//   gradients of P_mk and i_m); gL = -tril(gB X^T) - gZ' / L_jj on the
//   diagonal; the Cholesky adjoint gives gP_mm; all scattered into the
//   pair's gP, ginfo and glogZ.  An odd level's last factor passes its
//   gradient through.
// K4a, gl_halving_bwd_kernel: XLA's autodiff of reduce_pow2_block
//   (pyro_tpu/ops/gaussian.py:448-475), one launch a level.  P is shared:
//   per pair s = L^-1 ib, gs = gZ' s - Kt gi', g_ib = L^-T gs, written into
//   the pair's ginfo and glogZ, and the sums over all pairs of s gi'^T and
//   g_ib s^T (the adjoints of the shared Kt and L) and of gZ'; then once the
//   adjoint of P' = diag(A, D) - Kt^T Kt, Kt = L^-1 [B^T | B], L = chol(D +
//   A) back to gP.  L^-1 is formed once a CTA and every solve is a product
//   with it, over tiles of pairs; the sums run in a fixed order (no float
//   atomics: a rerun gives the same bits), the last CTA to finish carrying
//   the shared adjoint (the design and what bounds it: the K4a backward
//   section below).
//
// What bounds them on an H100 (700 W): K4a over a whole log_prob at B=8,
// T=10,000, n=32 is about 0.4 GFLOP (6 us on the f32 CUDA cores) against
// about 60 MB of info read and written (18 us), K4b at T=4000, n=16 about
// 60 MB, K4c at 64 draws about 78 MB: bytes, some 15-25 us each over a
// call.  But a level depends on the one before, and a call has 12-13
// levels of short kernels, so launch and the per-level latency of the small
// factorisations set the time.  K4c is plain f32 code with the small
// matrices in shared memory and registers.
//
// Plain C interface for ctypes; each entry point launches on the given
// stream and returns the launch's error code.

#include <cuda_runtime.h>
#include <math.h>

#define NMAX 32        // the largest state dim n the kernels take
#define NT_CONTRACT 256  // the most threads of K4b's CTA (more warps for larger n)
#define FULL 0xffffffffu
#define HALF_LOG_2PI 0.91893853320467274178f

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// ------------------------------------------------------------------- K4b --
//
// The design for Hopper (the K4b and K5b instantiations alike).  A
// persistent grid (as many CTAs as the SMs run at once, by shared memory:
// 2 an SM at n = 32) walks the pairs, q += gridDim.x.  A CTA keeps two
// slots of [Px | Py]: one thread brings a pair's two (2n)^2 blocks by TMA
// bulk copy (cp.async.bulk, completing on the slot's mbarrier) two pairs
// ahead, and the pair's info rows and scalars are held in registers until
// its slot of small rows is free.  Every read of P is from shared memory.
// Warp 0 factorises each pair one pair ahead of the other warps (the team):
//   warp 0: P_mm = Px[mm] + Py[mm]; L = chol(P_mm), lane i row i, blocks
//     of 8 columns, pivots and column entries by __shfl_sync (no block
//     barrier inside), into one of two L buffers;
//   team: X = [Px[lm]^T | Py[mr] | i_m] (the transpose through shared
//     memory) and P_kk into a staging block in the output's layout, after
//     which the slot takes the load of the pair after next; the solve
//     X = L^-1 X, a thread a column (2n + 1 of them), blocks of 8 rows in
//     registers, L's columns read as float4 broadcasts; P' = P_kk - X^T X
//     in 4 x 4 register tiles over float4 reads of X into the staging
//     block, stored by one bulk copy (cp.async.bulk, shared to global);
//     info' and the scalars.
// A pair takes three barriers of the team (four with the tape) and one of
// the CTA.  What bounds it, measured on an H100 (examples/contract_timing.py;
// the filter's 14 levels at n = 32, 2.97 ms): not the bytes (2.7 GB, 0.8 ms
// at 3.35 TB/s) nor the FLOPs (27.6 GFLOP, 0.4 ms) but latency at 2 CTAs
// an SM.  The loads, assembly, stores and barriers alone take 1.33 ms; the
// Cholesky's chain of 32 dependent pivots (a shuffle, a reciprocal square
// root and two FMAs each; 4.26 ms with an IEEE sqrt and divide) and the
// team's solve and product add the rest.  More pairs in flight an SM needs
// less shared memory a pair than two [Px | Py] slots.  The loops over NMAX
// stay rolled: fully unrolled, the kernel is some 18k instructions, each
// fetched once a pair, and ran 2.6x slower.  P' stored from registers
// instead of the staging block took 128 registers and ran slower.
// Operands are read where they lie: element (r, p) of an operand at
// (r / R_lo) hi + (r % R_lo) lo + p ts (``RowStrides``), so a precision
// expanded over rows or time (stride 0) is one block read from L2, never a
// copy.  Every sum runs in a fixed order (two runs give the same bits), and
// the GAMMA split compiles the same code for P' and info' in both
// instantiations (K4's and K5's are equal bit for bit).

// Where element (r, p) of a K4b operand lies: (r / R_lo) hi + (r % R_lo) lo
// + p ts elements from its base (R_lo shared by the operands).
struct RowStrides {
  long long hi, lo, ts;
};

struct ContractArgs {
  const float* P;  // (R, t, 2n, 2n), (2n, 2n) blocks contiguous, 16-byte aligned
  const float* info;  // (R, t, 2n), rows contiguous
  const float* logZ;  // (R, t)
  const float* alpha;  // GAMMA: (R, t)
  const float* beta;
  RowStrides sP, sI, sZ, sA, sB;
  long long R_lo;
  int R, t, n, t_out;
  float *P_out, *info_out, *logZ_out;  // (R, t_out, ...), contiguous
  float *L_tape, *Pmk_tape, *im_tape;  // the tape, or null
  float *alpha_out, *beta_out;
};

// The shared memory of K4b's CTA at state dim n: floats after a header of
// CONTRACT_HEADER bytes (the two slots' mbarriers and three scalars).
#define CONTRACT_HEADER 128
struct ContractSmem {
  int pb;     // floats of a (2n)^2 block
  int small;  // floats of a slot's small rows: ix, iy, then logZ, alpha, beta of both factors
  int sx, lt, ms;  // row strides of X (float4-aligned), Lt (8-float blocks), Ms (odd: no bank conflict)
  int ring, stage, smallo, X, Lt, Ms, invd, floats;  // offsets and size, in floats
};

__host__ __device__ inline ContractSmem contract_smem(int n) {
  ContractSmem s;
  const int n2 = 2 * n;
  s.pb = n2 * n2;
  s.small = (2 * n2 + 6 + 3) & ~3;
  s.sx = (n2 + 1 + 3) & ~3;
  s.lt = (n + 7) & ~7;  // blocks of 8 columns read as two float4
  s.ms = n | 1;
  s.ring = 0;  // two slots of [Px | Py]
  s.stage = 4 * s.pb;
  s.smallo = s.stage + s.pb;  // two slots of small rows
  s.X = s.smallo + 2 * s.small;
  s.Lt = s.X + n * s.sx;  // two L buffers: the team's pair's and warp 0's next
  s.Ms = s.Lt + 2 * n * s.lt;
  s.invd = s.Ms + ((n * s.ms + 3) & ~3);  // two buffers
  s.floats = s.invd + 2 * ((n + 3) & ~3);
  return s;
}

static size_t contract_smem_bytes(int n) { return CONTRACT_HEADER + 4 * (size_t)contract_smem(n).floats; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init1(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait_parity(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` (16-byte aligned) to shared
// `dst`, counted on the mbarrier `bar`.
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src, unsigned bytes, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, unsigned src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// The calling thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// This thread's generic writes to shared memory visible to the async proxy
// (a bulk copy started after the next barrier).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// A pair's place: row r of the R rows, pair p of the row's t / 2, and the
// offsets (elements) of its first factor in each operand.
struct PairAt {
  long long r, p, P, info, logZ, alpha, beta;
};

__device__ __forceinline__ PairAt pair_at(const ContractArgs& a, long long q, long long np) {
  PairAt w;
  w.r = q / np;
  w.p = q - w.r * np;
  const long long hi = w.r / a.R_lo, lo = w.r - hi * a.R_lo, f = 2 * w.p;
  w.P = hi * a.sP.hi + lo * a.sP.lo + f * a.sP.ts;
  w.info = hi * a.sI.hi + lo * a.sI.lo + f * a.sI.ts;
  w.logZ = hi * a.sZ.hi + lo * a.sZ.lo + f * a.sZ.ts;
  w.alpha = hi * a.sA.hi + lo * a.sA.lo + f * a.sA.ts;
  w.beta = hi * a.sB.hi + lo * a.sB.lo + f * a.sB.ts;
  return w;
}

// Element e of a pair's small rows: ix (2n), iy (2n), then logZ, alpha and
// beta of the two factors.
__device__ __forceinline__ float pair_small(const ContractArgs& a, const PairAt& w, int e) {
  const int n2 = 2 * a.n;
  if (e < n2) return a.info[w.info + e];
  if (e < 2 * n2) return a.info[w.info + a.sI.ts + e - n2];
  const int k = e - 2 * n2;
  if (k < 2) return a.logZ[w.logZ + k * a.sZ.ts];
  if (k < 4) return a.alpha[w.alpha + (k - 2) * a.sA.ts];
  return a.beta[w.beta + (k - 4) * a.sB.ts];
}

// Thread 0: a pair's [Px | Py] into the ring slot at shared address `ring`
// by two bulk copies, counted on the slot's mbarrier.
__device__ __forceinline__ void pair_fetch(const ContractArgs& a, const PairAt& w, unsigned ring, unsigned bar,
                                           unsigned pbytes) {
  mbar_expect_tx(bar, 2 * pbytes);
  bulk_load(ring, a.P + w.P, pbytes, bar);
  bulk_load(ring + pbytes, a.P + w.P + a.sP.ts, pbytes, bar);
}

// Warp 0: L = chol(P_mm) of the pair whose [Px | Py] are in shared memory,
// lane i row i, blocks of 8 columns (left-looking over the blocks before,
// right-looking within), into Lt (Lt[j][i] = L[i][j], zero above the
// diagonal), invd (1 / L_jj) and *logdet (sum log L_jj).  The same order of
// operations for every n: each entry is P_mm[i][j] less L[i][k] L[j][k] for
// k = 0, 1, ... in turn.
__device__ __forceinline__ void warp_cholesky(const float* Px, const float* Py, float* Ms, float* Lt, float* invd,
                                              float* logdet, int n, const ContractSmem& S, int lane) {
  const int n2 = 2 * n;
#pragma unroll 4
  for (int i = 0; i < n; ++i)  // P_mm's lower triangle into Ms
    if (lane <= i) Ms[i * S.ms + lane] = Px[(n + i) * n2 + n + lane] + Py[i * n2 + lane];
  __syncwarp();
  float diag = 1.f, inv = 1.f;
  for (int j0 = 0; j0 < n; j0 += 8) {
    float a8[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a8[r] = (lane < n && j0 + r <= lane) ? Ms[lane * S.ms + j0 + r] : 0.f;
    // the columns before the block, in order: a8[r] -= L[lane][k] L[j0 + r][k]
#pragma unroll 4
    for (int k = 0; k < j0; ++k) {
      const float lk = Lt[k * S.lt + lane];
      const float4 u = *reinterpret_cast<const float4*>(Lt + k * S.lt + j0);
      const float4 v = *reinterpret_cast<const float4*>(Lt + k * S.lt + j0 + 4);
      const float c[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) a8[r] = fmaf(-lk, c[r], a8[r]);
    }
    // the block's own columns, right-looking, entries by shuffle.  The chain
    // from pivot to pivot is a shuffle, a reciprocal square root (MUFU, one
    // Newton step) and two FMAs: lane j + 1 takes its next pivot from its
    // own update (`next`), not from a shuffle of it.
    float next = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = j0 + r;
      if (j < n) {
        const float piv = __shfl_sync(FULL, r == 0 ? a8[0] : next, j);
        float rs = rsqrtf(piv);
        rs *= fmaf(-0.5f * piv * rs, rs, 1.5f);
        const float l = a8[r] * rs;
        if (r < 7) next = fmaf(-l, l, a8[r < 7 ? r + 1 : r]);
        if (lane == j) {
          diag = piv * rs;
          inv = rs;
        }
        a8[r] = lane == j ? piv * rs : lane > j ? l : 0.f;
#pragma unroll
        for (int c = r + 1; c < 8; ++c) {
          const float lc = __shfl_sync(FULL, l, j0 + c);
          if (lane >= j0 + c) a8[c] = fmaf(-l, lc, a8[c]);
        }
      }
    }
    if (lane < n) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (j0 + r < n) Lt[(j0 + r) * S.lt + lane] = j0 + r <= lane ? a8[r] : 0.f;
    }
    __syncwarp();
  }
  if (lane < n) invd[lane] = inv;
  const float v = warp_sum(lane < n ? logf(diag) : 0.f);
  if (lane == 0) *logdet = v;
}

// The warps after warp 0 (`team` threads) synchronise among themselves.
__device__ __forceinline__ void team_sync(int team) { asm volatile("bar.sync 1, %0;\n" ::"r"(team) : "memory"); }

// The t / 2 pairs (2p, 2p + 1) of each row go to P_out, info_out and
// logZ_out at (r, p); the tape, unless L_tape is null: L_tape (R, t / 2, n,
// n), Pmk_tape (R, t / 2, n, 2n), im_tape (R, t / 2, n).  GAMMA (K5b):
// alpha and beta in, alpha_out and beta_out out, and logZ' without
// |L^-1 i_m|^2 / 2.  An odd level's last factor is the wrapper's to carry.
// Warp 0 factorises each pair one pair ahead of the other warps (the team),
// which solve, multiply and store it: pair q's Cholesky runs beside pair q -
// gridDim.x's solve and product.  Any multiple of 32 threads from 128 up to
// NT_CONTRACT (the launch takes more for larger n).
template <bool GAMMA>
__global__ void __launch_bounds__(NT_CONTRACT, 2) gl_contract_kernel(const ContractArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = a.n, n2 = 2 * n, nc = n2 + 1, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x, team = nt - 32, tt = tid - 32;
  const ContractSmem S = contract_smem(n);
  float* const f = reinterpret_cast<float*>(smem + CONTRACT_HEADER);
  float* const hdr = reinterpret_cast<float*>(smem + 16);  // sum log diag L of the two L buffers, |L^-1 i_m|^2
  float* const X = f + S.X;
  float* const Ms = f + S.Ms;
  float* const stage = f + S.stage;
  const int lt_size = n * S.lt, invd_size = (n + 3) & ~3;
  const unsigned bar0 = smem_u32(smem), ring0 = smem_u32(f + S.ring), pbytes = 4u * S.pb;
  const long long np = a.t / 2, pairs = (long long)a.R * np;
  const int nsmall = GAMMA ? 2 * n2 + 6 : 2 * n2 + 2;

  // the first two pairs' blocks into slots 0 and 1, the first's small rows
  // into slot 0 and its L into buffer 0
  long long q = blockIdx.x;
  PairAt w = pair_at(a, q < pairs ? q : 0, np);
  if (tid == 0) {
    mbar_init1(bar0);
    mbar_init1(bar0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (q < pairs) pair_fetch(a, w, ring0, bar0, pbytes);
    if (q + gridDim.x < pairs) pair_fetch(a, pair_at(a, q + gridDim.x, np), ring0 + 2 * pbytes, bar0 + 8, pbytes);
  }
  if (q < pairs)
    for (int e = tid; e < nsmall; e += nt) f[S.smallo + e] = pair_small(a, w, e);
  __syncthreads();
  if (warp == 0 && q < pairs) {
    mbar_wait_parity(bar0, 0);
    warp_cholesky(f + S.ring, f + S.ring + S.pb, Ms, f + S.Lt, f + S.invd, hdr, n, S, lane);
  }
  __syncthreads();

  for (int it = 0; q < pairs; q += gridDim.x, ++it) {
    const int s = it & 1;
    const long long qn = q + gridDim.x, o = w.r * a.t_out + w.p;
    const PairAt wn = pair_at(a, qn < pairs ? qn : q, np);
    if (warp == 0) {
      // the next pair, brought into the other slot a pair ago, factorised
      // into the other L buffer
      if (qn < pairs) {
        mbar_wait_parity(bar0 + 8 * (s ^ 1), ((it + 1) >> 1) & 1);
        const float* Pxn = f + S.ring + (s ^ 1) * 2 * S.pb;
        warp_cholesky(Pxn, Pxn + S.pb, Ms, f + S.Lt + (s ^ 1) * lt_size, f + S.invd + (s ^ 1) * invd_size,
                      hdr + (s ^ 1), n, S, lane);
      }
    } else {
      float pre = 0.f;  // the next pair's small rows, held until its slot is free
      if (qn < pairs && tt < nsmall) pre = pair_small(a, wn, tt);
      mbar_wait_parity(bar0 + 8 * s, (it >> 1) & 1);  // complete already: warp 0 waited before factorising
      const float* Px = f + S.ring + s * 2 * S.pb;
      const float* Py = Px + S.pb;
      const float* sm = f + S.smallo + s * S.small;
      const float* Lt = f + S.Lt + s * lt_size;
      const float* invd = f + S.invd + s * invd_size;

      // 1. X = [Px[lm]^T | Py[mr] | i_m]; P_kk into the staging block (free:
      //    the previous pair's store has read it); then the slot is free for
      //    the pair after next
      for (int i = warp - 1; i < n; i += (team >> 5))
        for (int j = lane; j < n; j += 32) {
          X[j * S.sx + i] = Px[i * n2 + n + j];
          X[i * S.sx + n + j] = Py[i * n2 + n + j];
        }
      if (tt < n) X[tt * S.sx + n2] = sm[n + tt] + sm[n2 + tt];
      if ((n & 1) == 0) {  // rows of 2n floats, a multiple of 4: float4 throughout
        for (int x = 4 * tt; x < S.pb; x += 4 * team) {
          const int i = x / n2, j = x % n2;
          const float4 px = *reinterpret_cast<const float4*>(Px + x), py = *reinterpret_cast<const float4*>(Py + x);
          const float cx[4] = {px.x, px.y, px.z, px.w}, cy[4] = {py.x, py.y, py.z, py.w};
          float kk[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) kk[v] = (i < n && j + v < n) ? cx[v] : (i >= n && j + v >= n) ? cy[v] : 0.f;
          *reinterpret_cast<float4*>(stage + x) = make_float4(kk[0], kk[1], kk[2], kk[3]);
        }
      } else {
        for (int x = tt; x < S.pb; x += team) {
          const int i = x / n2, j = x % n2;
          stage[x] = (i < n && j < n) ? Px[x] : (i >= n && j >= n) ? Py[x] : 0.f;
        }
      }
      team_sync(team);
      const long long qnn = qn + gridDim.x;
      if (tt == 0 && qnn < pairs) pair_fetch(a, pair_at(a, qnn, np), ring0 + s * 2 * pbytes, bar0 + 8 * s, pbytes);
      if (a.L_tape) {  // the tape: L, and P_mk and i_m before the solve
        for (int i = warp - 1; i < n; i += (team >> 5)) {
          for (int j = lane; j < n; j += 32) a.L_tape[(q * n + i) * n + j] = Lt[j * S.lt + i];
          for (int c = lane; c < nc; c += 32) {
            const float v = X[i * S.sx + c];
            if (c < n2) a.Pmk_tape[(q * n + i) * n2 + c] = v;
            else a.im_tape[q * n + i] = v;
          }
        }
        team_sync(team);
      }

      // 2. X = L^-1 X, a thread a column, blocks of 8 rows
      if (tt < nc) {
        for (int i0 = 0; i0 < n; i0 += 8) {
          float b[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) b[r] = i0 + r < n ? X[(i0 + r) * S.sx + tt] : 0.f;
          // the solved rows before the block, in order: b[r] -= L[i0 + r][k] x_k
#pragma unroll 4
          for (int k = 0; k < i0; ++k) {
            const float xk = X[k * S.sx + tt];
            const float4 u = *reinterpret_cast<const float4*>(Lt + k * S.lt + i0);
            const float4 v = *reinterpret_cast<const float4*>(Lt + k * S.lt + i0 + 4);
            const float c[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
            for (int r = 0; r < 8; ++r) b[r] = fmaf(-c[r], xk, b[r]);
          }
          // the block's own rows
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            if (i0 + r < n) {
              const float xr = b[r] * invd[i0 + r];
              b[r] = xr;
              const float4 u = *reinterpret_cast<const float4*>(Lt + (i0 + r) * S.lt + i0);
              const float4 v = *reinterpret_cast<const float4*>(Lt + (i0 + r) * S.lt + i0 + 4);
              const float c[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
              for (int e = r + 1; e < 8; ++e) b[e] = fmaf(-c[e], xr, b[e]);
            }
          }
#pragma unroll
          for (int r = 0; r < 8; ++r)
            if (i0 + r < n) X[(i0 + r) * S.sx + tt] = b[r];
        }
        if (tt == n2) {  // |L^-1 i_m|^2, in order
          float w2 = 0.f;
          for (int k = 0; k < n; ++k) w2 = fmaf(X[k * S.sx + n2], X[k * S.sx + n2], w2);
          hdr[2] = w2;
        }
      }
      team_sync(team);

      // 3. P' = P_kk - X^T X in 4 x 4 tiles in the staging block; info'
      const int cg = (n2 + 3) >> 2;
      for (int tile = tt; tile < cg * cg; tile += team) {
        const int i0 = (tile / cg) * 4, j0 = (tile % cg) * 4;
        float acc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float4 xi = *reinterpret_cast<const float4*>(X + k * S.sx + i0);
          const float4 xj = *reinterpret_cast<const float4*>(X + k * S.sx + j0);
          const float ci[4] = {xi.x, xi.y, xi.z, xi.w}, cj[4] = {xj.x, xj.y, xj.z, xj.w};
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(ci[u], cj[v], acc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          if (i >= n2) continue;
          float* row = stage + i * n2 + j0;
          if ((n & 1) == 0) {
            const float4 kk = *reinterpret_cast<const float4*>(row);
            *reinterpret_cast<float4*>(row) =
                make_float4(kk.x - acc[u][0], kk.y - acc[u][1], kk.z - acc[u][2], kk.w - acc[u][3]);
          } else {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (j0 + v < n2) row[v] -= acc[u][v];
          }
        }
      }
      const int ii = tt - (team - n2);
      if (ii >= 0) {
        float acc = ii < n ? sm[ii] : sm[n2 + ii];
#pragma unroll 4
        for (int k = 0; k < n; ++k) acc = fmaf(-X[k * S.sx + ii], X[k * S.sx + n2], acc);
        a.info_out[o * n2 + ii] = acc;
      }
      if (tt == 0) {
        const float* sc = sm + 2 * n2;  // logZ, alpha, beta of the two factors
        if constexpr (GAMMA) {
          a.logZ_out[o] = sc[0] + sc[1] + (float)n * HALF_LOG_2PI - hdr[s];
          a.alpha_out[o] = sc[2] + sc[3] - 0.5f * (float)n;
          a.beta_out[o] = sc[4] + sc[5] - 0.5f * hdr[2];
        } else {
          a.logZ_out[o] = sc[0] + sc[1] + (float)n * HALF_LOG_2PI - (hdr[s] - 0.5f * hdr[2]);
        }
      }
      if (qn < pairs && tt < nsmall) f[S.smallo + (s ^ 1) * S.small + tt] = pre;
      fence_proxy_async();
      team_sync(team);
      if (tt == 0) {
        bulk_store(a.P_out + o * S.pb, smem_u32(stage), pbytes);
        bulk_wait_read();  // the staging block free for the next pair (warp 0 is the longer path)
      }
    }
    __syncthreads();
    w = wn;
  }
  if (tt == 0) bulk_wait_all();
}

// Every launch of K4b or K5b passes its operands' RowStrides in `layout`:
// R_lo, then hi, lo, ts of P, info and logZ (and, GAMMA, alpha and beta).
static ContractArgs contract_args(const float* P, const float* info, const float* logZ, const float* alpha,
                                  const float* beta, const long long* layout, int R, int t, int n, int t_out) {
  ContractArgs a = {};
  a.P = P;
  a.info = info;
  a.logZ = logZ;
  a.alpha = alpha;
  a.beta = beta;
  a.R_lo = layout[0];
  RowStrides* s[5] = {&a.sP, &a.sI, &a.sZ, &a.sA, &a.sB};
  for (int k = 0; k < (alpha ? 5 : 3); ++k) *s[k] = {layout[1 + 3 * k], layout[2 + 3 * k], layout[3 + 3 * k]};
  a.R = R;
  a.t = t;
  a.n = n;
  a.t_out = t_out;
  return a;
}

// The dynamic shared memory K4b's CTA may take, set once an instantiation
// (its largest, at n = NMAX, is above the default 48 KB).
template <bool GAMMA>
static int contract_ready() {
  static bool ready = false;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(gl_contract_kernel<GAMMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)contract_smem_bytes(NMAX));
    if (err) return err;
    ready = true;
  }
  return 0;
}

// K4b's CTA at state dim n: 4 warps, 8 above n = 16 (P' has 4n^2 entries)
static int contract_threads(int n) { return n > 16 ? NT_CONTRACT : NT_CONTRACT / 2; }

template <bool GAMMA>
static int launch_contract(const ContractArgs& a, int blocks, cudaStream_t st) {
  const int err = contract_ready<GAMMA>();
  if (err) return err;
  gl_contract_kernel<GAMMA><<<blocks, contract_threads(a.n), contract_smem_bytes(a.n), st>>>(a);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- K4a backward --
//
// The design for Hopper.  One launch a level; a CTA of 256 threads (8
// warps), one an SM (95 KB of shared memory, up to 255 registers), walks
// tiles of 64 pairs, tile += gridDim.x.  Every state-dim array is held zero-padded to 32 rows and
// columns (the [a | b] halves of a 2n-vector to 32 each), so every product
// runs at fixed sizes with no test on n, on the tensor cores: mma.sync
// m16n8k8 tf32 in 3xTF32 (hb_mma, about float32's accuracy), 16 x 8 tiles
// split over the warps, operands from shared memory:
//   prologue, every CTA: L^T and C = [B^T | B] read along rows and stored
//     first; gP' copied into shared memory by cp.async for the end
//     (whichever CTA runs it) and the first tile's loads, in flight through
//     the prologue; warp 0 forms L^-1 (lane c column c, the rows in
//     registers, L's columns read as float4 broadcasts: no block barrier),
//     then Kt = L^-1 C;
//   per tile: the tile's ib, gi' and gZ' (brought into registers a tile
//     ahead while the CTA works on the one before); S = IB L^-T and GS =
//     gZ' S - GI Kt^T (each warp the same tiles of both); G_ib = GS L^-1;
//     ginfo and glogZ written; the adjoints of the shared Kt and L summed
//     in the warps' accumulators, S1 += S^T GI (32 x 64) and S2 += G_ib^T S
//     (32 x 32) over the tile's pairs, tile after tile.  The warps whose
//     rows hold no pair skip the products and the sums stop at the last
//     pair (levels of 8-72 pairs).  Four barriers a tile;
//   the sum over CTAs, in a fixed order: each CTA writes its partial (its
//     threads' entries, thread-major), then takes a ticket from its
//     group's counter (groups of `group` CTAs in block order); the last of
//     a group to arrive sums the group's partials in block order, and
//     where there is more than one group writes the group's sum and takes a
//     ticket from the last counter, whose last sums the groups' in order.
//     The CTA that ends last, whichever it is, has the same sums: two
//     launches give the same bits.  The wrapper sizes the grid and the
//     groups and lays out the partials, the groups' sums and the counters
//     (ops/gaussian_levels.py::halving_bwd_plan, from gl_halving_bwd_shape);
//     the C entry zeroes the counters on the stream before the launch;
//   the shared adjoint, by that CTA: gKt = -(S1 + Kt G), gCt = L^-T gKt, gL
//     = tril(-(S2 + gCt Kt^T)) - sum gZ' / L_jj, and the Cholesky adjoint
//     L^-T S L^-1, every solve a product with L^-1: seven barriers.
// What bounds it on an H100 (700 W): over the 13 levels of a homogeneous
// training step (B=8, T=10,000, n=32) the pairs move some 73 MB (22 us at
// 3.35 TB/s) for about 1 GFLOP (15 us on the f32 CUDA cores), most of it at
// the first three levels.  Eight of the 13 levels have at most 1248 pairs;
// there the chain of one CTA sets the time (15-21 us a level at 312 pairs
// and below, chip_smoke.py phase 10): the first loads, L^-1, Kt, one tile,
// the tickets, the shared adjoint's products and gP's stores in a row, each
// product a chain of latencies (shared memory, mma, a barrier), not a
// rate.  The earlier design (two kernels a level: a warp a pair, then one
// CTA summing the partials) took some 250 barriers a level on one CTA.

#define HB_NT 256        // threads of K4a backward's CTA
#define HB_TP 64         // pairs a tile
#define HB_LS 36         // row stride of the 32-wide arrays (floats, float4-aligned)
#define HB_GS 68         // row stride of the 64-wide arrays
#define HB_PARTIAL (12 * HB_NT + 1)  // floats of a partial: 12 entries a thread, then sum gZ'
#define HB_PRE 25        // a thread's share of a tile: 8 of ib, 16 of gi', 1 of gZ'
// shared memory, in floats
#define HB_LT 0                       // L^T (32 x 32)
#define HB_LINV (HB_LT + 32 * HB_LS)  // L^-1, rows
#define HB_LINVT (HB_LINV + 32 * HB_LS)  // L^-1 transposed
#define HB_KTT (HB_LINVT + 32 * HB_LS)   // Kt transposed (64 x 32)
#define HB_INVD (HB_KTT + 64 * HB_LS)    // 1 / L_jj
#define HB_TILE (HB_INVD + 32)
#define HB_IB HB_TILE                    // a tile: ib (64 x 32)
#define HB_GI (HB_IB + HB_TP * HB_LS)    // gi' (64 x 64)
#define HB_GZ (HB_GI + HB_TP * HB_GS)    // gZ' (64)
#define HB_S (HB_GZ + HB_TP)             // S = L^-1 ib (64 x 32); C in the prologue
#define HB_GSB (HB_S + HB_TP * HB_LS)    // GS
#define HB_GIB (HB_GSB + HB_TP * HB_LS)  // G_ib
#define HB_G (HB_GIB + HB_TP * HB_LS)   // gP', copied in at the start; then gP' + gP'^T (64 x 64)
#define HB_FLOATS (HB_G + 64 * HB_GS)
// the shared adjoint's arrays, over the tile's once the tiles are done
#define HB_GCT HB_TILE                    // gCt (32 x 64)
#define HB_GKT (HB_GCT + 32 * HB_GS)      // gKt (32 x 64)
#define HB_GL (HB_GKT + 32 * HB_GS)      // gL (32 x 32), then W in rows of 33 (read down its columns too)
#define HB_SM (HB_GL + 32 * HB_LS)       // the Cholesky adjoint's S, Sm
#define HB_T1 (HB_SM + 32 * HB_LS)       // T1 = Sm L^-1
#define HB_CTAS 1  // CTAs an SM: the launch bound, and the grid's width an SM (gl_halving_bwd_shape)

// The sums over CTAs go through the wrapper's buffers, laid out by
// ops/gaussian_levels.py::halving_bwd_plan: a partial of HB_PARTIAL floats
// a CTA, a sum a group where there is more than one, and groups + 1
// counters (a group's tickets, then the groups').
struct HalvingBwdArgs {
  const float *P, *L, *ib, *gP_out, *gi_out, *gZ_out;  // the upstream gradients null for zero
  long long pairs;  // R m
  int n, group, groups;
  float *parts, *sums;  // the CTAs' partials; the groups' sums (null for one group)
  int* counters;
  float *gP, *ginfo, *glogZ;
};

// 4 bytes from global `src` to shared `dst` without a register (cp.async).
__device__ __forceinline__ void hb_copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void hb_copy_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// x split for 3xTF32: big = tf32(x), small = tf32(x - big).
__device__ __forceinline__ void hb_split(float x, unsigned& big, unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(x - __uint_as_float(big)));
}

__device__ __forceinline__ void hb_mma1(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One warp's NB tiles of 16 x 8 of C += A B over k < K (a multiple of 8),
// on the tensor cores in 3xTF32 (big*big a k-step into c, small*big +
// big*small into a second chain added at the end: about float32's
// accuracy): A(m, k) = A[m a_m + k a_k] (m < 16), B(k, n) =
// B[k b_k + n b_n] (n < 8 NB), both in shared memory, A and B at the
// tiles' origin.  c[j][e] is the entry (g + 8 (e >> 1), 8 j + 2 t + (e & 1))
// of the warp's tiles, g = lane / 4, t = lane % 4 (mma.m16n8k8's layout).
template <int NB>
__device__ __forceinline__ void hb_mma(float (&c)[NB][4], int K, const float* A, int a_m, int a_k, const float* B,
                                       int b_k, int b_n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* pa = A + g * a_m + t * a_k;
  const float* pb = B + t * b_k + g * b_n;
  float cs[NB][4];  // the small terms in a chain of their own, added at the end
#pragma unroll
  for (int j = 0; j < NB; ++j) cs[j][0] = cs[j][1] = cs[j][2] = cs[j][3] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 8, pa += 8 * a_k, pb += 8 * b_k) {
    unsigned ab[4], as[4];
    hb_split(pa[0], ab[0], as[0]);
    hb_split(pa[8 * a_m], ab[1], as[1]);
    hb_split(pa[4 * a_k], ab[2], as[2]);
    hb_split(pa[8 * a_m + 4 * a_k], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      unsigned bb[2], bs[2];
      hb_split(pb[8 * j * b_n], bb[0], bs[0]);
      hb_split(pb[8 * j * b_n + 4 * b_k], bb[1], bs[1]);
      hb_mma1(cs[j], as, bb);
      hb_mma1(cs[j], ab, bs);
      hb_mma1(c[j], ab, bb);
    }
  }
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += cs[j][e];
}

template <int NB>
__device__ __forceinline__ void hb_zero(float (&c)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
}

// Where entry e of tile j of a warp's C fragments lies: row, column.
__device__ __forceinline__ int hb_row(int e) { return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1); }
__device__ __forceinline__ int hb_col(int j, int e) { return 8 * j + 2 * (threadIdx.x & 3) + (e & 1); }

// A warp's tiles into the matrix at `out` (row stride rs), at their origin.
template <int NB>
__device__ __forceinline__ void hb_put_tiles(float* out, int rs, const float (&c)[NB][4]) {
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[hb_row(e) * rs + hb_col(j, e)] = c[j][e];
}

__device__ __forceinline__ void hb_store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One warp: 1 / L_jj into invd (32 floats; 1 past n), and L^-1 from L^T
// (zero-padded to NP, rows LS floats apart, 16-byte aligned) by forward
// substitution of the unit vectors, lane c column c, right-looking (row k
// final once scaled by 1 / L_kk, then every later row takes its multiple),
// straight-line code over NP; into Linv (rows) and LinvT (columns), zero
// outside n x n.  NP is the padded state dim, NMAX or 16 (lanes past it
// idle).
template <int NP = NMAX, int LS = HB_LS>
__device__ __forceinline__ void hb_tri_inverse(const float* Lt, float* invd, int n, int lane, float* Linv,
                                               float* LinvT) {
  invd[lane] = lane < n ? 1.f / Lt[lane * LS + lane] : 1.f;
  __syncwarp();
  float x[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) x[i] = i == lane ? 1.f : 0.f;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    x[k] *= invd[k];
    const float* col = Lt + k * LS;  // L[i][k] over i
#pragma unroll
    for (int i4 = (k + 1) & ~3; i4 < NP; i4 += 4) {
      const float4 l = *reinterpret_cast<const float4*>(col + i4);
      const float lv[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
      for (int v = 0; v < 4; ++v)
        if (i4 + v > k) x[i4 + v] = fmaf(-lv[v], x[k], x[i4 + v]);
    }
  }
  if (NP < 32 && lane >= NP) return;
  const bool in = lane < n;  // columns past n are the unit vectors: written as zero
#pragma unroll
  for (int i = 0; i < NP; ++i) Linv[i * LS + lane] = in ? x[i] : 0.f;
#pragma unroll
  for (int i = 0; i < NP; i += 4) {
    const float v[4] = {in ? x[i] : 0.f, in ? x[i + 1] : 0.f, in ? x[i + 2] : 0.f, in ? x[i + 3] : 0.f};
    hb_store4(LinvT + lane * LS + i, v);
  }
}

// This thread's share of tile `tile` (pairs 64 tile ...) into registers,
// zero past the last pair, past n and for a null gradient.
__device__ __forceinline__ void hb_fetch(const HalvingBwdArgs& a, long long tile, float (&pre)[HB_PRE]) {
  const int tid = threadIdx.x, n = a.n;
  const long long q0 = tile * HB_TP;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int x = tid + r * HB_NT, k = x & 31;
    const long long q = q0 + (x >> 5);
    pre[r] = (q < a.pairs && k < n) ? a.ib[q * n + k] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int x = tid + r * HB_NT, k = x & 31, h = (x >> 5) & 1;
    const long long q = q0 + (x >> 6);
    pre[8 + r] = (a.gi_out && q < a.pairs && k < n) ? a.gi_out[q * 2 * n + h * n + k] : 0.f;
  }
  pre[24] = (a.gZ_out && tid < HB_TP && q0 + tid < a.pairs) ? a.gZ_out[q0 + tid] : 0.f;
}

__device__ __forceinline__ void hb_stage(const float (&pre)[HB_PRE], float* hs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int x = tid + r * HB_NT;
    hs[HB_IB + (x >> 5) * HB_LS + (x & 31)] = pre[r];
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int x = tid + r * HB_NT;
    hs[HB_GI + (x >> 6) * HB_GS + (x & 63)] = pre[8 + r];
  }
  if (tid < HB_TP) hs[HB_GZ + tid] = pre[24];
}

// All threads: whether this CTA is the last of `expected` to take a ticket
// from `counter`, its writes before it visible to the one that is.
__device__ __forceinline__ bool hb_last(int* counter, int expected) {
  __shared__ int flag;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) flag = atomicAdd(counter, 1) == expected - 1;
  __syncthreads();
  const bool last = flag;
  if (last) __threadfence();
  return last;
}

// The partials b0 .. b1 - 1 at `parts` summed in that order into this
// thread's entries v (and z, thread 0's sum gZ'); read past L1.
__device__ __forceinline__ void hb_sum(const float* parts, int b0, int b1, float (&v)[12], float& z) {
  const int tid = threadIdx.x;
  const float* p = parts + (long long)b0 * HB_PARTIAL + tid;
#pragma unroll
  for (int j = 0; j < 12; ++j) v[j] = __ldcg(p + j * HB_NT);
  if (tid == 0) z = __ldcg(p + 12 * HB_NT);
#pragma unroll 8
  for (int b = b0 + 1; b < b1; ++b) {  // eight partials' loads in flight at once
    p += HB_PARTIAL;
#pragma unroll
    for (int j = 0; j < 12; ++j) v[j] += __ldcg(p + j * HB_NT);
    if (tid == 0) z += __ldcg(p + 12 * HB_NT);
  }
}

__device__ __forceinline__ void hb_put(float* part, const float (&v)[12], float z) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int j = 0; j < 12; ++j) part[j * HB_NT + tid] = v[j];
  if (tid == 0) part[12 * HB_NT] = z;
}

// One halving level's backward.  P (2n, 2n), L (n, n) and ib (R, m, n)
// from the forward; gP_out (2n, 2n), gi_out (R, m, 2n), gZ_out (R, m)
// upstream; outputs gP (2n, 2n) symmetrised, ginfo (R, 2m, 2n), glogZ (R,
// 2m).  Any grid; HB_FLOATS floats of dynamic shared memory.  Each product
// is split over the 8 warps in tiles of 16 x 8 (hb_mma): a 64 x 32 product
// (the tile's) as 16 rows and 16 columns a warp, a 32 x 64 (S1, Kt and the
// adjoint's n x 2n) as 16 and 16, a 32 x 32 as 16 and 8.
__global__ void __launch_bounds__(HB_NT, HB_CTAS) gl_halving_bwd_kernel(const HalvingBwdArgs a) {
  extern __shared__ __align__(16) float hs[];
  __shared__ float zsum;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, n = a.n, n2 = 2 * n;
  const long long tiles = (a.pairs + HB_TP - 1) / HB_TP;
  float* const Lt = hs + HB_LT;
  float* const Linv = hs + HB_LINV;
  float* const LinvT = hs + HB_LINVT;
  float* const KtT = hs + HB_KTT;
  float* const invd = hs + HB_INVD;
  float* const G = hs + HB_G;
  const int tm = 16 * (warp >> 1), tn = 16 * (warp & 1);  // a warp's tiles of a 64 x 32 product
  const int wm = 16 * (warp >> 2), wn = 16 * (warp & 3);  // of a 32 x 64 product
  const int vn = 8 * (warp & 3);                          // of a 32 x 32 product (rows wm)

  // prologue: L^T and C = [B^T | B] (into the S buffer), read along rows
  // of L and P (the transposes are made in shared memory) and stored
  // before any other memory operation is queued; then gP' copied in
  // (cp.async, zero-padded) for the shared adjoint, whichever CTA runs it,
  // and the first tile's loads, both in flight through the prologue; L^-1
  // by warp 0; Kt = L^-1 C, stored transposed
  {
    float lt[4], b[4];
    const int u = tid >> 5, w = tid & 31;  // row u + 8 r, column w
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = u + 8 * r;
      const bool in = i < n && w < n;
      lt[r] = in ? a.L[i * n + w] : 0.f;      // L[i][w]
      b[r] = in ? a.P[i * n2 + n + w] : 0.f;  // B[i][w]
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = u + 8 * r;
      Lt[w * HB_LS + i] = lt[r];
      hs[HB_S + w * HB_GS + i] = b[r];       // C[:, :n] = B^T
      hs[HB_S + i * HB_GS + 32 + w] = b[r];  // C[:, n:] = B
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int x = tid + e * HB_NT, r = x >> 6, c = x & 63, i = r & 31, j = c & 31;
    if (a.gP_out && i < n && j < n) hb_copy4(G + r * HB_GS + c, a.gP_out + ((r >> 5) * n + i) * n2 + (c >> 5) * n + j);
    else G[r * HB_GS + c] = 0.f;
  }
  float pre[HB_PRE];
  long long tile = blockIdx.x;
  if (tile < tiles) hb_fetch(a, tile, pre);
  __syncthreads();
  if (warp == 0) hb_tri_inverse(Lt, invd, n, lane, Linv, LinvT);
  __syncthreads();
  {
    float kt[2][4];
    hb_zero(kt);
    hb_mma<2>(kt, 32, Linv + wm * HB_LS, HB_LS, 1, hs + HB_S + wn, HB_GS, 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) KtT[(wn + hb_col(j, e)) * HB_LS + wm + hb_row(e)] = kt[j][e];
  }

  // the tiles
  float s1[2][4], s2[1][4], zacc = 0.f;
  hb_zero(s1);
  hb_zero(s2);
  for (; tile < tiles; tile += gridDim.x) {
    hb_stage(pre, hs);
    if (tile + gridDim.x < tiles) hb_fetch(a, tile + gridDim.x, pre);
    const long long q0 = tile * HB_TP;
    // the tile's rows that hold pairs, rounded up to 8 (the rest are zero):
    // the warps past them skip the products, the sums stop at them
    const int kv = (int)min((long long)HB_TP, (a.pairs - q0 + 7) & ~7LL);
    __syncthreads();
    if (tm < kv) {  // S = IB L^-T, GS = gZ' S - GI Kt^T
      float sv[2][4], x[2][4];
      hb_zero(sv);
      hb_mma<2>(sv, 32, hs + HB_IB + tm * HB_LS, HB_LS, 1, LinvT + tn, HB_LS, 1);
      hb_zero(x);
      hb_mma<2>(x, 64, hs + HB_GI + tm * HB_GS, HB_GS, 1, KtT + tn, HB_LS, 1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = tm + hb_row(e), i = tn + hb_col(j, e);
          hs[HB_S + p * HB_LS + i] = sv[j][e];
          hs[HB_GSB + p * HB_LS + i] = fmaf(hs[HB_GZ + p], sv[j][e], -x[j][e]);
        }
    }
    __syncthreads();
    if (tm < kv) {  // G_ib = GS L^-1
      float gib[2][4];
      hb_zero(gib);
      hb_mma<2>(gib, 32, hs + HB_GSB + tm * HB_LS, HB_LS, 1, Linv + tn, HB_LS, 1);
      hb_put_tiles(hs + HB_GIB + tm * HB_LS + tn, HB_LS, gib);
    }
    __syncthreads();
    // S1 += S^T GI, S2 += G_ib^T S over the tile's pairs, and its outputs
    hb_mma<2>(s1, kv, hs + HB_S + wm, 1, HB_LS, hs + HB_GI + wn, HB_GS, 1);
    hb_mma<1>(s2, kv, hs + HB_GIB + wm, 1, HB_LS, hs + HB_S + vn, HB_LS, 1);
    if (warp == 0) zacc += hs[HB_GZ + lane] + hs[HB_GZ + 32 + lane];
    for (int x = tid; x < kv * 32; x += HB_NT) {  // a pair's rows 2q, 2q + 1: [gi'_a | g_ib | g_ib | gi'_b]
      const int p = x >> 5, quarter = (x >> 3) & 3, k = (x & 7) << 2;
      const long long q = q0 + p;
      if (q < a.pairs && k < n) {
        const float4 v = *reinterpret_cast<const float4*>(
            hs + (quarter == 0 ? HB_GI + p * HB_GS + k : quarter == 3 ? HB_GI + p * HB_GS + 32 + k
                                                                      : HB_GIB + p * HB_LS + k));
        float* out = a.ginfo + q * 2 * n2 + quarter * n + k;
        if ((n & 3) == 0) {
          *reinterpret_cast<float4*>(out) = v;
        } else {
          const float w[4] = {v.x, v.y, v.z, v.w};
          for (int e = 0; e < 4 && k + e < n; ++e) out[e] = w[e];
        }
      }
    }
    if (tid < 2 * HB_TP && q0 + (tid >> 1) < a.pairs) a.glogZ[2 * q0 + tid] = hs[HB_GZ + (tid >> 1)];
    __syncthreads();
  }

  // the sums over the CTAs, in block order
  hb_copy_wait();
  float v[12];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = s1[0][e];
    v[4 + e] = s1[1][e];
    v[8 + e] = s2[0][e];
  }
  float z = warp == 0 ? warp_sum(zacc) : 0.f;
  if (gridDim.x > 1) {
    const int g = blockIdx.x / a.group, b0 = g * a.group, b1 = min(b0 + a.group, (int)gridDim.x);
    hb_put(a.parts + (long long)blockIdx.x * HB_PARTIAL, v, z);
    if (!hb_last(a.counters + g, b1 - b0)) return;
    hb_sum(a.parts, b0, b1, v, z);
    if (a.groups > 1) {
      hb_put(a.sums + (long long)g * HB_PARTIAL, v, z);
      if (!hb_last(a.counters + a.groups, a.groups)) return;
      hb_sum(a.sums, 0, a.groups, v, z);
    }
  }

  // the shared adjoint, by the CTA that ended last; S1 and S2 stay in the
  // registers of the warps whose tiles of gKt and gL they start
  float* const gCt = hs + HB_GCT;
  float* const gKt = hs + HB_GKT;
  float* const gL = hs + HB_GL;  // then W
  float* const Sm = hs + HB_SM;
  float* const T1 = hs + HB_T1;
  __syncthreads();  // every thread's copies of gP' in place
  if (tid == 0) zsum = z;
#pragma unroll
  for (int e = 0; e < 16; ++e) {  // G = gP' + gP'^T, each pair of entries by one thread
    const int x = tid + e * HB_NT, r = x >> 6, c = x & 63;
    if (r <= c) G[r * HB_GS + c] = G[c * HB_GS + r] = G[r * HB_GS + c] + G[c * HB_GS + r];
  }
  __syncthreads();
  {  // gKt = -(S1 + Kt G)
    float f[2][4] = {{v[0], v[1], v[2], v[3]}, {v[4], v[5], v[6], v[7]}};
    hb_mma<2>(f, 64, KtT + wm, 1, HB_LS, G + wn, HB_GS, 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) gKt[(wm + hb_row(e)) * HB_GS + wn + hb_col(j, e)] = -f[j][e];
  }
  __syncthreads();
  {  // gCt = L^-T gKt
    float f[2][4];
    hb_zero(f);
    hb_mma<2>(f, 32, Linv + wm, 1, HB_LS, gKt + wn, HB_GS, 1);
    hb_put_tiles(gCt + wm * HB_GS + wn, HB_GS, f);
  }
  __syncthreads();
  {  // gL = tril(-(S2 + gCt Kt^T)) - sum gZ' / L_jj on the diagonal
    float f[1][4] = {{v[8], v[9], v[10], v[11]}};
    hb_mma<1>(f, 64, gCt + wm * HB_GS, HB_GS, 1, KtT + vn, HB_LS, 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = wm + hb_row(e), j = vn + hb_col(0, e);
      gL[i * HB_LS + j] = (j <= i && i < n) ? -f[0][e] - (i == j ? zsum * invd[i] : 0.f) : 0.f;
    }
  }
  __syncthreads();
  {  // the Cholesky adjoint: Sm = the symmetric matrix of tril(L^T gL), halved
    float f[1][4];
    hb_zero(f);
    hb_mma<1>(f, 32, Lt + wm * HB_LS, HB_LS, 1, gL + vn, HB_LS, 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = wm + hb_row(e), j = vn + hb_col(0, e);
      if (j <= i) Sm[i * HB_LS + j] = Sm[j * HB_LS + i] = 0.5f * f[0][e];
    }
  }
  __syncthreads();
  {  // T1 = Sm L^-1
    float f[1][4];
    hb_zero(f);
    hb_mma<1>(f, 32, Sm + wm * HB_LS, HB_LS, 1, Linv + vn, HB_LS, 1);
    hb_put_tiles(T1 + wm * HB_LS + vn, HB_LS, f);
  }
  __syncthreads();
  {  // W = L^-T T1, over gL in rows of 33 floats (its transpose is read too)
    float f[1][4];
    hb_zero(f);
    hb_mma<1>(f, 32, Linv + wm, 1, HB_LS, T1 + vn, HB_LS, 1);
    hb_put_tiles(gL + wm * 33 + vn, 33, f);
  }
  __syncthreads();
  // gP: the diagonal blocks sym(gP') + (W + W^T) / 2, the off-diagonal
  // (gCt[:, :n]^T + gCt[:, n:]) / 2 and its transpose
  const float* W = gL;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int x = tid + e * HB_NT, r = x >> 6, c = x & 63, i = r & 31, j = c & 31, hi = r >> 5, hj = c >> 5;
    if (i < n && j < n) {
      float val;
      if (hi == hj) val = 0.5f * G[r * HB_GS + c] + 0.5f * (W[i * 33 + j] + W[j * 33 + i]);
      else if (!hi) val = 0.5f * (gCt[j * HB_GS + i] + gCt[i * HB_GS + 32 + j]);
      else val = 0.5f * (gCt[i * HB_GS + j] + gCt[j * HB_GS + 32 + i]);
      a.gP[(hi * n + i) * n2 + hj * n + j] = val;
    }
  }
}

static int halving_bwd_ready() {
  static bool ready = false;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(gl_halving_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              HB_FLOATS * (int)sizeof(float));
    if (err) return err;
    ready = true;
  }
  return 0;
}

// ------------------------------------------------------ K4a and K5a --
//
// The design for Hopper (gl_halving_kernel<GAMMA>: K4a, and K5a as its
// <true> instantiation).  One launch a level; a CTA of 256 threads (8
// warps), one an SM (HV_CTAS: up to 255 registers a thread; at two an SM,
// 128, the straight-line factorisation and the tiles' products spilled and
// ran slower), walks tiles of 64 pairs of one row, tile += gridDim.x, over
// a grid of min(tiles, CTAs the card runs at once)
// (ops/gaussian_levels.py::halving_plan, from gl_halving_shape).  Every
// state-dim array is held zero-padded to 32 (the halves of a 2n-vector to
// 32 each), as in K4a's backward above, so the products run at fixed sizes
// with no test on n, on the tensor cores (hb_mma: mma.sync tf32 in 3xTF32,
// about float32's accuracy; its operands come from shared memory, where
// f32 register tiles of the same products ran at the shared-memory rate in
// K4a's backward):
//   prologue, every CTA: J = D + A, A, D and C = [B^T | B] in (coalesced,
//     a thread an entry), the first tile's loads issued; warp 0 factorises
//     J with its rows in registers (hv_cholesky: lane i row i, straight-line
//     code, each pivot formed by every lane, no shuffle) and forms 1 / L_jj
//     and L^-1 (hb_tri_inverse); the tile set out; Kt = L^-1 C (32 x 64 x 32);
//     P' = diag(A, D) - Kt^T Kt in four slabs of 16 rows over the first
//     CTAs (written symmetric), L by CTA 0.  Three block barriers, none
//     inside the factorisation;
//   per tile: S = IB L^-T; info' = OUTER - S Kt, stored from the product's
//     registers (two adjacent columns a thread); |s|^2 a row sum in index
//     order, then logZ' (and alpha', beta'); then the next tile, its info
//     in registers since this one started (a thread's share: the four half
//     rows i1[:n], i1[n:], i2[:n], i2[n:] of 8 pairs at one state index, so
//     the thread forms ib = i1[n:] + i2[:n] itself), set out as IB (64 x 32)
//     and OUTER = [i1[:n] | i2[n:]] (64 x 64), its pairs' scalars in shared
//     memory by cp.async.  Three barriers a tile; the warps whose 16 rows
//     hold no pair skip the products (a level's last tiles hold 1-39
//     pairs).
// What bounds it on an H100 (700 W): over the 13 levels of a homogeneous
// log_prob (B=8, T=10,000, n=32) the pairs move some 63 MB (19 us at 3.35
// TB/s) for 0.43 GFLOP, most of it at the first two levels.  From the
// fourth level on a level is one or two tiles a CTA, and one CTA's chain
// sets its time, some 17,000 cycles to the end of its first tile (clock64
// marks in CTA 0, examples/halving_timing.py's levels): J and C in 2,100,
// the factorisation 5,000 (3,500 of it the 32 pivots, a reciprocal square
// root and a round trip through shared memory each), L^-1 2,500, Kt 1,300,
// P''s slab 1,900, a tile's two products 2,700.  J's rows read from global
// memory by the lane that holds them (a warp's load 32 rows apart) took
// 7,000-10,000 cycles more; warp_cholesky (K4b's) on P in shared memory
// took 12,000 for the factorisation.

#define HV_NT 256    // threads of K4a's and K5a's CTA: 8 warps
#define HV_TP 64     // pairs a tile
#define HV_CTAS 1    // the launch bound: CTAs an SM (the grid's width an SM comes from the occupancy at launch)
#define HV_KS 72     // row stride of C and Kt: conflict-free as an mma operand, either way round
#define HV_OS 68     // row stride of OUTER
#define HV_PRE 32    // a thread's share of a tile's info: 8 pairs' four half rows
#define HV_SLABS 4   // P' in slabs of 16 of its 64 padded rows, one a CTA
// shared memory, in floats (the 32-wide arrays in rows of HB_LS)
#define HV_J 0                           // J = D + A (rows of 33: a lane a row reads without bank conflict)
#define HV_A (HV_J + NMAX * 36)          // A and D (rows of 33): the diagonal blocks of P'
#define HV_D (HV_A + NMAX * 36)
#define HV_LT (HV_D + NMAX * 36)         // L^T
#define HV_LINV (HV_LT + 32 * HB_LS)     // L^-1, rows
#define HV_LINVT (HV_LINV + 32 * HB_LS)  // L^-1 transposed (hb_tri_inverse writes it; not read)
#define HV_INVD (HV_LINVT + 32 * HB_LS)  // 1 / L_jj
#define HV_C (HV_INVD + 32)              // C = [B^T | B] (32 x 64)
#define HV_KT (HV_C + 32 * HV_KS)        // Kt (32 x 64)
#define HV_IB (HV_KT + 32 * HV_KS)       // a tile: ib (64 x 32)
#define HV_OUT (HV_IB + HV_TP * HB_LS)   // OUTER (64 x 64)
#define HV_S (HV_OUT + HV_TP * HV_OS)    // S = IB L^-T (64 x 32)
#define HV_SC (HV_S + HV_TP * HB_LS)     // the pairs' scalars, two tiles' of 6 rows of 64
#define HV_FLOATS (HV_SC + 2 * 6 * HV_TP)

// P (2n, 2n); info (R, 2m, 2n), logZ (R, 2m) with row strides (elements);
// outputs P_out (2n, 2n), L_out (n, n), info_out (R, m, 2n), logZ_out (R,
// m), and ib_out (R, m, n) unless null.  GAMMA (K5a): alpha and beta (R,
// 2m) in, alpha_out and beta_out (R, m) out, and logZ' without |s|^2 / 2.
struct HalvingArgs {
  const float *P, *info, *logZ, *alpha, *beta;
  long long info_rs, logZ_rs, alpha_rs, beta_rs;
  int R, m, n;
  float *P_out, *L_out, *info_out, *logZ_out, *ib_out, *alpha_out, *beta_out;
};

// A tile: row r, its first pair p0 and its np pairs.
struct HvTile {
  int r, p0, np;
};

__device__ __forceinline__ HvTile hv_tile(const HalvingArgs& a, int tile, int tiles_a_row) {
  HvTile t;
  t.r = tile / tiles_a_row;
  t.p0 = (tile - t.r * tiles_a_row) * HV_TP;
  t.np = min(HV_TP, a.m - t.p0);
  return t;
}

// Warp 0: L = chol(J), J (Js, rows of 33, zero-padded to NMAX as the
// identity), lane i row i in registers; right-looking, each entry less
// L[i][j] L[c][j] for j = 0, 1, ... in turn, each pivot by a reciprocal
// square root with one Newton step (warp_cholesky's arithmetic, bit for
// bit).  Every lane keeps the diagonal's updates too (dg, the same values
// in every lane), so a pivot needs no broadcast; column j of L goes through
// shared memory (Lt's row j) to the lanes' updates.  Into Lt (Lt[j HB_LS +
// i] = L[i][j], zero above the diagonal, the identity's past n) and
// *logdet (sum log L_jj over j < n).
__device__ __forceinline__ void hv_cholesky(const float* Js, int n, int lane, float* Lt, float* logdet) {
  const bool row = lane < n;
  float a[NMAX], dg[NMAX];
#pragma unroll
  for (int c = 0; c < NMAX; ++c) {
    a[c] = Js[lane * 33 + c];
    dg[c] = Js[c * 33 + c];
  }
  float diag = 1.f;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const float piv = dg[j];
    float rs = rsqrtf(piv);
    rs *= fmaf(-0.5f * piv * rs, rs, 1.5f);
    const float l = a[j] * rs;
    if (lane == j) diag = l;
    a[j] = lane >= j ? l : 0.f;
    Lt[j * HB_LS + lane] = a[j];
    __syncwarp();
#pragma unroll
    for (int c4 = (j + 1) & ~3; c4 < NMAX; c4 += 4) {
      const float4 v = *reinterpret_cast<const float4*>(Lt + j * HB_LS + c4);
      const float lc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c4 + u > j) {
          a[c4 + u] = fmaf(-l, lc[u], a[c4 + u]);
          dg[c4 + u] = fmaf(-lc[u], lc[u], dg[c4 + u]);
        }
    }
  }
  const float v = warp_sum(row ? logf(diag) : 0.f);
  if (lane == 0) *logdet = v;
}

// This thread's share of tile t's info into registers: pair p = warp + 8
// s's half rows at state index lane into pre[4 s ...], zero past the tile's
// pairs and past n.
__device__ __forceinline__ void hv_fetch(const HalvingArgs& a, const HvTile& t, float (&pre)[HV_PRE]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n = a.n, n2 = 2 * n;
  const float* base = a.info + t.r * a.info_rs + 2LL * t.p0 * n2 + lane;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int p = warp + 8 * s;
    const bool in = lane < n && p < t.np;
    const float* f1 = base + 2LL * p * n2;
    pre[4 * s] = in ? __ldg(f1) : 0.f;
    pre[4 * s + 1] = in ? __ldg(f1 + n) : 0.f;
    pre[4 * s + 2] = in ? __ldg(f1 + n2) : 0.f;
    pre[4 * s + 3] = in ? __ldg(f1 + n2 + n) : 0.f;
  }
}

// The share in pre set out as IB and OUTER in shared memory, and ib into
// the tape.
__device__ __forceinline__ void hv_stage(const HalvingArgs& a, const HvTile& t, const float (&pre)[HV_PRE], float* hv) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long o = (long long)t.r * a.m + t.p0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const int p = warp + 8 * s;
    const float ib = pre[4 * s + 1] + pre[4 * s + 2];
    hv[HV_IB + p * HB_LS + lane] = ib;
    hv[HV_OUT + p * HV_OS + lane] = pre[4 * s];
    hv[HV_OUT + p * HV_OS + 32 + lane] = pre[4 * s + 3];
    if (a.ib_out && lane < a.n && p < t.np) a.ib_out[(o + p) * a.n + lane] = ib;
  }
}

// Thread p < np of tile t: the pair's two log normalisers (and alphas and
// betas) into rows 0-1 (2-5) of sc (6 rows of 64) by cp.async, then a
// commit group of the thread's own (empty for the other threads).
template <bool GAMMA>
__device__ __forceinline__ void hv_scalars(const HalvingArgs& a, const HvTile& t, float* sc) {
  const int p = threadIdx.x;
  if (p < t.np) {
    const long long f = 2LL * (t.p0 + p), r = t.r;
    hb_copy4(sc + p, a.logZ + r * a.logZ_rs + f);
    hb_copy4(sc + HV_TP + p, a.logZ + r * a.logZ_rs + f + 1);
    if constexpr (GAMMA) {
      hb_copy4(sc + 2 * HV_TP + p, a.alpha + r * a.alpha_rs + f);
      hb_copy4(sc + 3 * HV_TP + p, a.alpha + r * a.alpha_rs + f + 1);
      hb_copy4(sc + 4 * HV_TP + p, a.beta + r * a.beta_rs + f);
      hb_copy4(sc + 5 * HV_TP + p, a.beta + r * a.beta_rs + f + 1);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One halving level of a homogeneous chain (K4a; K5a with GAMMA).  Any
// grid; HV_FLOATS floats of dynamic shared memory.  The products are split
// over the 8 warps in tiles of 16 x 8 (hb_mma): Kt (32 x 64) as 16 rows and
// 16 columns a warp, a slab of P' (16 x 64) as 16 and 8, S (64 x 32) as 16
// and 16, info' (64 x 64) as 16 and 32; a warp's rows of info' are its rows
// of S.
template <bool GAMMA>
__global__ void __launch_bounds__(HV_NT, HV_CTAS) gl_halving_kernel(const HalvingArgs a) {
  extern __shared__ __align__(16) float hv[];
  __shared__ float half_logdet;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, n = a.n, n2 = 2 * n;
  const int tiles_a_row = (a.m + HV_TP - 1) / HV_TP, tiles = a.R * tiles_a_row;
  float* const Lt = hv + HV_LT;
  float* const Linv = hv + HV_LINV;
  float* const C = hv + HV_C;
  float* const Kt = hv + HV_KT;
  const int tm = 16 * (warp >> 1);  // a warp's rows of a 64-row product

  // prologue: J, A, D and C in, the first tile's loads and its scalars'
  // copies issued; warp 0 factorises J and inverts L; the tile set out; Kt
  // = L^-1 C; P' and L written
  int tile = blockIdx.x;
  HvTile t = {0, 0, 0};
  float pre[HV_PRE];
  if (tile < tiles) t = hv_tile(a, tile, tiles_a_row);
  hv_scalars<GAMMA>(a, t, hv + HV_SC);
  {  // J = D + A, A, D and C = [B^T | B] in, coalesced: entry (i, j) of D, A and B a thread
    float d[4], q[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = tid + e * HV_NT, i = x >> 5, j = x & 31;
      const bool in = i < n && j < n;
      d[e] = in ? __ldg(a.P + (n + i) * n2 + n + j) : 0.f;
      q[e] = in ? __ldg(a.P + i * n2 + j) : 0.f;
      b[e] = in ? __ldg(a.P + i * n2 + n + j) : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = tid + e * HV_NT, i = x >> 5, j = x & 31;
      hv[HV_J + i * 33 + j] = i < n && j < n ? d[e] + q[e] : (i == j ? 1.f : 0.f);
      hv[HV_A + i * 33 + j] = q[e];
      hv[HV_D + i * 33 + j] = d[e];
      C[i * HV_KS + 32 + j] = b[e];
      C[j * HV_KS + i] = b[e];
    }
  }
  if (tile < tiles) hv_fetch(a, t, pre);
  __syncthreads();
  if (warp == 0) {
    hv_cholesky(hv + HV_J, n, lane, Lt, &half_logdet);
    hb_tri_inverse(Lt, hv + HV_INVD, n, lane, Linv, hv + HV_LINVT);
  }
  if (tile < tiles) hv_stage(a, t, pre, hv);
  __syncthreads();
  {
    const int wm = 16 * (warp >> 2), wn = 16 * (warp & 3);
    float kt[2][4];
    hb_zero(kt);
    hb_mma<2>(kt, 32, Linv + wm * HB_LS, HB_LS, 1, C + wn, HV_KS, 1);
    hb_put_tiles(Kt + wm * HV_KS + wn, HV_KS, kt);
  }
  __syncthreads();
  for (int b = blockIdx.x; b < HV_SLABS; b += gridDim.x) {
    // P' = diag(A, D) - Kt^T Kt, rows 16 b ...; the entry (r, c), r >= c,
    // written at (r, c) and (c, r)
    float pp[1][4];
    hb_zero(pp);
    hb_mma<1>(pp, 32, Kt + 16 * b, 1, HV_KS, Kt + 8 * warp, HV_KS, 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * b + hb_row(e), c = 8 * warp + hb_col(0, e), i = r & 31, k = c & 31;
      if (i < n && k < n && r >= c) {
        const int gi = (r >> 5) * n + i, gj = (c >> 5) * n + k;
        const float v = ((r >> 5) == (c >> 5) ? hv[(r >> 5 ? HV_D : HV_A) + i * 33 + k] : 0.f) - pp[0][e];
        a.P_out[gi * n2 + gj] = v;
        a.P_out[gj * n2 + gi] = v;
      }
    }
  }
  if (blockIdx.x == 0) {
    for (int x = tid; x < 32 * 32; x += HV_NT) {
      const int i = x >> 5, j = x & 31;
      if (i < n && j < n) a.L_out[i * n + j] = Lt[j * HB_LS + i];
    }
  }

  // the tiles: IB and OUTER hold this one's, the next one's loads in flight
  const float c0 = (float)n * HALF_LOG_2PI;
  const int tn = 16 * (warp & 1), tn2 = 32 * (warp & 1);
  for (int k = 0; tile < tiles; tile += gridDim.x, ++k) {
    const HvTile cur = t;
    const bool more = tile + gridDim.x < tiles;
    if (more) {
      t = hv_tile(a, tile + gridDim.x, tiles_a_row);
      hv_fetch(a, t, pre);
    }
    hv_scalars<GAMMA>(a, more ? t : HvTile{0, 0, 0}, hv + HV_SC + ((k + 1) & 1) * 6 * HV_TP);
    if (tm < cur.np) {  // S = IB L^-T
      float sv[2][4];
      hb_zero(sv);
      hb_mma<2>(sv, 32, hv + HV_IB + tm * HB_LS, HB_LS, 1, Linv + tn * HB_LS, 1, HB_LS);
      hb_put_tiles(hv + HV_S + tm * HB_LS + tn, HB_LS, sv);
    }
    __syncthreads();
    const long long o = (long long)cur.r * a.m + cur.p0;
    if (tm < cur.np) {  // info' = OUTER - S Kt, entries (2h, 2h + 1) of a tile adjacent in a row
      float acc[4][4];
      hb_zero(acc);
      hb_mma<4>(acc, 32, hv + HV_S + tm * HB_LS, HB_LS, 1, Kt + tn2, HV_KS, 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = tm + hb_row(2 * h), c = tn2 + hb_col(j, 2 * h), kk = c & 31;
          if (p < cur.np && kk < n) {
            const float* ou = hv + HV_OUT + p * HV_OS + c;
            const float v0 = ou[0] - acc[j][2 * h], v1 = ou[1] - acc[j][2 * h + 1];
            float* dst = a.info_out + (o + p) * n2 + (c >> 5) * n + kk;
            if ((n & 1) == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (kk + 1 < n) dst[1] = v1;
            }
          }
        }
    }
    if (tid < cur.np) {  // |s|^2 in index order; the pair's scalars
      const float* srow = hv + HV_S + tid * HB_LS;
      float ss = 0.f;
#pragma unroll
      for (int x = 0; x < 32; x += 4) {
        const float4 v = *reinterpret_cast<const float4*>(srow + x);
        ss = fmaf(v.x, v.x, ss);
        ss = fmaf(v.y, v.y, ss);
        ss = fmaf(v.z, v.z, ss);
        ss = fmaf(v.w, v.w, ss);
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this tile's scalars (the next tile's may be in flight)
      const float* sc = hv + HV_SC + (k & 1) * 6 * HV_TP + tid;
      if constexpr (GAMMA) {
        // the completion |s|^2 / 2 goes to beta, scaled by the mixing variable
        a.logZ_out[o + tid] = sc[0] + sc[HV_TP] + c0 - half_logdet;
        a.alpha_out[o + tid] = sc[2 * HV_TP] + sc[3 * HV_TP] - 0.5f * (float)n;
        a.beta_out[o + tid] = sc[4 * HV_TP] + sc[5 * HV_TP] - 0.5f * ss;
      } else {
        a.logZ_out[o + tid] = sc[0] + sc[HV_TP] + c0 - half_logdet + 0.5f * ss;
      }
    }
    __syncthreads();
    if (more) {  // the next tile set out
      hv_stage(a, t, pre, hv);
      __syncthreads();
    }
  }
}

// The dynamic shared memory K4a's and K5a's CTA takes (above the default
// 48 KB), set once an instantiation.
template <bool GAMMA>
static int halving_ready() {
  static bool ready = false;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(gl_halving_kernel<GAMMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              HV_FLOATS * (int)sizeof(float));
    if (err) return err;
    ready = true;
  }
  return 0;
}

template <bool GAMMA>
static int launch_halving(const HalvingArgs& a, int blocks, cudaStream_t st) {
  const int err = halving_ready<GAMMA>();
  if (err) return err;
  gl_halving_kernel<GAMMA><<<blocks, HV_NT, HV_FLOATS * sizeof(float), st>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------- K4c --
//
// The design for Hopper (gl_mids_kernel<NP>, NP the state dim padded to 16
// or 32).  One launch a level; a CTA of 128 threads (4 warps) walks tiles
// of consecutive pairs of one row, tile += gridDim.x, over a grid of
// min(tiles, CTAs the card runs at once) (ops/gaussian_levels.py::mids_plan,
// from gl_mids_shape).  A tile holds MD_TP = 4 pairs where L and P_mk are
// per pair (the heterogeneous sampler), MD_TPS = 32 where they are shared
// (the homogeneous one, stride 0: only i_m varies).  Most levels are one
// CTA's chain, so small tiles spread a level over more SMs: in turns
// (examples/tape_timing.py), 8 pairs on 256 threads ran the heterogeneous
// sampler's levels in 0.158 device ms, 4 on 128 in 0.140, 2 on 64 in
// 0.135, and the homogeneous one's (4 draws, n = 32) in 0.329, 0.310 and
// 0.322.  Per tile:
//   per pair, once for all draws: warp j brings pair j's L (transposed)
//     and P_mk (each half padded to NP) from the tape into its slot of
//     shared memory by cp.async, 4 bytes an entry, reading along the tape's
//     rows (a pair's L and P_mk are contiguous, n^2 and 2n^2 floats), and
//     forms 1 / L_jj and L^-1 by hb_tri_inverse (lane c column c, no block
//     barrier); in the shared case warp 0 does this once a CTA;
//   per pair, MD_K<NP> of its draws a thread (2 at NP = 16, H = D / 2
//     apart; 1 at 32), the draws fastest (so a warp's lanes are draws of one
//     pair at D >= 64 and every operand read from shared memory is a float4
//     broadcast that feeds each of the thread's draws): x = [cur[p] |
//     cur[p + 1]] (2n contiguous floats; the left point written out as it
//     is), info_c = i_m - P_mk x (NP x 2NP), y = L^-1 info_c + eps, mid =
//     L^-T y, each entry a dot product in index order from registers (the
//     triangles' zeros skipped four at a time), the mid written to out[2p +
//     1].  The points, the noise, i_m and the outputs go 16 bytes a thread
//     where n % 4 == 0 and the pointers are aligned (else 4);
//   the carried tail out[2 Np + q] = cur[Np + q], every CTA a share.
// The products are f32 on the CUDA cores (4n^2 + n FMAs an item less the
// triangles' halves: 0.26 GFLOP at the sampler's first level, some 4 us at
// the f32 rate), each thread's sums in a fixed order: two launches give the
// same bits.  What bounds it on an H100 (700 W): at the sampler's finest
// levels the draws' bytes (cur, eps and out: some 33 MB at 64 draws and
// 2000 pairs, 10 us at 3.35 TB/s) and the operands' reads from shared
// memory; at the small ones the chain of one tile, some 9,000 cycles at one
// pair (examples/tape_timing.py --marks: the tape's loads 1,800, L^-1 700,
// one thread's two draws 6,300).  Two draws a thread halve the reads: each
// float4 broadcast fills 512 bytes of registers, 4 cycles of an SM's
// shared-memory path, and feeds 8 FMAs, not 4 (in a variant with marks, one
// draw a thread, the items of a tile of 8 pairs took 18,000 cycles, two
// 13,000).  The earlier design ran a warp a (draw, pair) item, lane i row
// i, with three dependent chains of n shuffles and divides and each pair's
// L and P_mk read again by every draw, strided across the lanes.

#define MD_NT 128   // threads of K4c's CTA: 4 warps
#define MD_TP 4     // pairs a tile where L and P_mk are per pair: a warp forms each one's L^-1
#define MD_TPS 32   // pairs a tile where they are shared
template <int NP>
constexpr int MD_K = NP == 16 ? 2 : 1;  // draws a thread (at NP = 32 two would take over 255 registers)

// One pair's operands in shared memory, in floats: L^T, L^-1 (rows and
// columns) in rows of LS, 1 / L_jj (32), P_mk (NP rows of [l | r], each half
// padded to NP).
template <int NP>
struct MidsSlot {
  static constexpr int LS = NP + 4;  // float4-aligned rows; lanes' rows of LinvT at distinct banks
  static constexpr int LT = 0, LINV = NP * LS, LINVT = 2 * NP * LS, INVD = 3 * NP * LS;
  static constexpr int PM = INVD + 32, FLOATS = PM + 2 * NP * NP;
};

// cur (D, R, m_cur, n) points; per pair pr = r Np + p: L (n, n) at L + pr
// L_stride and P_mk (n, 2n) at Pmk + pr Pmk_stride (strides 0 where shared),
// i_m (R, Np, n); eps (D, R, Np, n).  out (D, R, Np + m_cur, n).  vec: n % 4
// == 0 and cur, im, eps and out 16-byte aligned.
struct MidsArgs {
  const float *cur, *L, *Pmk, *im, *eps;
  long long L_stride, Pmk_stride;
  int m_cur, D, R, Np, n, vec;
  float* out;
};

// x[i] = src[i] for i < n, 0 past it.
template <int NP>
__device__ __forceinline__ void md_load(const float* __restrict__ src, int n, bool vec, float* x) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < NP; i += 4) {
      const float4 v = i < n ? __ldg(reinterpret_cast<const float4*>(src + i)) : make_float4(0.f, 0.f, 0.f, 0.f);
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i) x[i] = i < n ? __ldg(src + i) : 0.f;
  }
}

// dst[i] = x[i] for i < n.
template <int NP>
__device__ __forceinline__ void md_store(float* dst, int n, bool vec, const float* x) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < NP; i += 4)
      if (i < n) *reinterpret_cast<float4*>(dst + i) = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < NP; ++i)
      if (i < n) dst[i] = x[i];
  }
}

// One warp: pair pr's L (lower triangle, transposed) and P_mk into the slot
// at `s`, zero-padded, read along the tape's rows by cp.async (4 bytes an
// entry, all in flight at once); then 1 / L_jj and L^-1.
template <int NP>
__device__ __forceinline__ void md_stage(const MidsArgs& a, long long pr, float* s, int lane) {
  using S = MidsSlot<NP>;
  const int n = a.n;
  const float* L = a.L + pr * a.L_stride;
  const float* P = a.Pmk + pr * a.Pmk_stride;
  for (int e = lane; e < NP * NP; e += 32) {  // e = i NP + k: L[i][k] into Lt[k][i]
    const int i = e / NP, k = e % NP;
    float* d = s + S::LT + k * S::LS + i;
    if (i < n && k <= i) hb_copy4(d, L + i * n + k);
    else *d = 0.f;
  }
  for (int e = lane; e < 2 * NP * NP; e += 32) {  // e = i 2NP + h NP + k: P_mk[i][h n + k]
    const int i = e / (2 * NP), h = (e / NP) & 1, k = e % NP;
    if (i < n && k < n) hb_copy4(s + S::PM + e, P + i * 2 * n + h * n + k);
    else s[S::PM + e] = 0.f;
  }
  hb_copy_wait();
  __syncwarp();
  hb_tri_inverse<NP, S::LS>(s + S::LT, s + S::INVD, n, lane, s + S::LINV, s + S::LINVT);
}

// Pair p of row r and K of its draws, dd + u H (u < K; those past D are not
// written), from the pair's slot `s`: each operand read from shared memory
// feeds the K draws' sums.
template <int NP, int K>
__device__ __forceinline__ void md_items(const MidsArgs& a, const float* s, int r, int p, int dd, int H) {
  using S = MidsSlot<NP>;
  const int n = a.n, m_out = a.Np + a.m_cur;
  const bool vec = a.vec;
  const long long pr = (long long)r * a.Np + p;
  long long dr[K];
  bool in[K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    in[u] = dd + u * H < a.D;
    dr[u] = (long long)(in[u] ? dd + u * H : dd) * a.R + r;
  }
  float x[K][2 * NP], v[K][NP], e[K][NP], im[NP];
  md_load<NP>(a.im + pr * n, n, vec, im);
#pragma unroll
  for (int u = 0; u < K; ++u) {
    md_load<NP>(a.cur + (dr[u] * a.m_cur + p) * n, n, vec, x[u]);  // the left point
    md_load<NP>(a.cur + (dr[u] * a.m_cur + p + 1) * n, n, vec, x[u] + NP);  // the right
    md_load<NP>(a.eps + (dr[u] * a.Np + p) * n, n, vec, e[u]);
    if (in[u]) md_store<NP>(a.out + (dr[u] * m_out + 2 * p) * n, n, vec, x[u]);  // the left point goes out as it is
  }
  // info_c = i_m - P_mk x
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float* row = s + S::PM + i * 2 * NP;
    float acc[K];
#pragma unroll
    for (int u = 0; u < K; ++u) acc[u] = im[i];
#pragma unroll
    for (int c = 0; c < 2 * NP; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + c);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        acc[u] = fmaf(-q.x, x[u][c], acc[u]);
        acc[u] = fmaf(-q.y, x[u][c + 1], acc[u]);
        acc[u] = fmaf(-q.z, x[u][c + 2], acc[u]);
        acc[u] = fmaf(-q.w, x[u][c + 3], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < K; ++u) v[u][i] = acc[u];
  }
  // y = L^-1 info_c + eps (row i of L^-1 is zero past i), into e
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float* row = s + S::LINV + i * S::LS;
    float acc[K];
#pragma unroll
    for (int u = 0; u < K; ++u) acc[u] = 0.f;
#pragma unroll
    for (int k = 0; k <= i; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + k);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        acc[u] = fmaf(q.x, v[u][k], acc[u]);
        acc[u] = fmaf(q.y, v[u][k + 1], acc[u]);
        acc[u] = fmaf(q.z, v[u][k + 2], acc[u]);
        acc[u] = fmaf(q.w, v[u][k + 3], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < K; ++u) e[u][i] = acc[u] + e[u][i];
  }
  // mid = L^-T y (row i of L^-T is zero before i), into v
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const float* row = s + S::LINVT + i * S::LS;
    float acc[K];
#pragma unroll
    for (int u = 0; u < K; ++u) acc[u] = 0.f;
#pragma unroll
    for (int k = i & ~3; k < NP; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(row + k);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        acc[u] = fmaf(q.x, e[u][k], acc[u]);
        acc[u] = fmaf(q.y, e[u][k + 1], acc[u]);
        acc[u] = fmaf(q.z, e[u][k + 2], acc[u]);
        acc[u] = fmaf(q.w, e[u][k + 3], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < K; ++u) v[u][i] = acc[u];
  }
#pragma unroll
  for (int u = 0; u < K; ++u)
    if (in[u]) md_store<NP>(a.out + (dr[u] * m_out + 2 * p + 1) * n, n, vec, v[u]);
}

// One level's midpoint draws (see MidsArgs).  Any grid; dynamic shared
// memory of one slot (shared) or MD_TP slots (per pair).
template <int NP>
__global__ void __launch_bounds__(MD_NT) gl_mids_kernel(const MidsArgs a) {
  extern __shared__ __align__(16) float md[];
  using S = MidsSlot<NP>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool shared = a.L_stride == 0;
  const int tp = shared ? MD_TPS : MD_TP, tiles_a_row = (a.Np + tp - 1) / tp, tiles = a.R * tiles_a_row;
  const int H = (a.D + MD_K<NP> - 1) / MD_K<NP>;  // a thread's draws are H apart
  if (shared) {  // the one L^-1, before any tile
    if (warp == 0) md_stage<NP>(a, 0, md, lane);
    __syncthreads();
  }
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r = tile / tiles_a_row, p0 = (tile - r * tiles_a_row) * tp, np = min(tp, a.Np - p0);
    if (!shared) {
      if (warp < np) md_stage<NP>(a, (long long)r * a.Np + p0 + warp, md + warp * S::FLOATS, lane);
      __syncthreads();
    }
    for (int it = tid; it < np * H; it += MD_NT) {
      const int j = it / H;
      md_items<NP, MD_K<NP>>(a, md + (shared ? 0 : j * S::FLOATS), r, p0 + j, it - j * H, H);
    }
    if (!shared) __syncthreads();  // the slots free for the next tile
  }
  // the carried tail: out[2 Np + q] = cur[Np + q], q < m_cur - Np
  const int run = (a.m_cur - a.Np) * a.n, m_out = a.Np + a.m_cur;
  const long long total = (long long)a.D * a.R * run;
  for (long long x = (long long)blockIdx.x * MD_NT + tid; x < total; x += (long long)gridDim.x * MD_NT) {
    const long long dr = x / run, k = x - dr * run;
    a.out[(dr * m_out + 2 * a.Np) * a.n + k] = a.cur[(dr * a.m_cur + a.Np) * a.n + k];
  }
}

template <int NP>
static size_t mids_smem_bytes(bool shared) {
  return (shared ? 1 : MD_TP) * MidsSlot<NP>::FLOATS * sizeof(float);
}

// The dynamic shared memory K4c's CTA may take (per pair at NP = 32, above
// the default 48 KB), set once an instantiation.
template <int NP>
static int mids_ready() {
  static bool ready = false;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(gl_mids_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)mids_smem_bytes<NP>(false));
    if (err) return err;
    ready = true;
  }
  return 0;
}

template <int NP>
static int launch_mids(const MidsArgs& a, int blocks, cudaStream_t st) {
  const int err = mids_ready<NP>();
  if (err) return err;
  gl_mids_kernel<NP><<<blocks, MD_NT, mids_smem_bytes<NP>(a.L_stride == 0), st>>>(a);
  return (int)cudaGetLastError();
}

template <int NP>
static int mids_shape(int shared, int* tile, int* ctas) {
  const int err = mids_ready<NP>();
  if (err) return err;
  *tile = shared ? MD_TPS : MD_TP;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, gl_mids_kernel<NP>, MD_NT,
                                                            mids_smem_bytes<NP>(shared));
}

// --------------------------------------------------------- K4b backward --
//
// The design for Hopper (gl_contract_bwd_kernel<NP>, NP the state dim padded
// to 16 or 32).  One launch a level; a warp an item (a pair, or an odd
// level's last factor, whose gradient passes through), CB_WARPS<NP> warps a
// CTA (2 at NP = 16, 1 at 32, by shared memory: 15.8 and 58 KB a warp),
// items += the grid's warps, over a grid of min(CTAs to hold the items,
// CTAs the card runs at once) (ops/gaussian_levels.py::contract_bwd_plan,
// from gl_contract_bwd_shape).  The warps share nothing: no block barrier,
// and each output is written by the warp that owns the pair, so every sum
// runs in a fixed order (two launches give the same bits).  Per pair,
// every array zero-padded to NP (the halves of a 2n-vector to NP each), a
// __syncwarp between steps:
//   the tape's L (transposed), P_mk and i_m and the upstream gP', gi' in by
//     cp.async, 4 bytes an entry, read along their rows, all in flight at
//     once; 1 / L_jj and L^-1 by hb_tri_inverse (lane c column c);
//   X1 = L^-1 P_mk and x2 = L^-1 i_m; gX1 = -(x2 gi'^T + X1 G), G = gP' +
//     gP'^T read from both triangles; gx2 = gZ' x2 - X1 gi'; gB = L^-T [gX1
//     | gx2]; gL = -tril(gB X^T) - gZ' / L_jj on the diagonal; M = tril(L^T
//     gL), S its symmetric half; T1 = S L^-1, W = L^-T T1 (the Cholesky
//     adjoint, gP_mm = (W + W^T) / 2).  Every solve is a product with L^-1
//     or L^-T, and every product the same form: a lane owns a column (or a
//     row) of the result in registers and walks the summed index in order,
//     each step one entry of its own from shared memory and a float4
//     broadcast of a row, so only the result's index is unrolled (the
//     loops over the summed index stay rolled, 8 steps a turn: code run
//     once a pair; 4 a turn ran 2-6% slower, 2 13%, examples/tape_timing.py).
//     The same products on hb_mma (3xTF32, the operands read from the same
//     arrays) ran slower in a variant, 12.7 against 11.6 us a small level:
//     each is only a few 16 x 8 tiles deep, so the tensor cores' latency
//     and the fragments' loads buy nothing at one warp a pair;
//   gPx, gPy (2 x 4n^2 floats), ginfo and glogZ written a row at a time,
//     consecutive lanes on consecutive floats.
// About 17 n^3 FMAs a pair (70,000 at n = 16, 2200 a lane).  What bounds it
// on an H100 (700 W): over the 12 levels of an lgssm step (R = 1, T = 4000,
// n = 16) some 63 MB (19 us at 3.35 TB/s) and 0.29 GFLOP; but a level is
// at most one or two rounds of pairs over the warps the card holds (14 an
// SM at n = 16), so the chain of one warp's pair sets each level's time:
// some 19,400 cycles (examples/tape_timing.py --marks: the loads 5,100, L^-1
// 800, the nine products 9,200, the outputs 4,300).  In a variant with a
// branch a row on the entry's block the outputs took 23,000 cycles, 330 a
// row even with the stores left out.  The earlier design ran a CTA of 128
// threads a pair, with the solves row by row between block barriers (some
// 136 a pair at n = 16).

// A warp's shared memory at padded state dim NP, in floats: L^T, L^-1 rows
// and columns (rows of LS), 1 / L_jj; P_mk ([l | r] rows of 2NP; then gX1,
// gL, W); i_m; X1 transposed with x2 as its last row (then S); gP' (rows of
// GS: its columns read down without bank conflicts); gi'; gB transposed with
// gb2 = L^-T gx2 as its last row; gx2.
template <int NP>
struct CbSmem {
  static constexpr int LS = NP + 4, NC = 2 * NP, GS = NC + 1, WARPS = NP == 16 ? 2 : 1;
  static constexpr int LT = 0, LINV = NP * LS, LINVT = 2 * NP * LS, INVD = 3 * NP * LS;
  static constexpr int PM = INVD + 32, IM = PM + NP * NC, X1T = IM + NP, GP = X1T + (NC + 1) * LS;
  static constexpr int GI = GP + NC * GS, GBT = GI + NC, GX2 = GBT + (NC + 1) * LS, FLOATS = GX2 + NP;
};

// The tape of the forward: L (R, t / 2, n, n), Pmk (R, t / 2, n, 2n), im
// (R, t / 2, n); the upstream gradients gP_out (R, t_out, 2n, 2n), gi_out
// (R, t_out, 2n), gZ_out (R, t_out), each null for zero; outputs gP (R, t,
// 2n, 2n), ginfo (R, t, 2n), glogZ (R, t).  Items are the R t_out outputs.
struct ContractBwdArgs {
  const float *L, *Pmk, *im, *gP_out, *gi_out, *gZ_out;
  int R, t, n, t_out;
  float *gP, *ginfo, *glogZ;
};

// acc[i] += row[i] b for i < NP, row a float4-aligned row of shared memory.
template <int NP>
__device__ __forceinline__ void cb_axpy(float (&acc)[NP], const float* row, float b) {
#pragma unroll
  for (int i = 0; i < NP; i += 4) {
    const float4 q = *reinterpret_cast<const float4*>(row + i);
    acc[i] = fmaf(q.x, b, acc[i]);
    acc[i + 1] = fmaf(q.y, b, acc[i + 1]);
    acc[i + 2] = fmaf(q.z, b, acc[i + 2]);
    acc[i + 3] = fmaf(q.w, b, acc[i + 3]);
  }
}

template <int NP>
__device__ __forceinline__ void cb_put_row(float* row, const float (&acc)[NP]) {
#pragma unroll
  for (int i = 0; i < NP; i += 4) {
    const float v[4] = {acc[i], acc[i + 1], acc[i + 2], acc[i + 3]};
    hb_store4(row + i, v);
  }
}

// The odd level's last factor (output o, factor f): its gradient passes
// through, gP symmetrised.
__device__ __forceinline__ void cb_pass(const ContractBwdArgs& a, long long o, long long f, int lane) {
  const int n2 = 2 * a.n;
  const float* gPo = a.gP_out ? a.gP_out + o * n2 * n2 : nullptr;
  for (int x = lane; x < n2 * n2; x += 32) {
    const int i = x / n2, j = x - i * n2;
    a.gP[f * n2 * n2 + x] = gPo ? 0.5f * (gPo[x] + gPo[j * n2 + i]) : 0.f;
  }
  for (int i = lane; i < n2; i += 32) a.ginfo[f * n2 + i] = a.gi_out ? a.gi_out[o * n2 + i] : 0.f;
  if (lane == 0) a.glogZ[f] = a.gZ_out ? a.gZ_out[o] : 0.f;
}

// One pair (output o, tape entry pr, first factor fx) by one warp, in its
// shared memory `s`.
template <int NP>
__device__ __forceinline__ void cb_pair(const ContractBwdArgs& a, long long o, long long pr, long long fx, float* s,
                                        int lane) {
  using S = CbSmem<NP>;
  constexpr int LS = S::LS, NC = S::NC, GS = S::GS, CPL = NC / 32;  // columns of a 2NP-wide matrix a lane
  const int n = a.n, n2 = 2 * n;
  float* const Lt = s + S::LT;
  float* const Linv = s + S::LINV;
  float* const PM = s + S::PM;
  float* const X1T = s + S::X1T;
  float* const GP = s + S::GP;
  float* const GI = s + S::GI;
  float* const GBT = s + S::GBT;
  float* const GX2 = s + S::GX2;

  // 1. the tape and the upstream gradients in, zero-padded
  const float* L = a.L + pr * n * n;
  for (int e = lane; e < NP * NP; e += 32) {  // L[i][k] into Lt[k][i]
    const int i = e / NP, k = e % NP;
    float* d = Lt + k * LS + i;
    if (i < n && k <= i) hb_copy4(d, L + i * n + k);
    else *d = 0.f;
  }
  const float* P = a.Pmk + pr * n * n2;
  for (int e = lane; e < NP * NC; e += 32) {  // P_mk[i][h n + k] into PM[i][h NP + k]
    const int i = e / NC, h = (e / NP) & 1, k = e % NP;
    if (i < n && k < n) hb_copy4(PM + e, P + i * n2 + h * n + k);
    else PM[e] = 0.f;
  }
  if (lane < NP) {
    if (lane < n) hb_copy4(s + S::IM + lane, a.im + pr * n + lane);
    else s[S::IM + lane] = 0.f;
  }
  const float* gPo = a.gP_out ? a.gP_out + o * n2 * n2 : nullptr;
  for (int e = lane; e < NC * NC; e += 32) {  // gP'[ha n + i][hb n + k] into GP[ha NP + i][hb NP + k]
    const int pa = e / NC, pb = e % NC, i = pa % NP, k = pb % NP;
    if (gPo && i < n && k < n) hb_copy4(GP + pa * GS + pb, gPo + ((pa / NP) * n + i) * n2 + (pb / NP) * n + k);
    else GP[pa * GS + pb] = 0.f;
  }
  for (int c = lane; c < NC; c += 32) {
    const int k = c % NP;
    if (a.gi_out && k < n) hb_copy4(GI + c, a.gi_out + o * n2 + (c / NP) * n + k);
    else GI[c] = 0.f;
  }
  const float gz = a.gZ_out ? __ldg(a.gZ_out + o) : 0.f;
  hb_copy_wait();
  __syncwarp();

  // 2. 1 / L_jj and L^-1
  hb_tri_inverse<NP, LS>(Lt, s + S::INVD, n, lane, Linv, s + S::LINVT);
  __syncwarp();
  const float* const LinvT = s + S::LINVT;  // row k: column k of L^-1
  const float* const invd = s + S::INVD;

  // 3. X1 = L^-1 P_mk, lane c column c, into X1T; x2 = L^-1 i_m, lane i row i
  float acc[CPL][NP];
#pragma unroll
  for (int h = 0; h < CPL; ++h) {
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[h][i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) cb_axpy<NP>(acc[h], LinvT + k * LS, PM[k * NC + lane + 32 * h]);
    cb_put_row<NP>(X1T + (lane + 32 * h) * LS, acc[h]);
  }
  if (lane < NP) {
    float x2 = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) x2 = fmaf(Linv[lane * LS + k], s[S::IM + k], x2);
    X1T[NC * LS + lane] = x2;
  }
  __syncwarp();

  // 4. gX1 = -(x2 gi'^T + X1 G), lane c column c, into PM (row-major);
  //    gx2 = gZ' x2 - X1 gi', lane i row i
#pragma unroll
  for (int h = 0; h < CPL; ++h) {
    const int c = lane + 32 * h;
    const float gic = GI[c];
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[h][i] = X1T[NC * LS + i] * gic;
#pragma unroll 8
    for (int j = 0; j < NC; ++j) cb_axpy<NP>(acc[h], X1T + j * LS, GP[j * GS + c] + GP[c * GS + j]);
#pragma unroll
    for (int i = 0; i < NP; ++i) PM[i * NC + c] = -acc[h][i];
  }
  if (lane < NP) {
    float g = gz * X1T[NC * LS + lane];
#pragma unroll 8
    for (int c = 0; c < NC; ++c) g = fmaf(-X1T[c * LS + lane], GI[c], g);
    GX2[lane] = g;
  }
  __syncwarp();

  // 5. gB = L^-T [gX1 | gx2]: lane c column c, into GBT; gb2 lane i row i
#pragma unroll
  for (int h = 0; h < CPL; ++h) {
    const int c = lane + 32 * h;
#pragma unroll
    for (int i = 0; i < NP; ++i) acc[h][i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) cb_axpy<NP>(acc[h], Linv + k * LS, PM[k * NC + c]);
    cb_put_row<NP>(GBT + c * LS, acc[h]);
  }
  if (lane < NP) {
    float g = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) g = fmaf(Linv[k * LS + lane], GX2[k], g);
    GBT[NC * LS + lane] = g;
  }
  __syncwarp();

  // 6. gL = -tril(gB X^T) - gZ' / L_jj on the diagonal, lane j column j,
  //    into PM (rows of LS)
  float* const gLs = PM;
  if (lane < NP) {
    float g[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) g[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c <= NC; ++c) cb_axpy<NP>(g, GBT + c * LS, X1T[c * LS + lane]);
    const float dz = gz * invd[lane];
#pragma unroll
    for (int i = 0; i < NP; ++i)
      gLs[i * LS + lane] = (i >= lane && i < n && lane < n) ? -g[i] - (i == lane ? dz : 0.f) : 0.f;
  }
  __syncwarp();

  // 7. M = L^T gL, lane i row i (its lower triangle used); S, the symmetric
  //    matrix of tril(M) halved, into X1T's place (rows of LS)
  float* const Ss = X1T;
  if (lane < NP) {
    float m[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) m[j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) cb_axpy<NP>(m, gLs + k * LS, Lt[lane * LS + k]);  // L[k][lane] gL[k][:]
#pragma unroll
    for (int j = 0; j < NP; ++j)
      if (j <= lane) Ss[lane * LS + j] = Ss[j * LS + lane] = 0.5f * m[j];
  }
  __syncwarp();

  // 8. T1 = S L^-1, lane j column j, into Lt's place
  float* const T1 = Lt;
  if (lane < NP) {
    float t1[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) t1[i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) cb_axpy<NP>(t1, Ss + k * LS, Linv[k * LS + lane]);  // S[:][k] = S[k][:]
#pragma unroll
    for (int i = 0; i < NP; ++i) T1[i * LS + lane] = t1[i];
  }
  __syncwarp();

  // 9. W = L^-T T1, lane j column j, into PM (rows of NP + 1)
  float* const W = PM;
  if (lane < NP) {
    float w[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) w[i] = 0.f;
#pragma unroll 8
    for (int k = 0; k < NP; ++k) cb_axpy<NP>(w, Linv + k * LS, T1[k * LS + lane]);
#pragma unroll
    for (int i = 0; i < NP; ++i) W[i * (NP + 1) + lane] = w[i];
  }
  __syncwarp();

  // 10. the pair's two factors: gPx = [[G_ll / 2, gl^T], [gl, gP_mm]], gPy =
  //     [[gP_mm, gr], [gr^T, G_rr / 2]] (gl, gr = gB's halves / 2), a
  //     quarter at a time, lane b column b: each entry w (p1[i s1] + p2[i
  //     s2]) at row i of the quarter, the lane's sources chosen once a
  //     quarter (no branch in the rows' loop); ginfo = [gi'_l, gb2], [gb2,
  //     gi'_r]; glogZ = gZ' for both
  float* const out = a.gP + fx * n2 * n2;
  for (int q = 0; q < 4; ++q) {  // factor f, row half ha
    const int f = q >> 1, ha = q & 1;
    for (int b = lane; b < n2; b += 32) {
      const int hb = b >= n, ib = b - hb * n;
      const float *p1, *p2;
      int s1, s2;
      float w = 0.5f;
      if (ha == hb && ha == f) {  // half of G: G[i][ib] + G[ib][i] in the quarter's block
        p1 = GP + ha * NP * GS + hb * NP + ib, s1 = GS;
        p2 = GP + (hb * NP + ib) * GS + ha * NP, s2 = 1;
      } else if (ha == hb) {  // gP_mm: (W + W^T) / 2
        p1 = W + ib, s1 = NP + 1;
        p2 = W + ib * (NP + 1), s2 = 1;
      } else {  // a half of gB / 2, read twice and halved again (exact)
        w = 0.25f;
        if (f == 0) {
          p1 = ha == 0 ? GBT + ib : GBT + ib * LS, s1 = ha == 0 ? LS : 1;  // gl^T, gl
        } else {
          p1 = ha == 0 ? GBT + (NP + ib) * LS : GBT + NP * LS + ib, s1 = ha == 0 ? 1 : LS;  // gr, gr^T
        }
        p2 = p1, s2 = s1;
      }
      float* o = out + (f * n2 + ha * n) * n2 + b;
#pragma unroll 8
      for (int i = 0; i < n; ++i) o[i * n2] = w * (p1[i * s1] + p2[i * s2]);
    }
  }
  for (int e = lane; e < 2 * n2; e += 32) {
    const int f = e >= n2, c = e - f * n2, h = c >= n, k = c - h * n;
    a.ginfo[fx * n2 + e] = h == f ? GI[h * NP + k] : GBT[NC * LS + k];
  }
  if (lane < 2) a.glogZ[fx + lane] = gz;
  __syncwarp();  // the shared memory free for the warp's next item
}

template <int NP>
__global__ void __launch_bounds__(32 * CbSmem<NP>::WARPS) gl_contract_bwd_kernel(const ContractBwdArgs a) {
  extern __shared__ __align__(16) float cb[];
  using S = CbSmem<NP>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long np = a.t / 2, items = (long long)a.R * a.t_out;
  for (long long o = (long long)blockIdx.x * S::WARPS + warp; o < items; o += (long long)gridDim.x * S::WARPS) {
    const long long r = o / a.t_out, p = o - r * a.t_out;
    if (p == np) cb_pass(a, o, r * a.t + a.t - 1, lane);
    else cb_pair<NP>(a, o, r * np + p, r * a.t + 2 * p, cb + warp * S::FLOATS, lane);
  }
}

template <int NP>
static constexpr size_t contract_bwd_smem_bytes() {
  return CbSmem<NP>::WARPS * CbSmem<NP>::FLOATS * sizeof(float);
}

// The dynamic shared memory K4b backward's CTA takes (above the default 48
// KB at NP = 32), set once an instantiation.
template <int NP>
static int contract_bwd_ready() {
  static bool ready = false;
  if (!ready) {
    const int err = (int)cudaFuncSetAttribute(gl_contract_bwd_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              (int)contract_bwd_smem_bytes<NP>());
    if (err) return err;
    ready = true;
  }
  return 0;
}

template <int NP>
static int launch_contract_bwd(const ContractBwdArgs& a, int blocks, cudaStream_t st) {
  const int err = contract_bwd_ready<NP>();
  if (err) return err;
  gl_contract_bwd_kernel<NP><<<blocks, 32 * CbSmem<NP>::WARPS, contract_bwd_smem_bytes<NP>(), st>>>(a);
  return (int)cudaGetLastError();
}

template <int NP>
static int contract_bwd_shape(int* pairs, int* ctas) {
  const int err = contract_bwd_ready<NP>();
  if (err) return err;
  *pairs = CbSmem<NP>::WARPS;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, gl_contract_bwd_kernel<NP>, 32 * CbSmem<NP>::WARPS,
                                                            contract_bwd_smem_bytes<NP>());
}

extern "C" {

int gl_halving(const float* P, const float* info, long long info_rs, const float* logZ, long long logZ_rs, int R,
               int m, int n, int blocks, float* P_out, float* L_out, float* info_out, float* logZ_out,
               float* ib_out, cudaStream_t st) {
  const HalvingArgs a = {P, info, logZ, nullptr, nullptr, info_rs, logZ_rs, 0, 0, R, m, n,
                         P_out, L_out, info_out, logZ_out, ib_out, nullptr, nullptr};
  return launch_halving<false>(a, blocks, st);
}

int gl_gamma_halving(const float* P, const float* info, long long info_rs, const float* logZ, long long logZ_rs,
                     const float* alpha, long long alpha_rs, const float* beta, long long beta_rs, int R, int m,
                     int n, int blocks, float* P_out, float* L_out, float* info_out, float* logZ_out,
                     float* alpha_out, float* beta_out, cudaStream_t st) {
  const HalvingArgs a = {P, info, logZ, alpha, beta, info_rs, logZ_rs, alpha_rs, beta_rs, R, m, n,
                         P_out, L_out, info_out, logZ_out, nullptr, alpha_out, beta_out};
  return launch_halving<true>(a, blocks, st);
}

// K4a's (gamma 0) or K5a's (gamma 1) pairs a tile, and the CTAs one SM runs
// at once by their shared memory, registers and threads: the wrapper's plan.
int gl_halving_shape(int gamma, int* tile, int* ctas) {
  const int err = gamma ? halving_ready<true>() : halving_ready<false>();
  if (err) return err;
  *tile = HV_TP;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, gamma ? gl_halving_kernel<true> : gl_halving_kernel<false>, HV_NT, HV_FLOATS * sizeof(float));
}

int gl_contract(const float* P, const float* info, const float* logZ, const long long* layout, int R, int t, int n,
                int t_out, int blocks, float* P_out, float* info_out, float* logZ_out, float* L_tape, float* Pmk_tape,
                float* im_tape, cudaStream_t st) {
  ContractArgs a = contract_args(P, info, logZ, nullptr, nullptr, layout, R, t, n, t_out);
  a.P_out = P_out;
  a.info_out = info_out;
  a.logZ_out = logZ_out;
  a.L_tape = L_tape;
  a.Pmk_tape = Pmk_tape;
  a.im_tape = im_tape;
  return launch_contract<false>(a, blocks, st);
}

int gl_gamma_contract(const float* P, const float* info, const float* logZ, const float* alpha, const float* beta,
                      const long long* layout, int R, int t, int n, int t_out, int blocks, float* P_out,
                      float* info_out, float* logZ_out, float* alpha_out, float* beta_out, cudaStream_t st) {
  ContractArgs a = contract_args(P, info, logZ, alpha, beta, layout, R, t, n, t_out);
  a.P_out = P_out;
  a.info_out = info_out;
  a.logZ_out = logZ_out;
  a.alpha_out = alpha_out;
  a.beta_out = beta_out;
  return launch_contract<true>(a, blocks, st);
}

// The CTAs of K4b (gamma 0) or K5b (gamma 1) at state dim n that one SM
// runs at once, by their shared memory, registers and threads.
int gl_contract_ctas_per_sm(int n, int gamma, int* ctas) {
  const int err = gamma ? contract_ready<true>() : contract_ready<false>();
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, gamma ? gl_contract_kernel<true> : gl_contract_kernel<false>, contract_threads(n), contract_smem_bytes(n));
}

int gl_mids(const float* cur, int m_cur, const float* L, long long L_stride, const float* Pmk, long long Pmk_stride,
            const float* im, const float* eps, int D, int R, int Np, int n, int blocks, float* out, cudaStream_t st) {
  const auto aligned = [](const void* p) { return (reinterpret_cast<size_t>(p) & 15) == 0; };
  const int vec = n % 4 == 0 && aligned(cur) && aligned(im) && aligned(eps) && aligned(out);
  const MidsArgs a = {cur, L, Pmk, im, eps, L_stride, Pmk_stride, m_cur, D, R, Np, n, vec, out};
  return n <= 16 ? launch_mids<16>(a, blocks, st) : launch_mids<32>(a, blocks, st);
}

// K4c's pairs a tile (L and P_mk shared or per pair) and the CTAs one SM
// runs at once at state dim n, for the wrapper's plan.
int gl_mids_shape(int n, int shared, int* tile, int* ctas) {
  return n <= 16 ? mids_shape<16>(shared, tile, ctas) : mids_shape<32>(shared, tile, ctas);
}

int gl_halving_bwd(const float* P, const float* L, const float* ib, const float* gP_out, const float* gi_out,
                   const float* gZ_out, int R, int m, int n, int blocks, int group, int groups, float* parts,
                   float* sums, int* counters, float* gP, float* ginfo, float* glogZ, cudaStream_t st) {
  int err = halving_bwd_ready();
  if (err) return err;
  if (blocks > 1) {  // the tickets' counters
    err = (int)cudaMemsetAsync(counters, 0, sizeof(int) * (groups + 1), st);
    if (err) return err;
  }
  const HalvingBwdArgs a = {P, L, ib, gP_out, gi_out, gZ_out, (long long)R * m, n, group, groups,
                            parts, sums, counters, gP, ginfo, glogZ};
  gl_halving_bwd_kernel<<<blocks, HB_NT, HB_FLOATS * sizeof(float), st>>>(a);
  return (int)cudaGetLastError();
}

// K4a backward's pairs a tile, floats a partial and CTAs an SM, for the
// wrapper's plan.
int gl_halving_bwd_shape(int* tile, int* partial, int* ctas) {
  *tile = HB_TP;
  *partial = HB_PARTIAL;
  *ctas = HB_CTAS;
  return 0;
}

int gl_contract_bwd(const float* L_tape, const float* Pmk_tape, const float* im_tape, const float* gP_out,
                    const float* gi_out, const float* gZ_out, int R, int t, int n, int t_out, int blocks, float* gP,
                    float* ginfo, float* glogZ, cudaStream_t st) {
  const ContractBwdArgs a = {L_tape, Pmk_tape, im_tape, gP_out, gi_out, gZ_out, R, t, n, t_out, gP, ginfo, glogZ};
  return n <= 16 ? launch_contract_bwd<16>(a, blocks, st) : launch_contract_bwd<32>(a, blocks, st);
}

// K4b backward's pairs a CTA (a warp each) and the CTAs one SM runs at once
// at state dim n, for the wrapper's plan.
int gl_contract_bwd_shape(int n, int* pairs, int* ctas) {
  return n <= 16 ? contract_bwd_shape<16>(pairs, ctas) : contract_bwd_shape<32>(pairs, ctas);
}

}  // extern "C"
