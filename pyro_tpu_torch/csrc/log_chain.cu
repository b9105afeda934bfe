// K3f: a chain of small log-space transition matrices contracted in one
// launch each way, on Hopper (sm_90a).
//
//   out[b] = F[0, b] (x) F[1, b] (x) ... (x) F[T-1, b],
//   (x ⊗ y)[i, j] = log sum_k exp(x[i, k] + y[k, j])
//
// Replaces pyro_tpu/ops/log_matmul.py::sequential_logmatmulexp_timemajor
// (K3, :134) and pyro_tpu/distributions/hmm.py::_sequential_logmatmulexp
// (:47) at S <= 64 states: the same halving association, factor 2p with
// factor 2p+1 in each round, an odd round's last factor passed through to
// the next.  The JAX package (and the port at S > 64) runs each round as
// one batched log-matmul-exp (K1); at S = 16 a wgmma m64n128 tile of K1
// holds about 3% data, and ceil(log2 T) rounds cost 2 kernels a round
// forward and 3 backward.  Here one CTA owns one batch row (a chain of one
// region, say) and walks all of its rounds, with a block barrier between
// rounds.
//
// Each entry is the exact log-sum-exp, in two passes over k (the max, then
// the shifted sum), so an entry with no finite path is exactly -inf and
// every other entry is finite; nothing is clipped.  (K1's factored form
// clips z at FLT_MIN and gives log(FLT_MIN) + shifts there.)  The
// backward is the VJP of the same rounds in reverse:
//   dx[i, k] = sum_j g[i, j] exp(x[i, k] + y[k, j] - out[i, j]),
//   dy[k, j] = sum_i g[i, j] exp(x[i, k] + y[k, j] - out[i, j]),
// where out[i, j] = -inf both out and g are read as 0 (every term there is
// exp(-inf) = 0), so a -inf entry passes exactly 0 and its adjoint, which a
// downstream logsumexp over an all -inf row may make NaN, is never read.
// Sums run in a fixed order and there are no atomics: two launches give
// bit-equal results.
//
// Bound on an H100 SXM (phase 22 of chip_smoke.py, SEIR at S = 64, T = 60,
// 4 chains): the exps.  A pair takes S^3 exps forward and 2 S^3 backward,
// 16 a clock on an SM's MUFU units, so a row's 59 pairs are about 2.7M
// clocks on its one SM; the whole card would do them in 1/132 of that.
// The first design leaves the other SMs idle (4 rows: 4 of 132 SMs busy):
// spreading a row's pairs over a cluster, or the factored product on the
// tensor cores with the exact form only where it underflows, is later
// work.
//
// Layout.  The input is read by its strides: (T, up to three batch dims,
// S, S), time leading, each stride in elements (a time-major view of a
// broadcast factor is strided).  The forward writes every round's outputs
// to a tape (B, L, S, S) contiguous, L = the factors of all rounds, which
// the backward reads; the odd factor passed through is written there too.
// A CTA stages a chunk of a round's pairs in shared memory, rows padded to
// S + 1 floats (the backward's dx pass reads y down its columns); a thread
// takes four rows of one column of a pair, so one load of the other operand
// serves four terms.  Plain C interface for ctypes; each entry launches on
// the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LC_THREADS 512
#define LC_SMAX 64
#define LC_SMEM (96 * 1024)  // dynamic shared memory a CTA may take
#define LC_LEVELS 40         // rounds + 1, enough for any int T

struct Chain {
  const float* p;                  // the input factors
  long long st, sb0, sb1, sb2;     // time and batch strides
  long long si, sj;                // row and column strides
  int n0, n1, n2;                  // batch sizes (B = n0 n1 n2)
  int T, S;
};

// A factor's element (i, j), by its strides.
struct View {
  const float* p;
  long long si, sj;
  __device__ float at(int i, int j) const { return p[i * si + j * sj]; }
};

__device__ __forceinline__ const float* row_base(const Chain& c, int b) {
  const int b2 = b % c.n2, b1 = (b / c.n2) % c.n1, b0 = b / (c.n2 * c.n1);
  return c.p + b0 * c.sb0 + b1 * c.sb1 + b2 * c.sb2;
}

// The factor counts of the levels (level 0 the input, level R the one
// factor left) and each level's offset in a row of the tape (level >= 1).
__host__ __device__ inline int chain_levels(int T, int* n, long long* off) {
  int R = 0;
  n[0] = T;
  off[1] = 0;
  while (n[R] > 1) {
    n[R + 1] = (n[R] + 1) / 2;
    if (R + 2 < LC_LEVELS) off[R + 2] = off[R + 1] + n[R + 1];
    ++R;
  }
  return R;
}

__device__ __forceinline__ void stage(float* dst, View v, int S, int SP) {
  for (int e = threadIdx.x; e < S * S; e += blockDim.x) dst[(e / S) * SP + e % S] = v.at(e / S, e % S);
}

__global__ void __launch_bounds__(LC_THREADS) lc_forward_kernel(Chain c, float* tape, float* out, int pc_max) {
  extern __shared__ float smem[];
  const int S = c.S, SS = S * S, SP = S + 1, M = S * SP, b = blockIdx.x;
  int n[LC_LEVELS];
  long long off[LC_LEVELS];
  const int R = chain_levels(c.T, n, off);
  const long long L = off[R] + n[R];
  float* tape_row = tape + b * L * SS;

  // level r's factor f: src + f * s_t, its (i, j) at i * s_i + j * s_j
  const float* src = row_base(c, b);
  long long s_t = c.st, s_i = c.si, s_j = c.sj;
  for (int r = 0; r < R; ++r) {
    const int np = n[r] / 2;
    float* dst = tape_row + off[r + 1] * SS;
    if (n[r] & 1) {
      const View v = {src + (long long)(n[r] - 1) * s_t, s_i, s_j};
      for (int e = threadIdx.x; e < SS; e += blockDim.x) dst[(long long)np * SS + e] = v.at(e / S, e % S);
    }
    for (int p0 = 0; p0 < np; p0 += pc_max) {
      const int pc = min(pc_max, np - p0);
      float* xs = smem;
      float* ys = smem + pc * M;
      for (int p = 0; p < pc; ++p) {
        stage(xs + p * M, View{src + (long long)(2 * (p0 + p)) * s_t, s_i, s_j}, S, SP);
        stage(ys + p * M, View{src + (long long)(2 * (p0 + p) + 1) * s_t, s_i, s_j}, S, SP);
      }
      __syncthreads();
      // a thread's item: rows 4 rb .. 4 rb + 3 of column j of pair p, so a
      // y load serves four terms (rows past S repeat row S - 1, unwritten)
      const int RB = (S + 3) / 4, per_pair = RB * S;
      for (int e = threadIdx.x; e < pc * per_pair; e += blockDim.x) {
        const int p = e / per_pair, item = e % per_pair, i0 = 4 * (item / S), j = item % S;
        const float* X = xs + p * M;
        const float* yc = ys + p * M + j;
        const float* xr[4];
        float m[4], acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xr[q] = X + min(i0 + q, S - 1) * SP;
          m[q] = -INFINITY;
          acc[q] = 0.f;
        }
        for (int k = 0; k < S; ++k) {
          const float y = yc[k * SP];
#pragma unroll
          for (int q = 0; q < 4; ++q) m[q] = fmaxf(m[q], xr[q][k] + y);
        }
        float shift[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) shift[q] = m[q] == -INFINITY ? 0.f : m[q];
        for (int k = 0; k < S; ++k) {
          const float y = yc[k * SP];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += __expf(xr[q][k] + y - shift[q]);
        }
        float* o = dst + (long long)(p0 + p) * SS + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (i0 + q < S) o[(i0 + q) * S] = m[q] == -INFINITY ? -INFINITY : m[q] + logf(acc[q]);
      }
      __syncthreads();
    }
    src = dst;
    s_t = SS;
    s_i = S;
    s_j = 1;
  }
  for (int e = threadIdx.x; e < SS; e += blockDim.x) out[(long long)b * SS + e] = src[e];
}

// g: (B, S, S) contiguous, the adjoint of out.  adj: (B, L, S, S), the
// adjoints of levels 1 .. R-1.  dx: (T, B, S, S) contiguous.
__global__ void __launch_bounds__(LC_THREADS) lc_backward_kernel(Chain c, const float* tape, const float* g,
                                                                 float* adj, float* dx, int pc_max) {
  extern __shared__ float smem[];
  const int S = c.S, SS = S * S, SP = S + 1, M = S * SP, b = blockIdx.x;
  const long long B = (long long)c.n0 * c.n1 * c.n2;
  int n[LC_LEVELS];
  long long off[LC_LEVELS];
  const int R = chain_levels(c.T, n, off);
  const long long L = off[R] + n[R];
  const float* tape_row = tape + b * L * SS;
  float* adj_row = adj + b * L * SS;

  for (int r = R - 1; r >= 0; --r) {
    const int np = n[r] / 2;
    // level r's values (factor f at x_t), level r+1's values and adjoints,
    // and where level r's adjoints go (factor f at d_t)
    const float* xv;
    long long x_t, x_i, x_j;
    if (r == 0) {
      xv = row_base(c, b);
      x_t = c.st;
      x_i = c.si;
      x_j = c.sj;
    } else {
      xv = tape_row + off[r] * SS;
      x_t = SS;
      x_i = S;
      x_j = 1;
    }
    const float* ov = tape_row + off[r + 1] * SS;
    const float* gv = r + 1 == R ? g + (long long)b * SS : adj_row + off[r + 1] * SS;
    float* dv = r == 0 ? dx + (long long)b * SS : adj_row + off[r] * SS;
    const long long d_t = r == 0 ? B * SS : SS;
    if (n[r] & 1)
      for (int e = threadIdx.x; e < SS; e += blockDim.x) dv[(long long)(n[r] - 1) * d_t + e] = gv[(long long)np * SS + e];
    for (int p0 = 0; p0 < np; p0 += pc_max) {
      const int pc = min(pc_max, np - p0);
      float* xs = smem;
      float* ys = smem + pc * M;
      // out and its adjoint as (out, g) pairs, both 0 where out is -inf: every
      // term there is exp(-inf) = 0 times 0, and a NaN adjoint is never read
      float2* og = reinterpret_cast<float2*>(smem + 2 * pc * M);
      for (int p = 0; p < pc; ++p) {
        const int q = p0 + p;
        stage(xs + p * M, View{xv + (long long)(2 * q) * x_t, x_i, x_j}, S, SP);
        stage(ys + p * M, View{xv + (long long)(2 * q + 1) * x_t, x_i, x_j}, S, SP);
        for (int e = threadIdx.x; e < SS; e += blockDim.x) {
          const float o = ov[(long long)q * SS + e];
          const bool live = o != -INFINITY;
          og[p * M + (e / S) * SP + e % S] = make_float2(live ? o : 0.f, live ? gv[(long long)q * SS + e] : 0.f);
        }
      }
      __syncthreads();
      // items: dx of pair p at rows 4 rb .. 4 rb + 3, column k; then dy at
      // rows (k) 4 rb .. 4 rb + 3, column j
      const int RB = (S + 3) / 4, per_pair = RB * S;
      for (int e = threadIdx.x; e < 2 * pc * per_pair; e += blockDim.x) {
        const bool is_dx = e < pc * per_pair;
        const int f = is_dx ? e : e - pc * per_pair;
        const int p = f / per_pair, item = f % per_pair, a0 = 4 * (item / S), col = item % S;
        const float* X = xs + p * M;
        const float* Y = ys + p * M;
        const float2* OG = og + p * M;
        int a[4];
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = min(a0 + q, S - 1);
          acc[q] = 0.f;
        }
        if (is_dx) {  // dx[i, k = col] = sum_j g[i, j] exp(x[i, k] + y[k, j] - out[i, j]), i = a[q]
          float x[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) x[q] = X[a[q] * SP + col];
          for (int j = 0; j < S; ++j) {
            const float y = Y[col * SP + j];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 w = OG[a[q] * SP + j];
              acc[q] += w.y * __expf(x[q] + y - w.x);
            }
          }
        } else {  // dy[k, j = col] = sum_i g[i, j] exp(x[i, k] + y[k, j] - out[i, j]), k = a[q]
          float y[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) y[q] = Y[a[q] * SP + col];
          for (int i = 0; i < S; ++i) {
            const float2 w = OG[i * SP + col];
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[q] += w.y * __expf(X[i * SP + a[q]] + y[q] - w.x);
          }
        }
        float* d = dv + (long long)(2 * (p0 + p) + (is_dx ? 0 : 1)) * d_t + col;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (a0 + q < S) d[(a0 + q) * S] = acc[q];
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------------ C interface --

static Chain make_chain(const float* x, const long long* st, const int* bshape, int T, int S) {
  Chain c;
  c.p = x;
  c.st = st[0];
  c.sb0 = st[1];
  c.sb1 = st[2];
  c.sb2 = st[3];
  c.si = st[4];
  c.sj = st[5];
  c.n0 = bshape[0];
  c.n1 = bshape[1];
  c.n2 = bshape[2];
  c.T = T;
  c.S = S;
  return c;
}

// The pairs a CTA stages at once, given the matrices a pair needs, and the
// dynamic shared memory that takes; the kernels' limit is set once.
static int chunk(int S, int T, int mats, size_t* smem) {
  const size_t pair = (size_t)mats * S * (S + 1) * sizeof(float);
  int pc = (int)(LC_SMEM / pair);
  const int most = T / 2 > 0 ? T / 2 : 1;
  if (pc > most) pc = most;
  if (pc < 1) pc = 1;
  *smem = pc * pair;
  return pc;
}

static int ready() {
  static bool done = false;
  if (!done) {
    int err = (int)cudaFuncSetAttribute(lc_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LC_SMEM);
    if (err) return err;
    err = (int)cudaFuncSetAttribute(lc_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, LC_SMEM);
    if (err) return err;
    done = true;
  }
  return 0;
}

extern "C" {

// The factors of all rounds in a row of the tape (the wrapper sizes it).
long long lc_tape_factors(int T) {
  int n[LC_LEVELS];
  long long off[LC_LEVELS];
  const int R = chain_levels(T, n, off);
  return R ? off[R] + n[R] : 0;
}

// st: 6 element strides (time, three batch, row, column); bshape: the three
// batch sizes.  tape: (B, lc_tape_factors(T), S, S); out: (B, S, S).
int lc_forward(const float* x, const long long* st, const int* bshape, int T, int S, float* tape, float* out,
               void* stream) {
  if (T < 2 || S < 1 || S > LC_SMAX) return (int)cudaErrorInvalidValue;
  int err = ready();
  if (err) return err;
  const Chain c = make_chain(x, st, bshape, T, S);
  size_t smem;
  const int pc = chunk(S, T, 2, &smem);
  lc_forward_kernel<<<c.n0 * c.n1 * c.n2, LC_THREADS, smem, (cudaStream_t)stream>>>(c, tape, out, pc);
  return (int)cudaGetLastError();
}

// g: (B, S, S) contiguous; adj: scratch of the tape's size; dx: (T, B, S, S).
int lc_backward(const float* x, const long long* st, const int* bshape, int T, int S, const float* tape,
                const float* g, float* adj, float* dx, void* stream) {
  if (T < 2 || S < 1 || S > LC_SMAX) return (int)cudaErrorInvalidValue;
  int err = ready();
  if (err) return err;
  const Chain c = make_chain(x, st, bshape, T, S);
  size_t smem;
  const int pc = chunk(S, T, 4, &smem);
  lc_backward_kernel<<<c.n0 * c.n1 * c.n2, LC_THREADS, smem, (cudaStream_t)stream>>>(c, tape, g, adj, dx, pc);
  return (int)cudaGetLastError();
}

}  // extern "C"
