"""Time K2g, the time-varying Markov scan (``csrc/markov_scan.cu``), on the
card at model_1vt's shape (B=32 sequences, T'=127 steps, S=256 states, a
transition per step shared by the sequences, emissions about -35 a step)
against variant sources of the same file, in turns, and split a step of the
cluster route into its phases::

    python -m pyro_tpu_torch.examples.scan_tv_timing [variant.cu ...] [--plans 8,3 16,4 ...] [--marks]

Every variant has the checkout's C interface.  Besides the sources given,
the script builds ``no_tma``: the checkout with the tensor copies of the
slices turned off, so that they go by 4-byte cp.async.  Each is built with
the package's nvcc flags into ``build/variants/`` (its ptxas lines for the
cluster kernels printed) and loaded in place of the checkout's library, and
its forward is held against the float64 plain version (atol 1e-4 plus rtol
1e-6).  Then, in turns (every version, then again in reverse order), the
forward and backward ms (CUDA events, the mean of 10 launches after a
warm-up) on the route the wrapper plans (the cluster route here) and on the
streaming route.  ``--plans C,rows ...`` times the checkout at other cluster
plans.  ``--marks`` builds a copy of the checkout with ``clock64`` marks at
the phase boundaries of a step of both cluster kernels (CTA 0 of cluster
0), and prints each phase's median cycles a step over steps 5 to 119, for
the planned route and every ``--plans`` entry.  It prints one JSON line a
result.
"""

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

B, S, STEPS = 32, 256, 127


def cuda_ms(torch, fn, iters=10):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def replace_once(text, old, new):
    if text.count(old) != 1:
        raise RuntimeError(f"variant: {text.count(old)} matches of {old[:60]!r}")
    return text.replace(old, new)


# the phases of a step and the lines they start before (True) or after
FORWARD_MARKS = [
    ("    if (t > 0) mbar_wait(smem_addr(&bars[t & 1]), ((t - 1) >> 1) & 1);", True),  # wait for the carry
    ("    if (t > 0) mbar_wait(smem_addr(&bars[t & 1]), ((t - 1) >> 1) & 1);", False),  # the row pass
    ("    __syncthreads();\n    if (part < nparts) {\n      for (int rc = 0; rc < nr; rc += 4) {", True),  # product
    ("    // o of the own columns", True),  # the epilogue
    ("    if (t + 1 < T) {\n      __syncthreads();\n#pragma unroll\n      for (int i = 0; i < MAXS; ++i) {\n"
     "        const int j = send_j[i];\n        if (j < 0) continue;\n"
     "        if (vec)\n          st_async4(peer_addr(nxt", True),  # the sends
    ("      // while the carry is in flight", True),  # wait for the slice
    ("      tv_prep_forward(stage, W4, wn, nparts, part, pw, l_begin, l_end, pm, cs, E);\n      if (t + 2 < T)",
     True),  # c and E
    ("      if (t + 2 < T) tv_stage_slice(cp, As + (t + 2) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, t + 2);",
     True),  # issuing the copy
    ("      if (t + 2 < T) tv_stage_slice(cp, As + (t + 2) * sa.t, sa.l, S, wn, W4, stage, sbar, r0, (int)a, t + 2);",
     False),  # the end of the step
]
FORWARD_PHASES = ["wait carry", "row pass", "product", "epilogue", "sends", "wait slice", "c and E", "issuing the copy",
                  "end of step"]
BACKWARD_MARKS = [
    ("    const int par = t & 1;\n    const unsigned bar = smem_addr(&bars[par]);", False),  # the product
    ("    __syncthreads();\n    const unsigned rbase", True),  # the sends
    ("    // while the partials are in flight", True),  # wait for the slice
    ("      mbar_wait(sbar, (T - t) & 1);", False),  # E
    ("      tv_prep_backward(stage, S4, W4, wn, c_in + ((t - 1) * nA + a) * S + r0, E);", False),  # copy, wait
    ("    mbar_wait(bar, ((T - 1 - t) >> 1) & 1);", False),  # the epilogue
    ("    two = two_next;\n    two_next = two_after;\n    __syncthreads();", False),  # end
]
BACKWARD_PHASES = ["product", "sends", "wait slice", "E", "issuing the copy, waiting for partials", "epilogue"]


def with_marks(source):
    """The source with clock64 marks at the phase boundaries of the cluster
    kernels' steps, and a C entry ``tv_marks`` that copies them out."""
    cut = source.index("template <int ME>\n__global__ void __launch_bounds__(NTC, 1) mstvc_forward_kernel(")
    head, text = source[:cut], source[cut:]
    text = "__device__ long long tv_fmarks[16][512];\n__device__ long long tv_bmarks[16][512];\n" + text
    for arr, marks in (("tv_fmarks", FORWARD_MARKS), ("tv_bmarks", BACKWARD_MARKS)):
        for k, (anchor, before) in enumerate(marks):
            mark = f"if (blockIdx.x == 0 && threadIdx.x == 0 && t < 512) {arr}[{k}][t] = clock64();"
            text = replace_once(text, anchor, f"{mark}\n{anchor}" if before else f"{anchor}\n{mark}")
    return head + text + """
extern "C" int tv_marks(long long* f, long long* b) {
  int err = (int)cudaMemcpyFromSymbol(f, tv_fmarks, sizeof(tv_fmarks));
  if (err) return err;
  return (int)cudaMemcpyFromSymbol(b, tv_bmarks, sizeof(tv_bmarks));
}
"""


def build(sources):
    """Build every (name, text) with the package's nvcc flags, all at once,
    and load them."""
    from pyro_tpu_torch.ops import cuda_build

    out_dir = Path(__file__).resolve().parents[2] / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src, lib = out_dir / f"tv_{name}.cu", out_dir / f"libtv_{name}.so"
        src.write_text(text)
        procs[name] = (lib, subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel = None
        for line in log.splitlines():
            if "Compiling entry" in line:
                kernel = line.split("'")[1] if "mstvc_forward_kernelILi4" in line or "mstvc_backward" in line else None
            elif kernel and "Used" in line:
                print(json.dumps({"variant": name, "kernel": kernel[:32], "ptxas": line.split(":", 1)[1].strip()}))
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help="markov_scan.cu variants with the checkout's C interface")
    parser.add_argument("--plans", nargs="*", default=[], help="cluster plans C,rows at which to time the checkout")
    parser.add_argument("--marks", action="store_true", help="split a step of the cluster kernels into phases")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import markov_scan as ms

    if not torch.cuda.is_available():
        raise SystemExit("scan_tv_timing: needs a CUDA device")
    checkout = (cuda_build.CSRC_DIR / "markov_scan.cu").read_text()
    sources = {"checkout": checkout}
    sources.update({Path(p).stem: Path(p).read_text() for p in args.variants})
    tma_check = "  if (!vec || S > 1024 || (box_rows < S && box_rows * W % 32) || !encode) return cp;"
    sources["no_tma"] = replace_once(checkout, tma_check, "  return cp;")
    if args.marks:
        sources["marks"] = with_marks(checkout)
    libs = build(sources)

    def use(name):
        cuda_build._LIBS["markov_scan"] = libs[name]
        ms._lib.cache_clear()
        ms._device_plan_tv.cache_clear()

    gen = torch.Generator(device="cuda").manual_seed(1)
    alpha0 = torch.randn((B, S), generator=gen, device="cuda")
    R = torch.randn((STEPS, B, S), generator=gen, device="cuda") * 3.0 - 35.0
    g = torch.randn((B, S), generator=gen, device="cuda")
    A = torch.log_softmax(torch.randn((STEPS, S, S), generator=gen, device="cuda") * 2.0, dim=-1)
    ref = ms.markov_scan_tv_plain(alpha0.double(), A.double(), R.double())
    stream = ms.ScanPlan("stream")
    names = [n for n in sources if n != "marks"]
    times = {n: {} for n in names}
    for order in (names, names[::-1]):
        for name in order:
            use(name)
            with torch.no_grad():
                out, saved = ms._tv_forward_cuda(alpha0, A, R)
                _, saved_stream = ms._tv_forward_cuda(alpha0, A, R, plan=stream)
                excess = float(((out.double() - ref).abs() - (1e-4 + 1e-6 * ref.abs())).max())
                if excess > 0:
                    raise RuntimeError(f"{name}: forward outside atol 1e-4 + rtol 1e-6 of float64 by {excess:.3g}")
                t = {"forward": cuda_ms(torch, lambda: ms._tv_forward_cuda(alpha0, A, R)),
                     "stream_forward": cuda_ms(torch, lambda: ms._tv_forward_cuda(alpha0, A, R, plan=stream))}
            t["backward"] = cuda_ms(torch, lambda: ms._tv_backward_cuda(A, None, saved, g))
            t["stream_backward"] = cuda_ms(torch, lambda: ms._tv_backward_cuda(A, None, saved_stream, g))
            for k, v in t.items():
                times[name].setdefault(k, []).append(v)
            times[name]["plan"] = str(saved[0])
    device = torch.cuda.get_device_name(0)
    for name in names:
        print(json.dumps({"variant": name, "device": device, **times[name]}))

    plans = [ms.ScanPlan("cluster", *map(int, p.split(","))) for p in args.plans]
    use("checkout")
    for plan in plans:
        with torch.no_grad():
            saved = ms._tv_forward_cuda(alpha0, A, R, plan=plan)[1]
            forward = cuda_ms(torch, lambda: ms._tv_forward_cuda(alpha0, A, R, plan=plan))
        backward = cuda_ms(torch, lambda: ms._tv_backward_cuda(A, None, saved, g))
        print(json.dumps({"plan": str(plan), "active_clusters": ms.active_clusters_tv(S, plan.cluster, plan.rows,
                                                                                      alpha0.device),
                          "forward": forward, "backward": backward}))

    if args.marks:
        use("marks")
        for plan in [None] + plans:
            with torch.no_grad():
                saved = ms._tv_forward_cuda(alpha0, A, R, plan=plan)[1]
            ms._tv_backward_cuda(A, None, saved, g)
            torch.cuda.synchronize()
            f, b = np.zeros((16, 512), dtype=np.int64), np.zeros((16, 512), dtype=np.int64)
            err = libs["marks"].tv_marks(f.ctypes.data_as(ctypes.c_void_p), b.ctypes.data_as(ctypes.c_void_p))
            if err:
                raise RuntimeError(f"tv_marks: CUDA error {err}")
            ts = np.arange(5, 120)
            nf = len(FORWARD_MARKS)
            fwd = [f[k + 1, ts] - f[k, ts] for k in range(nf - 1)] + [f[0, ts + 1] - f[nf - 1, ts]]
            bwd = [b[k + 1, ts] - b[k, ts] for k in range(len(BACKWARD_MARKS) - 1)]
            print(json.dumps({
                "plan": str(saved[0]), "device": device,
                "forward_cycles": {n: int(np.median(d)) for n, d in zip(FORWARD_PHASES, fwd)},
                "forward_step": int(np.median(f[0, ts + 1] - f[0, ts])),
                "backward_cycles": {n: int(np.median(d)) for n, d in zip(BACKWARD_PHASES, bwd)},
                "backward_step": int(np.median(b[0, ts] - b[0, ts + 1])),
            }))


if __name__ == "__main__":
    main()
