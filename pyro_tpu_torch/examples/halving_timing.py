"""Time K4a and K5a (``gl_halving_kernel<GAMMA>`` of
``csrc/gaussian_levels.cu``) on the card over the 13 levels of one
homogeneous ``log_prob`` at ``8.10000.32.4`` (``examples/gaussian_hmm.py``
for K4a, ``examples/gamma_gaussian_hmm.py`` for K5a: 40000 pairs at the
first level, 8 at the last), against an earlier ``gaussian_levels.cu``, in
turns on the same level inputs, recorded from one call of each through the
checkout's kernels::

    git show 2aec6e5:pyro_tpu_torch/csrc/gaussian_levels.cu > build/parent.cu
    python -m pyro_tpu_torch.examples.halving_timing build/parent.cu [variant.cu ...]

The first source is the earlier design with its own C interface
(``gl_halving`` and ``gl_gamma_halving`` taking a grid, no
``gl_halving_shape``; its grid as its wrapper planned it: a CTA a 8 pairs,
at most 8 an SM), such as the one at commit 2aec6e5; variants have the
checkout's interface, and the wrapper plans each one's grid from its own
``gl_halving_shape``.  Each is built with the package's nvcc flags into
``build/variants/``; its ptxas lines for the halving kernels are printed.
Every version's outputs are held against the checkout's at every level
(rtol 1e-4, atol 1e-4 times the largest entry), alpha' exactly.  Then, in
turns (each version, then again in reverse order), for K4a and for K5a: the
CUDA-event ms of one pass over the 13 levels (mean of 2 after a warm-up;
the levels launched back to back, so a host-paced level is timed at the
host's pace) and the profiler's device ms (the median of three passes
after 0.2 s of warm-up passes in one window); and each version's device
ms level by level, beside each level's pairs.
"""

import argparse
import ctypes
import functools
import subprocess
import time
from pathlib import Path

from pyro_tpu_torch.examples.halving_bwd_timing import cuda_ms


def device_passes(torch, fn, calls, passes=3, warm_up_s=0.2, name="gl_halving_kernel"):
    """``fn(*args)`` over ``calls`` in one profiled window, for ``warm_up_s``
    seconds at least and then ``passes`` times (a window may drop the kernel
    events of its first few milliseconds): per pass of the last ``passes``,
    each call's device ms of the kernel whose name holds ``name`` (one a
    call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        while time.perf_counter() - start < warm_up_s:
            for args in calls:
                fn(*args)
            torch.cuda.synchronize()
        for _ in range(passes):
            for args in calls:
                fn(*args)
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and name in e.name]
    k = len(calls)
    if len(times) < passes * k:
        raise RuntimeError(f"profiler: {len(times)} {name} kernels, fewer than {passes * k}")
    times = times[len(times) - passes * k:]
    return [times[p * k:(p + 1) * k] for p in range(passes)]


def build(sources, kernels):
    """The checkout's ``gaussian_levels.cu`` and each of ``sources`` ({name:
    path}) built with the package's nvcc flags, all at once, the variants
    into ``build/variants/``; the ptxas lines of the entry functions whose
    names hold one of ``kernels`` printed.  Returns {name: library path},
    the checkout's as "checkout"."""
    from pyro_tpu_torch.ops import cuda_build

    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for name, src in sources.items()}
    t0 = time.perf_counter()
    cuda_build.build_all(["gaussian_levels"])
    logs = {"checkout": cuda_build.BUILD_LOGS.get("gaussian_levels", "")}
    libs = {"checkout": cuda_build._target("gaussian_levels")}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = out_dir / f"lib{name}.so"
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(k in line for k in kernels):
                report = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "registers" in x]
                print(f"  {name}: {line.split()[-3]}", *report)
    return libs


def record(torch, gl):
    """The level inputs of one homogeneous ``GaussianHMM.log_prob`` (K4a) and
    one homogeneous ``GammaGaussianHMM.log_prob`` (K5a) at 8.10000.32.4,
    through the checkout's kernels: {"K4a": [args, ...], "K5a": [...]}."""
    from pyro_tpu_torch.examples import gamma_gaussian_hmm, gaussian_hmm

    out = {}
    for label, example, name in (("K4a", gaussian_hmm, "_halving_cuda"),
                                 ("K5a", gamma_gaussian_hmm, "_gamma_halving_cuda")):
        arrays = example.make_arrays("homogeneous", 0)
        params = {k: torch.tensor(v, device="cuda") for k, v in arrays.items()}
        data = params.pop("data")
        calls, wrapper = [], getattr(gl, name)

        def recorder(*args, wrapper=wrapper, calls=calls):
            calls.append(args)
            return wrapper(*args)

        setattr(gl, name, recorder)
        try:
            with torch.no_grad():
                example.make_hmm(params, example.CONFIGS["homogeneous"]["T"]).log_prob(data)
        finally:
            setattr(gl, name, wrapper)
        out[label] = calls
    return out


def earlier_kernels(torch, gl, lib):
    """The earlier K4a and K5a through their own C entries, on the grid the
    earlier wrapper planned: a CTA a 8 pairs, at most 8 an SM."""
    P_, c_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gl_halving.argtypes = [P_, P_, ll_, P_, ll_, c_, c_, c_, c_, P_, P_, P_, P_, P_, P_]
    lib.gl_gamma_halving.argtypes = [P_, P_, ll_, P_, ll_, P_, ll_, P_, ll_, c_, c_, c_, c_] + [P_] * 7
    lib.gl_halving.restype = lib.gl_gamma_halving.restype = c_

    def setup(P, info, logZ):
        R, two_m, n2 = info.shape
        P = P.contiguous()
        info, info_rs = gl._rows(info, two_m * n2)
        logZ, logZ_rs = gl._rows(logZ, two_m)
        blocks = max(1, min(-(-R * (two_m // 2) // 8), 8 * gl._sms(P.device)))
        new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
        return R, two_m // 2, n2 // 2, P, info, info_rs, logZ, logZ_rs, blocks, new

    def k4a(P, info, logZ, tape):
        R, m, n, P, info, info_rs, logZ, logZ_rs, blocks, new = setup(P, info, logZ)
        outs = new((2 * n, 2 * n)), new((n, n)), new((R, m, 2 * n)), new((R, m))
        ib = new((R, m, n)) if tape else None
        err = lib.gl_halving(P.data_ptr(), info.data_ptr(), info_rs, logZ.data_ptr(), logZ_rs, R, m, n, blocks,
                             *(x.data_ptr() for x in outs), gl._ptr(ib), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier K4a failed to launch: CUDA error {err}")
        return outs[0], outs[2], outs[3], outs[1], ib

    def k5a(P, info, logZ, alpha, beta):
        R, m, n, P, info, info_rs, logZ, logZ_rs, blocks, new = setup(P, info, logZ)
        (alpha, alpha_rs), (beta, beta_rs) = gl._rows(alpha, 2 * m), gl._rows(beta, 2 * m)
        P_out, L_out, info_out = new((2 * n, 2 * n)), new((n, n)), new((R, m, 2 * n))
        rest = new((R, m)), new((R, m)), new((R, m))
        err = lib.gl_gamma_halving(P.data_ptr(), info.data_ptr(), info_rs, logZ.data_ptr(), logZ_rs,
                                   alpha.data_ptr(), alpha_rs, beta.data_ptr(), beta_rs, R, m, n, blocks,
                                   P_out.data_ptr(), L_out.data_ptr(), info_out.data_ptr(),
                                   *(x.data_ptr() for x in rest), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier K5a failed to launch: CUDA error {err}")
        return (P_out, info_out, *rest)

    return {"K4a": k4a, "K5a": k5a}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", help="gaussian_levels.cu with the earlier K4a and K5a and their C interface")
    parser.add_argument("variants", nargs="*", help="variant sources of gaussian_levels.cu (the checkout's interface)")
    args = parser.parse_args()
    import torch

    import pyro_tpu_torch
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import gaussian_levels as gl

    pyro_tpu_torch.set_default_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = {"earlier": args.earlier, **{Path(src).stem: src for src in args.variants}}
    libs = build(sources, ("gl_halving_kernel",))

    def run(name, kernel):
        """Version ``name``'s ``kernel`` ("K4a" or "K5a"), its library loaded
        (the wrapper reads its shape anew)."""
        lib = "checkout" if name == "earlier" else name
        cuda_build._LIBS["gaussian_levels"] = ctypes.CDLL(str(libs[lib]))
        gl._lib.cache_clear()
        gl._tile_shape.cache_clear()
        if name == "earlier":
            return earlier[kernel]
        return {"K4a": gl._halving_cuda, "K5a": gl._gamma_halving_cuda}[kernel]

    earlier = earlier_kernels(torch, gl, ctypes.CDLL(str(libs["earlier"])))
    names = ["checkout", *sources]
    run("checkout", "K4a")
    recorded = record(torch, gl)
    with torch.no_grad():
        for kernel, calls in recorded.items():
            pairs = [a[1].shape[0] * (a[1].shape[1] // 2) for a in calls]
            ref = [run("checkout", kernel)(*a) for a in calls]
            for name in names:
                fn = run(name, kernel)
                for i, (a, want) in enumerate(zip(calls, ref)):
                    for j, (x, y) in enumerate(zip(fn(*a), want)):
                        if y is None:
                            continue
                        ok = torch.equal(x, y) if (kernel, j) == ("K5a", 3) else torch.allclose(
                            x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max()))
                        if not ok:
                            raise RuntimeError(f"{name} {kernel} output {j} differs from the checkout's at level {i} "
                                               f"({pairs[i]} pairs)")
            results, levels = {}, {}
            for name in names + names[::-1]:
                fn = run(name, kernel)
                ms = cuda_ms(torch, lambda: [fn(*a) for a in calls])
                passes = device_passes(torch, fn, calls)
                results.setdefault(name, []).append((ms, sorted(sum(p) for p in passes)[len(passes) // 2]))
                levels.setdefault(name, []).extend(passes)
            print(f"{kernel} over the {len(calls)} levels; levels' pairs: {pairs}")
            for name, v in results.items():
                print(f"  {name:>24}: events ms {[round(x[0], 4) for x in v]}, device ms {[round(x[1], 4) for x in v]}")
            for name, passes in levels.items():
                med = [sorted(p[i] for p in passes)[len(passes) // 2] for i in range(len(calls))]
                print(f"  {name:>24}: device ms a level {[round(x, 4) for x in med]}")
        run("checkout", "K4a")


if __name__ == "__main__":
    main()
