"""Time K4a's backward (``gl_halving_bwd_kernel`` of
``csrc/gaussian_levels.cu``) on the card over the 13 levels of one
``homogeneous`` training step (the ``--train`` model of
``examples/gaussian_hmm.py`` at ``8.10000.32.4``: 40000 pairs at the first
level, 8 at the last), against the earlier design of the same function
(two kernels a level: ``gl_halving_bwd_pairs_kernel``, a warp a pair,
then ``gl_halving_bwd_shared_kernel`` on one CTA), in turns on the same
tapes and upstream gradients, recorded from one step through the
checkout's kernels::

    git show 93cd7e3:pyro_tpu_torch/csrc/gaussian_levels.cu > build/earlier.cu
    python -m pyro_tpu_torch.examples.halving_bwd_timing build/earlier.cu [variant.cu ...]

The first source is a ``gaussian_levels.cu`` with the earlier design and
its C interface (``gl_halving_bwd`` taking a grid and a buffer of one
partial a CTA), such as the one at commit 93cd7e3; variants have the
checkout's, and the wrapper plans each one's grid from its own
``gl_halving_bwd_shape`` (a variant at another ``HB_CTAS`` runs that many
CTAs an SM).  Each is built with the package's nvcc flags into
``build/variants/``; its ptxas lines for the K4a backward kernels are
printed.  Every version's outputs are held against the checkout's at
every level (rtol 1e-4, atol 1e-4 times the largest entry, P gradients
symmetrised).  Then, in turns
(each version, then again in reverse order), the CUDA-event ms of one
pass over the 13 levels (mean of 2 after a warm-up; the levels launched
back to back) and the profiler's device ms (the median of the last three
of four passes in one window) of the K4a backward kernels and of the
counters' memsets; and each version's device ms level by level, beside
each level's pairs.
"""

import argparse
import ctypes
import functools
import subprocess
import time
from pathlib import Path


def cuda_ms(torch, fn, iters=2):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_passes(torch, fn, calls, per_call, passes=3):
    """``fn(args)`` over ``calls``, ``passes + 1`` times in one profiled
    window: per pass of the last ``passes``, the device ms of each call's
    ``per_call`` K4a backward kernels (a window may drop its first few),
    and the memsets' device ms a pass."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes + 1):
            for args in calls:
                fn(*args)
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e.device_time_total / 1e3 for e in events if "gl_halving_bwd" in e.name]
    memsets = sum(e.device_time_total / 1e3 for e in events if "memset" in e.name.lower())
    if len(kernels) < passes * len(calls) * per_call:
        raise RuntimeError(f"profiler: {len(kernels)} K4a backward kernels for {(passes + 1) * len(calls)} levels")
    k = per_call * len(calls)
    kernels = kernels[len(kernels) - passes * k:]
    return [[sum(kernels[p * k + i * per_call:p * k + (i + 1) * per_call]) for i in range(len(calls))]
            for p in range(passes)], memsets / (passes + 1)


def record(torch, gl):
    """The (P, L, ib, gP', gi', gZ') of each level of one ``homogeneous``
    training step's backward, through the checkout's kernels."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.examples import gaussian_hmm as example
    from pyro_tpu_torch.infer import Trace_ELBO

    params = example.params_from_jax(example.make_arrays("homogeneous", 0))
    data = params.pop("data")
    calls, wrapper = [], gl._halving_bwd_cuda

    def recorder(*args):
        calls.append(args)
        return wrapper(*args)

    gl._halving_bwd_cuda = recorder
    try:
        Trace_ELBO().differentiable_loss(example.make_train_model(params), lambda *a: None, data).backward()
    finally:
        gl._halving_bwd_cuda = wrapper
        pyro.clear_param_store()
    return calls


def earlier_kernel(torch, gl, lib):
    """The earlier K4a backward through its own C entry: a grid of one CTA a 32
    pairs (at most 2 an SM) and one partial of 3 n^2 + 1 floats a CTA."""
    P_, c_ = ctypes.c_void_p, ctypes.c_int
    lib.gl_halving_bwd.argtypes = [P_] * 6 + [c_] * 4 + [P_] * 5
    lib.gl_halving_bwd.restype = c_

    def kernel(P, L, ib, g_P, g_info, g_logZ):
        R, m, n = ib.shape
        new = functools.partial(torch.empty, dtype=P.dtype, device=P.device)
        blocks = max(1, min(-(-R * m // 32), 2 * gl._sms(P.device)))
        partial = new((blocks, 3 * n * n + 1))
        gP, ginfo, glogZ = new((2 * n, 2 * n)), new((R, 2 * m, 2 * n)), new((R, 2 * m))
        err = lib.gl_halving_bwd(P.data_ptr(), L.data_ptr(), ib.data_ptr(), gl._ptr(g_P), gl._ptr(g_info),
                                 gl._ptr(g_logZ), R, m, n, blocks, partial.data_ptr(), gP.data_ptr(),
                                 ginfo.data_ptr(), glogZ.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"the earlier K4a backward failed to launch: CUDA error {err}")
        return gP, ginfo, glogZ

    return kernel


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", help="gaussian_levels.cu with the earlier K4a backward")
    parser.add_argument("variants", nargs="*", help="variant sources of gaussian_levels.cu (the checkout's interface)")
    args = parser.parse_args()
    import torch

    import pyro_tpu_torch
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import gaussian_levels as gl

    pyro_tpu_torch.set_default_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    sources = {"earlier": args.earlier, **{Path(src).stem: src for src in args.variants}}
    procs = {name: (out_dir / f"lib{name}.so", subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for name, src in sources.items()}
    t0 = time.perf_counter()
    cuda_build.build_all(["gaussian_levels"])
    logs = {"checkout": cuda_build.BUILD_LOGS.get("gaussian_levels", "")}
    libs = {"checkout": cuda_build._target("gaussian_levels")}
    for name, (lib, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        libs[name] = lib
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "halving_bwd" in line:
                report = [x.strip() for x in lines[i + 1:i + 4] if "spill" in x or "registers" in x]
                print(f"  {name}: {line.split()[-3]}", *report)

    def run(name):
        """Version ``name``'s kernel, its library loaded (the wrapper reads
        its shape anew)."""
        lib, kernel, _ = versions[name]
        cuda_build._LIBS["gaussian_levels"] = ctypes.CDLL(str(libs[lib]))
        gl._lib.cache_clear()
        gl._halving_bwd_shape.cache_clear()
        return kernel

    # name: (library, kernel, kernels a level)
    versions = {"checkout": ("checkout", gl._halving_bwd_cuda, 1),
                "earlier": ("checkout", earlier_kernel(torch, gl, ctypes.CDLL(str(libs["earlier"]))), 2),
                **{name: (name, gl._halving_bwd_cuda, 1) for name in sources if name != "earlier"}}
    run("checkout")
    calls = record(torch, gl)
    pairs = [a[2].shape[0] * a[2].shape[1] for a in calls]
    sym = lambda g: 0.5 * (g + g.transpose(-1, -2))  # noqa: E731
    with torch.no_grad():
        kernel = run("checkout")
        ref = [kernel(*a) for a in calls]
        for name in versions:
            kernel = run(name)
            for i, (a, want) in enumerate(zip(calls, ref)):
                got = kernel(*a)
                for x, y in zip((sym(got[0]), *got[1:]), (sym(want[0]), *want[1:])):
                    if not torch.allclose(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max())):
                        raise RuntimeError(f"{name} differs from the checkout at level {i} ({pairs[i]} pairs)")
        results, levels = {}, {}
        for name in list(versions) + list(reversed(list(versions))):
            kernel = run(name)
            ms = cuda_ms(torch, lambda: [kernel(*a) for a in calls])
            passes, memsets = device_passes(torch, kernel, calls, versions[name][2])
            dev = sorted(sum(p) for p in passes)[len(passes) // 2]
            results.setdefault(name, []).append((ms, dev, memsets))
            levels.setdefault(name, []).extend(passes)
        run("checkout")
    print(f"levels' pairs: {pairs}")
    for name, v in results.items():
        print(f"{name:>28}: events ms {[round(x[0], 4) for x in v]}, device ms {[round(x[1], 4) for x in v]}, "
              f"memsets device ms a pass {[round(x[2], 4) for x in v]}")
    for name, passes in levels.items():
        med = [sorted(p[i] for p in passes)[len(passes) // 2] for i in range(len(calls))]
        print(f"{name:>28}: device ms a level {[round(x, 4) for x in med]}")


if __name__ == "__main__":
    main()
