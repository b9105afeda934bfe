"""Time the pair contraction (K4b and K5b, ``gl_contract_kernel`` of
``csrc/gaussian_levels.cu``) on the levels the paths pass it, on the card:
the Student-t ``filter`` at ``8.10000.32.4`` (K5b, 14 levels at n=32, the
chain's precision read with stride 0), the Student-t heterogeneous
``log_prob`` at ``8.4000.16.4`` (K5b, 12 levels at n=16) and the
heterogeneous ``rsample_posterior``'s forward at ``64.4000.16.4`` (K4b, 12
levels with the tape).  The level inputs are recorded from one call of
each through the checkout's own kernels.

Variants of ``gaussian_levels.cu`` (the same C interface) compare with the
checkout's source within one run, in turns (checkout, variants, variants
reversed, checkout)::

    python -m pyro_tpu_torch.examples.contract_timing [variant.cu ...]

Each is built with the package's nvcc flags into ``build/variants/``.  For
each source it prints the SASS instruction count of the contraction
kernels, and for each path the CUDA-event ms of one pass over its levels
(mean of 2 after a warm-up) and the profiler's device ms (the median of
the last three of four passes in one window); then the checkout's device
ms level by level for the filter.  The outputs of every variant are held
against the checkout's at two levels of each path (rtol 1e-4, atol 1e-4
times the largest entry) unless ``--no-check`` is given, for variants that
leave work out on purpose.
"""

import argparse
import ctypes
import os
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


def device_ms(torch, kernel, calls, passes=3):
    """Per pass over ``calls``, the contraction kernels' device ms: the last
    ``passes`` of ``passes + 1`` in one profiled window (a window may lose
    its first kernel events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(passes + 1):
            for args in calls:
                kernel(*args)
        torch.cuda.synchronize()
    times = [e.device_time_total / 1e3 for e in prof.events()
             if e.device_type == DeviceType.CUDA and "gl_contract_kernel" in e.name]
    m = len(calls)
    if len(times) < passes * m:
        raise RuntimeError(f"profiler: {len(times)} contraction kernels of {(passes + 1) * m}")
    times = times[len(times) - passes * m:]
    return [times[i * m:(i + 1) * m] for i in range(passes)]


def sass_counts(nvcc, lib):
    """Instructions of each contraction kernel in ``lib`` (cuobjdump -sass)."""
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "gl_contract_kernel" in fn and line.strip().startswith("/*") and line.count("*/") >= 2:
            counts[fn] = counts.get(fn, 0) + 1
    return counts


def record(torch, gl):
    """The level inputs of the three paths, recorded through the kernels."""
    from pyro_tpu_torch.examples import gamma_gaussian_hmm, gaussian_hmm

    def models(example):
        out = {}
        for config in ("homogeneous", "heterogeneous"):
            arrays = example.make_arrays(config, 0)
            params = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in arrays.items()}
            data = params.pop("data")
            out[config] = (example.make_hmm(params, example.CONFIGS[config]["T"]), data)
        return out

    def recorded(name, fn):
        calls, wrapper = [], getattr(gl, name)

        def recorder(*args, **kwargs):
            calls.append(args[:5])
            return wrapper(*args, **kwargs)

        setattr(gl, name, recorder)
        try:
            fn()
        finally:
            setattr(gl, name, wrapper)
        return calls

    gg, g = models(gamma_gaussian_hmm), models(gaussian_hmm)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return {
        "K5b filter n=32": (recorded("gamma_contract_pairs", lambda: gg["homogeneous"][0].filter(gg["homogeneous"][1])),
                            gl._gamma_contract_cuda),
        "K5b log_prob n=16": (recorded("gamma_contract_pairs",
                                       lambda: gg["heterogeneous"][0].log_prob(gg["heterogeneous"][1])),
                              gl._gamma_contract_cuda),
        "K4b rsample n=16": (recorded("contract_pairs", lambda: g["heterogeneous"][0].rsample_posterior(
            g["heterogeneous"][1], gen, (64,))), lambda *a: gl._contract_cuda(*a[:3], True)),
    }


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("variants", nargs="*", help="variant sources of gaussian_levels.cu")
    parser.add_argument("--no-check", action="store_true", help="do not hold variants' outputs to the checkout's")
    args = parser.parse_args()
    import torch

    import pyro_tpu_torch
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import gaussian_levels as gl

    pyro_tpu_torch.set_default_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    out_dir = cuda_build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for src in args.variants:
        lib = out_dir / f"lib{Path(src).stem}.so"
        procs[Path(src).stem] = (lib, subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib), src],
                                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    t0 = time.perf_counter()
    cuda_build.build_all(["gaussian_levels"])
    libs = {"checkout": cuda_build._target("gaussian_levels")}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = lib
    print(f"built in {time.perf_counter() - t0:.1f} s")
    for name, lib in libs.items():
        print(f"{name}: SASS instructions {sass_counts(nvcc, lib)}")

    def use(name):
        cuda_build._LIBS["gaussian_levels"] = ctypes.CDLL(str(libs[name]))
        gl._lib.cache_clear()
        gl._contract_ctas_per_sm.cache_clear()

    use("checkout")
    with torch.no_grad():
        paths = record(torch, gl)
        picks = {label: [calls[0], calls[len(calls) // 2]] for label, (calls, _) in paths.items()}
        ref = {label: [paths[label][1](*a) for a in picks[label]] for label in paths}
        results = {}
        for name in list(libs) + list(reversed(list(libs))):
            use(name)
            for label, (calls, kernel) in paths.items():
                if not args.no_check:
                    for a, want in zip(picks[label], ref[label]):
                        for x, y in zip(kernel(*a)[:3], want[:3]):
                            if not torch.allclose(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max())):
                                raise RuntimeError(f"{name} differs from the checkout on {label}")
                ms = cuda_ms(torch, lambda: [kernel(*a) for a in calls])
                dev = sorted(sum(p) for p in device_ms(torch, kernel, calls))[1]
                results.setdefault((name, label), []).append((ms, dev))
        for (name, label), v in results.items():
            print(f"{name:>16} {label:>18}: events ms {[round(x[0], 4) for x in v]}, "
                  f"device ms {[round(x[1], 4) for x in v]}")
        use("checkout")
        calls, kernel = paths["K5b filter n=32"]
        levels = device_ms(torch, kernel, calls)
        print("checkout, K5b filter n=32, device ms a level:",
              [round(sorted(p[i] for p in levels)[1], 4) for i in range(len(calls))])


if __name__ == "__main__":
    main()
