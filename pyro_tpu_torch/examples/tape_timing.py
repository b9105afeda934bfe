"""Time the two kernels that read K4b's tape, K4c (``gl_mids_kernel``) and
K4b's backward (``gl_contract_bwd_kernel``) of ``csrc/gaussian_levels.cu``,
on the card against an earlier ``gaussian_levels.cu``, in turns on the same
level inputs, recorded from one call of each path through the checkout's
kernels::

    git show e2d6486:pyro_tpu_torch/csrc/gaussian_levels.cu > build/parent.cu
    python -m pyro_tpu_torch.examples.tape_timing build/parent.cu [variant.cu ...]

The paths: the 12 K4c levels of a heterogeneous ``rsample_posterior`` with
64 draws at ``64.4000.16.4`` (``examples/gaussian_hmm.py``: 2000 pairs at
the finest level, L and P_mk per pair); the 13 of a homogeneous one with 4
draws at ``8.10000.32.4`` (L and P_mk shared); the 12 K4b backward levels
of one ``lgssm`` training step (``examples/lgssm.py``: GenericLGSSM, T=4000,
state 16; 2000 pairs at the first level).

The first source is the earlier design with the same C entries
(``gl_mids`` and ``gl_contract_bwd`` taking a grid) but no shape entries;
it runs on the grid its wrapper planned (K4c: a CTA a 8 (draw, pair) items,
at most 16 an SM; the backward: a CTA an item, at most 16 an SM), such as
the one at commit e2d6486.  Variants have the checkout's interface, and the
wrappers plan each one's grid from its own shape entries.  Each source is
built with the package's nvcc flags into ``build/variants/``; its ptxas
lines for the two kernels are printed.  Every version's outputs are held
against the checkout's at every level (rtol 1e-4, atol 1e-4 times the
largest entry, P gradients symmetrised).  Then, in turns (each version,
then again in reverse order), for each path: the CUDA-event ms of one pass
over the levels (mean of 2 after a warm-up; the levels launched back to
back, so a host-paced level is timed at the host's pace) and the
profiler's device ms (the median of three passes after 0.2 s of warm-up
passes in one window); and each version's device ms level by level,
beside each level's pairs.

With ``--marks`` it times nothing: it writes copies of the checkout's
source and of each variant (not the earlier source) with ``clock64`` marks
(by thread 0 of CTA 0, into a ``__device__`` array read back by an extra C
entry) under ``build/variants/``, builds them, runs the paths' first and
last levels through each, and prints each step's cycles: K4c's tape
loads, L^-1, the block barrier, the items and the last barrier of the
CTA's first tile; K4b backward's steps of the CTA's first pair (the loads,
L^-1, X, gX, gB, gL, M, T1, W, the outputs).  The committed kernels hold
no marks.
"""

import argparse
import ctypes
import functools
import re
import subprocess
from pathlib import Path

from pyro_tpu_torch.examples.halving_bwd_timing import cuda_ms
from pyro_tpu_torch.examples.halving_timing import build, device_passes

# the paths' recorded levels: (label, wrapper recorded, kernel name, pairs of a level's args)
PATHS = (
    ("K4c heterogeneous", "_mids_cuda", "gl_mids_kernel", lambda a: a[3].shape[0] * a[3].shape[1]),
    ("K4c homogeneous", "_mids_cuda", "gl_mids_kernel", lambda a: a[3].shape[0] * a[3].shape[1]),
    ("K4b backward", "_contract_bwd_cuda", "gl_contract_bwd_kernel", lambda a: a[1].shape[0] * a[1].shape[1]),
)


def _recording(gl, name, calls):
    wrapper = getattr(gl, name)

    def recorder(*args):
        calls.append(args)
        return wrapper(*args)

    setattr(gl, name, recorder)
    return wrapper


def record(torch, gl):
    """{label: [args, ...]} for each of PATHS, through the checkout's kernels."""
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch.contrib.timeseries import GenericLGSSM
    from pyro_tpu_torch.examples import gaussian_hmm, lgssm
    from pyro_tpu_torch.infer import Trace_ELBO

    out = {label: [] for label, *_ in PATHS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (label, name, *_), draws in zip(PATHS[:2], (64, 4)):
        config = label.split()[1]
        arrays = gaussian_hmm.make_arrays(config, 0)
        params = {k: torch.tensor(v, dtype=torch.float32, device="cuda") for k, v in arrays.items()}
        data = params.pop("data")
        hmm = gaussian_hmm.make_hmm(params, gaussian_hmm.CONFIGS[config]["T"])
        wrapper = _recording(gl, name, out[label])
        try:
            with torch.no_grad():
                hmm.rsample_posterior(data, gen, (draws,))
        finally:
            setattr(gl, name, wrapper)
    label, name, *_ = PATHS[2]
    model = lgssm.make_model(GenericLGSSM(obs_dim=lgssm.OBS_DIM, state_dim=lgssm.STATE_DIM, name="GenericLGSSM"))
    wrapper = _recording(gl, name, out[label])
    try:
        Trace_ELBO().differentiable_loss(model, lambda *a: None, lgssm.make_targets(0, torch.float32)).backward()
    finally:
        setattr(gl, name, wrapper)
        pyro.clear_param_store()
    return out


def earlier_kernels(torch, gl, lib):
    """The earlier K4c and K4b backward through their C entries, on the
    grids their wrapper planned."""
    P_, c_, ll_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gl_mids.argtypes = [P_, c_, P_, ll_, P_, ll_, P_, P_, c_, c_, c_, c_, c_, P_, P_]
    lib.gl_contract_bwd.argtypes = [P_] * 6 + [c_] * 5 + [P_] * 4
    lib.gl_mids.restype = lib.gl_contract_bwd.restype = c_
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def mids(cur, L, P_mk, i_m, eps):
        D, R, m, n = cur.shape
        Np, shared = i_m.shape[-2], L.ndim == 2
        out = torch.empty((D, R, m + Np, n), dtype=cur.dtype, device=cur.device)
        blocks = max(1, min(-(-D * R * Np // 8), 16 * gl._sms(cur.device)))
        err = lib.gl_mids(cur.data_ptr(), m, L.data_ptr(), 0 if shared else n * n, P_mk.data_ptr(),
                          0 if shared else 2 * n * n, i_m.data_ptr(), eps.data_ptr(), D, R, Np, n, blocks,
                          out.data_ptr(), stream())
        if err:
            raise RuntimeError(f"the earlier K4c failed to launch: CUDA error {err}")
        return out

    def contract_bwd(t, L, P_mk, i_m, g_P, g_info, g_logZ):
        R, np_, n, _ = L.shape
        new = functools.partial(torch.empty, dtype=L.dtype, device=L.device)
        gP, ginfo, glogZ = new((R, t, 2 * n, 2 * n)), new((R, t, 2 * n)), new((R, t))
        blocks = max(1, min(R * (t - np_), 16 * gl._sms(L.device)))
        err = lib.gl_contract_bwd(L.data_ptr(), P_mk.data_ptr(), i_m.data_ptr(), gl._ptr(g_P), gl._ptr(g_info),
                                  gl._ptr(g_logZ), R, t, n, t - np_, blocks, gP.data_ptr(), ginfo.data_ptr(),
                                  glogZ.data_ptr(), stream())
        if err:
            raise RuntimeError(f"the earlier K4b backward failed to launch: CUDA error {err}")
        return gP, ginfo, glogZ

    return {"_mids_cuda": mids, "_contract_bwd_cuda": contract_bwd}


# K4c's marks in the per-pair tile loop of gl_mids_kernel and in md_stage:
# (text of the source, "|" where mark k goes, k)
MIDS_MARKS = [
    ("|      if (warp < np) md_stage<NP>(", 0),
    ("  __syncwarp();\n|  hb_tri_inverse<NP, S::LS>", 1),
    ("md + warp * S::FLOATS, lane);\n|      __syncthreads();", 2),
    ("      __syncthreads();\n    }\n|    for (int it = tid;", 3),
    ("|    if (!shared) __syncthreads();  // the slots free for the next tile\n", 4),
    ("    if (!shared) __syncthreads();  // the slots free for the next tile\n|", 5),
]
MIDS_STEPS = ["tape loads", "L^-1", "barrier", "items", "barrier"]
BWD_STEPS = ["loads", "L^-1", "X", "gX", "gB", "gL", "M, S", "T1", "W", "outputs"]


def marked_source(src):
    """The checkout's source with clock64 marks: K4c's at MIDS_MARKS (0-5),
    K4b backward's at the start of cb_pair and after each of its
    __syncwarp() (10-20), and the C entry gl_read_marks."""
    head = ("__device__ long long g_marks[32];\n#define MK(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) "
            "g_marks[k] = clock64(); } while (0)\n")
    src = src.replace("#define HALF_LOG_2PI", head + "#define HALF_LOG_2PI", 1)
    for anchor, k in MIDS_MARKS:
        before, after = anchor.split("|")
        if before + after not in src:
            raise RuntimeError(f"marks: {before + after!r} not in the source")
        src = src.replace(before + after, before + f"MK({k});\n" + after, 1)
    a = src.index("__device__ __forceinline__ void cb_pair(")
    a = src.index("{", a) + 1
    b = src.index("__global__ void", a)
    count = iter(range(11, 21))
    body = re.sub(r"\n  __syncwarp\(\);[^\n]*", lambda m: m.group(0) + f"\n  MK({next(count)});", src[a:b])
    src = src[:a] + "\n  MK(10);" + body + src[b:]
    return src.replace('extern "C" {', 'extern "C" {\nint gl_read_marks(long long* out) '
                       '{ return (int)cudaMemcpyFromSymbol(out, g_marks, sizeof(g_marks)); }\n', 1)


def print_marks(torch, gl, lib, recorded):
    """Each path's first and last level through the marked library ``lib``
    (its third run read), each step's cycles."""
    lib.gl_read_marks.argtypes = [ctypes.c_void_p]
    lib.gl_read_marks.restype = ctypes.c_int
    marks = (ctypes.c_longlong * 32)()
    for (label, name, _, pairs_of), first in zip(PATHS, (0, 0, 10)):
        steps = BWD_STEPS if name == "_contract_bwd_cuda" else MIDS_STEPS
        if label == "K4c homogeneous":
            continue  # L and P_mk shared: no per-pair tile loop
        for args in (recorded[label][0], recorded[label][-1]):
            for _ in range(3):
                getattr(gl, name)(*args)
            torch.cuda.synchronize()
            if lib.gl_read_marks(marks):
                raise RuntimeError("marks: cudaMemcpyFromSymbol failed")
            m = marks[first:first + len(steps) + 1]
            print(f"  {label} at {pairs_of(args)} pairs, cycles: "
                  + ", ".join(f"{s} {b - a}" for s, a, b in zip(steps, m, m[1:])) + f"; in all {m[-1] - m[0]}")


def _outputs(out):
    """A version's outputs as a tuple, P gradients symmetrised."""
    if not isinstance(out, tuple):
        return (out,)
    gP, *rest = out
    return (0.5 * (gP + gP.transpose(-1, -2)), *rest)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("earlier", help="gaussian_levels.cu with the earlier K4c and K4b backward")
    parser.add_argument("variants", nargs="*", help="variant sources of gaussian_levels.cu (the checkout's interface)")
    parser.add_argument("--marks", action="store_true", help="print each step's clock64 cycles instead of timing")
    args = parser.parse_args()
    import torch

    import pyro_tpu_torch
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import gaussian_levels as gl

    pyro_tpu_torch.set_default_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sources = {"earlier": args.earlier, **{Path(src).stem: src for src in args.variants}}
    if args.marks:
        out_dir = cuda_build.BUILD_DIR.parent / "variants"
        out_dir.mkdir(parents=True, exist_ok=True)
        marked = {}
        for name, src in {"checkout": cuda_build.CSRC_DIR / "gaussian_levels.cu", **sources}.items():
            if name != "earlier":
                marked[f"{name}-marks"] = out_dir / f"{name}-marks.cu"
                marked[f"{name}-marks"].write_text(marked_source(Path(src).read_text()))
        sources = marked
    libs = build(sources, ("gl_mids_kernel", "gl_contract_bwd_kernel"))
    if args.marks:
        recorded = record(torch, gl)
        for name in sources:
            print(name)
            cuda_build._LIBS["gaussian_levels"] = lib = ctypes.CDLL(str(libs[name]))
            gl._lib.cache_clear()
            gl._tile_shape.cache_clear()
            with torch.no_grad():
                print_marks(torch, gl, lib, recorded)
        return
    checkout = {name: getattr(gl, name) for name in ("_mids_cuda", "_contract_bwd_cuda")}

    def run(version, name):
        """Version ``version``'s kernel behind the wrapper ``name``, its
        library loaded (the wrappers read its shapes anew)."""
        cuda_build._LIBS["gaussian_levels"] = ctypes.CDLL(str(libs["checkout" if version == "earlier" else version]))
        gl._lib.cache_clear()
        gl._tile_shape.cache_clear()
        return earlier[name] if version == "earlier" else checkout[name]

    earlier = earlier_kernels(torch, gl, ctypes.CDLL(str(libs["earlier"])))
    versions = ["checkout", *sources]
    run("checkout", "_mids_cuda")
    recorded = record(torch, gl)
    with torch.no_grad():
        for label, name, kernel_name, pairs_of in PATHS:
            calls = recorded[label]
            pairs = [pairs_of(a) for a in calls]
            ref = [_outputs(run("checkout", name)(*a)) for a in calls]
            for version in versions:
                fn = run(version, name)
                for i, (a, want) in enumerate(zip(calls, ref)):
                    for x, y in zip(_outputs(fn(*a)), want):
                        if not torch.allclose(x, y, rtol=1e-4, atol=1e-4 * float(y.abs().max())):
                            raise RuntimeError(f"{version} {label} differs from the checkout's at level {i} "
                                               f"({pairs[i]} pairs)")
            results, levels = {}, {}
            for version in versions + versions[::-1]:
                fn = run(version, name)
                ms = cuda_ms(torch, lambda: [fn(*a) for a in calls])
                passes = device_passes(torch, fn, calls, name=kernel_name)
                results.setdefault(version, []).append((ms, sorted(sum(p) for p in passes)[len(passes) // 2]))
                levels.setdefault(version, []).extend(passes)
            print(f"{label} over the {len(calls)} levels; levels' pairs: {pairs}")
            for version, v in results.items():
                print(f"  {version:>24}: events ms {[round(x[0], 4) for x in v]}, "
                      f"device ms {[round(x[1], 4) for x in v]}")
            for version, passes in levels.items():
                med = [sorted(p[i] for p in passes)[len(passes) // 2] for i in range(len(calls))]
                print(f"  {version:>24}: device ms a level {[round(x, 4) for x in med]}")
        run("checkout", "_mids_cuda")


if __name__ == "__main__":
    main()
