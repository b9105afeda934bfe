#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pyro_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device and build: the card's name and power limit, and the CUDA
     kernels built from ``pyro_tpu_torch/csrc`` with nvcc;
  2. K1, log-matmul-exp forward and backward, against its plain PyTorch
     version on the card at the main path's shape and at others, timed at
     the main path's shape beside the plain version, ``torch.matmul`` (the
     product alone) and the card's bound;
  3. the slice at full width: model_7 of ``examples/hmm.py`` (B=32
     sequences, T=128, D=51 tones, S=256 states) trained for 5 SVI steps
     with AutoDelta, Trace_ELBO and Adam, counting kernel launches;
  4. a ``kernels`` JSON line, then the result line.

Tolerances: forward atol 1e-4 on log values; gradients rtol 1e-4 with atol
1e-5 * max|g| (the kernel sums in another order than cuBLAS); the HMM
log-likelihood rtol 1e-4 against the same reduction through the plain
version.  Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks (dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3

B, T, D, S, NN_DIM, NN_CHANNELS, STEPS = 32, 128, 51, 256, 32, 2, 5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters):
    """Mean milliseconds of ``fn`` on the card over ``iters`` calls, after a warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(fns, iters=10):
    """Time each fn in turns a, b, b, a and return the mean ms of each."""
    first = {name: cuda_ms(fn, iters) for name, fn in fns.items()}
    second = {name: cuda_ms(fn, iters) for name, fn in reversed(list(fns.items()))}
    return {name: (first[name] + second[name]) / 2 for name in fns}


def max_err(a, b):
    return float((a - b).abs().max())


def compare_k1(lm, leaves, split, g, label, f64_check=True):
    """Kernel forward and backward against the plain version on the operands
    ``split(*leaves)`` (views of the leaves, so strided layouts reach the
    kernel as they are), and the first batch item's forward against a
    float64 logsumexp; returns the largest forward and gradient errors."""
    import torch

    grads = []
    outs = []
    for fn in (lm.logmatmulexp, lm.logmatmulexp_plain):
        copies = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*split(*copies))
        (out * g).sum().backward()
        outs.append(out.detach())
        grads.append([c.grad for c in copies])
    torch.cuda.synchronize()
    out_k, out_p = outs
    check(torch.isfinite(out_k).all(), f"{label}: non-finite forward output")
    check(out_k.shape == out_p.shape, f"{label}: shape {tuple(out_k.shape)} != {tuple(out_p.shape)}")
    fwd_err = max_err(out_k, out_p)
    check(fwd_err <= 1e-4, f"{label}: forward max abs err {fwd_err} > 1e-4")
    if f64_check:
        x, y = (t.detach() for t in split(*leaves))
        batch = out_k.shape[:-2]
        x0 = x.expand(batch + x.shape[-2:]).reshape(-1, *x.shape[-2:])[0].double()
        y0 = y.expand(batch + y.shape[-2:]).reshape(-1, *y.shape[-2:])[0].double()
        ref = torch.logsumexp(x0[:, :, None] + y0[None], dim=1)
        f64_err = max_err(out_k.reshape(-1, *out_k.shape[-2:])[0].double(), ref)
        check(f64_err <= 1e-4, f"{label}: forward differs from float64 by {f64_err}")
        print(f"  {label}: first item's forward max abs err to float64 {f64_err:.3g}")
    atol = 1e-5 * float(g.abs().max())
    bwd_err = 0.0
    for a, b in zip(*grads):
        check(torch.isfinite(a).all(), f"{label}: non-finite gradient")
        excess = float(((a - b).abs() - (atol + 1e-4 * b.abs())).max())
        check(excess <= 0, f"{label}: gradient outside rtol 1e-4, atol {atol:.3g} by {excess:.3g}")
        bwd_err = max(bwd_err, max_err(a, b))
    print(f"  {label}: forward max abs err {fwd_err:.3g}, gradient max abs err {bwd_err:.3g}")
    return fwd_err, bwd_err


def _pair(x, y):
    return x, y


def _halves(logits):
    pairs = logits.reshape(logits.shape[0], logits.shape[1] // 2, 2, *logits.shape[2:])
    return pairs[..., 0, :, :], pairs[..., 1, :, :]


def phase_k1(torch, lm):
    print("phase 2: K1 log-matmul-exp against its plain version")
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    # the main path's first round: time-paired strided halves of (B, T, S, S)
    logits = randn(B, T, S, S, scale=2.0)
    x, y = _halves(logits)
    g = randn(B, T // 2, S, S)
    fwd_err, bwd_err = compare_k1(lm, [logits], _halves, g, f"({B * T // 2}, {S}, {S}) strided halves")
    big = [randn(16, 512, 512, scale=3.0), randn(16, 512, 512, scale=3.0)]
    compare_k1(lm, big, _pair, randn(16, 512, 512), "(16, 512, 512)")
    ragged = [randn(3, 37, 129, scale=3.0), randn(1, 129, 61, scale=3.0)]
    compare_k1(lm, ragged, _pair, randn(3, 37, 61), "(3, 37, 129) @ (1, 129, 61)")
    ux = torch.full((4, 8), -300.0, device="cuda")
    ux[:, 0] = 0.0
    uy = torch.full((8, 8), -200.0, device="cuda")
    uy[1:, :] = -1.0
    compare_k1(lm, [ux, uy], _pair, randn(4, 8, scale=5.0), "underflow", f64_check=False)
    ux[0, :] = -float("inf")
    uy = torch.full((8, 8), -200.0, device="cuda")
    uy[:, 3] = -float("inf")
    compare_k1(lm, [ux, uy], _pair, torch.ones(4, 8, device="cuda"), "-inf rows and columns", f64_check=False)
    out = lm.logmatmulexp(ux, uy)
    check(bool((out[0] < -80).all()), "an all -inf row must give log(FLT_MIN)")

    # timing at the main path's first-round shape
    n = x.shape[0] * x.shape[1]
    M = K = N = S
    with torch.no_grad():
        out = lm._forward_cuda(x, y)
        fwd = alternate({
            "kernel": lambda: lm._forward_cuda(x, y),
            "plain": lambda: lm._logmatmulexp_raw(x, y),
        })
        matmul_ms = cuda_ms(lambda: torch.matmul(x, y), 10)
        bwd = alternate({
            "kernel": lambda: lm._backward_cuda(x, y, out, g),
            "plain": lambda: lm._logmatmulexp_bwd(x, y, out, g),
        })
    fwd_flops = 2 * n * M * N * K + n * (M * K + K * N + M * N)
    fwd_bytes = 4 * n * (M * K + K * N + M * N)
    bwd_flops = 4 * n * M * N * K + n * (2 * M * K + 2 * K * N + 2 * M * N)
    bwd_bytes = 4 * n * (2 * M * K + 2 * K * N + 2 * M * N)

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")

    fb, bb = bound(fwd_flops, fwd_bytes), bound(bwd_flops, bwd_bytes)
    print(f"  timing at ({n}, {M}, {K}) @ ({n}, {K}, {N}) f32, strided halves:")
    print(f"    forward  kernel {fwd['kernel']:.4f} ms  plain {fwd['plain']:.4f} ms  bound {fb[0]:.4f} ms ({fb[1]})")
    print(f"    torch.matmul of the same operands (the product alone, no exp/log): {matmul_ms:.4f} ms")
    print(f"    backward kernel {bwd['kernel']:.4f} ms  plain {bwd['plain']:.4f} ms  bound {bb[0]:.4f} ms ({bb[1]})")
    return {
        "forward": {"max_abs_err": fwd_err, "ms": fwd["kernel"], "plain_ms": fwd["plain"], "bound": fb},
        "backward": {"max_abs_err": bwd_err, "ms": bwd["kernel"], "plain_ms": bwd["plain"], "bound": bb},
        "matmul_ms": matmul_ms,
    }


def phase_slice(torch, lm):
    print(f"phase 3: model_7 SVI at B={B}, T={T}, D={D}, S={S}, nn_dim={NN_DIM}")
    import pyro_tpu_torch as pyro
    from pyro_tpu_torch import poutine
    from pyro_tpu_torch.distributions import hmm
    from pyro_tpu_torch.examples import hmm as example

    args = example.parse_args([
        "--hidden-dim", str(S), "--num-sequences", str(B), "--max-length", str(T), "--data-dim", str(D),
        "--nn-dim", str(NN_DIM), "--nn-channels", str(NN_CHANNELS), "--num-steps", str(STEPS),
    ])
    sequences, lengths = example.synthetic_sequences(args.seed, B, T, D)
    pyro.clear_param_store()
    model, guide, svi = example.make_svi(args, args.learning_rate)

    # the step-0 parameters: the HMM likelihood through the kernel against
    # the same reduction through the plain version
    with torch.no_grad():
        guide_trace = poutine.trace(guide).get_trace(sequences, lengths)
        model_trace = poutine.trace(poutine.replay(model, trace=guide_trace)).get_trace(sequences, lengths)
        site = model_trace.nodes["y"]
        d, value = site["fn"], site["value"]
        lp = d.log_prob(value)
        v = value.unsqueeze(-1 - d.observation_dist.event_dim)
        result = d.transition_logits + d.observation_dist.log_prob(v).unsqueeze(-2)
        result = hmm._sequential_logmatmulexp(result, logmatmulexp=lm.logmatmulexp_plain)
        lp_plain = torch.logsumexp(d.initial_logits + torch.logsumexp(result, dim=-1), dim=-1)
    check(lp.shape == (B,) and bool(torch.isfinite(lp).all()), f"log_prob shape {tuple(lp.shape)} or values bad")
    rel = float(((lp - lp_plain).abs() / lp_plain.abs()).max())
    check(rel <= 1e-4, f"DiscreteHMM.log_prob differs from the plain reduction by rtol {rel}")
    print(f"  DiscreteHMM.log_prob at step-0 params: max rel diff to plain {rel:.3g}")

    lm.launches.update(forward=0, backward=0)
    losses, step_ms = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        losses.append(svi.step(sequences, lengths))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(lm.launches)
    print(f"  losses {losses}")
    print(f"  ms per step {[round(t, 3) for t in step_ms]} (first step includes guide set-up)")
    print(f"  launches over {STEPS} steps: {launches}")
    check(all(map(lambda l: l == l and abs(l) != float("inf"), losses)), "non-finite loss")
    check(launches == {"forward": 7 * STEPS, "backward": 7 * STEPS}, f"expected 7 launches per step each, got {launches}")
    profile_step(torch, svi, sequences, lengths)
    return launches, step_ms


def profile_step(torch, svi, sequences, lengths):
    """One more SVI step under torch.profiler: device time by kernel, and
    the device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svi.step(sequences, lengths)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
        key=lambda e: -e.self_device_time_total,
    )
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k1_ms = sum(e.self_device_time_total for e in kernels if e.key.startswith("lme_")) / 1e3
    print(f"  profiled step: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}%), K1 kernels {k1_ms:.3f} ms")
    for e in kernels[:8]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import pyro_tpu_torch

    check(os.path.dirname(os.path.dirname(os.path.abspath(pyro_tpu_torch.__file__))) == HERE,
          "pyro_tpu_torch must come from this checkout")
    from pyro_tpu_torch.ops import cuda_build
    from pyro_tpu_torch.ops import log_matmul as lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    print("phase 1: device and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"  {torch.cuda.get_device_name(0)}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build_all(["log_matmul"])
    print(f"  built log_matmul in {time.perf_counter() - t0:.2f} s")
    for line in cuda_build.BUILD_LOGS.get("log_matmul", "").splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    k1 = phase_k1(torch, lm)
    launches, step_ms = phase_slice(torch, lm)

    kernels = []
    for name, direction, line in (("logmatmulexp_fwd", "forward", 36), ("logmatmulexp_bwd", "backward", 59)):
        r = k1[direction]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "pyro_tpu_torch/csrc/log_matmul.cu",
            "replaces": f"pyro_tpu/ops/log_matmul.py:{line}",
            "launches": launches[direction],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1],
            "library_ms": None,
        })
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
