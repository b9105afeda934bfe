"""Time K2, the Markov-chain scan, forward and backward on both routes at
model_1v's shape (B=32 sequences, T'=127 steps, S=256 states, emissions
about -35 a step), and K2g, the time-varying scan, at model_1vt's (the
same with a transition per step, shared by the sequences) on both of its
routes, on the card, for the checkout whose root is given.

Two versions of the kernels compare only within one machine's run: call
each checkout's own copy of this script, in turns (parent, change, change,
parent), from one command::

    python <checkout root>/pyro_tpu_torch/examples/markov_scan_timing.py <checkout root>

It prints one JSON line: the root, and the mean ms of each route's forward
and backward over 10 launches ("tv" for K2g on the route the wrapper
chooses, "tv_stream" on the streaming route), timed in turns a, b, c, d,
d, c, b, a after a warm-up launch.
"""

import json
import sys


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


def in_turns(torch, fns):
    first = {name: cuda_ms(torch, fn) for name, fn in fns.items()}
    second = {name: cuda_ms(torch, fn) for name, fn in reversed(list(fns.items()))}
    return {name: (first[name] + second[name]) / 2 for name in fns}


def main(root):
    sys.path.insert(0, root)
    import torch

    import pyro_tpu_torch
    from pyro_tpu_torch.ops import markov_scan as ms

    if not pyro_tpu_torch.__file__.startswith(root):
        raise RuntimeError(f"pyro_tpu_torch came from {pyro_tpu_torch.__file__}, not {root}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, S, steps = 32, 256, 127
    alpha0 = torch.randn((B, S), generator=gen, device="cuda")
    A = torch.log_softmax(torch.randn((S, S), generator=gen, device="cuda") * 2.0, dim=-1)
    R = torch.randn((steps, B, S), generator=gen, device="cuda") * 3.0 - 35.0
    g = torch.randn((B, S), generator=gen, device="cuda")
    At = torch.log_softmax(torch.randn((steps, S, S), generator=gen, device="cuda") * 2.0, dim=-1)
    plans = {"cluster": None, "stream": ms.ScanPlan("stream")}
    tv_plans = {"tv": None, "tv_stream": ms.ScanPlan("stream")}
    with torch.no_grad():
        saved = {route: ms._forward_cuda(alpha0, A, R, plan=plan)[1] for route, plan in plans.items()}
        saved.update({route: ms._tv_forward_cuda(alpha0, At, R, plan=plan)[1] for route, plan in tv_plans.items()})
        forward = in_turns(torch, {
            **{route: (lambda plan=plan: ms._forward_cuda(alpha0, A, R, plan=plan)) for route, plan in plans.items()},
            **{route: (lambda plan=plan: ms._tv_forward_cuda(alpha0, At, R, plan=plan))
               for route, plan in tv_plans.items()},
        })
    backward = in_turns(torch, {
        **{route: (lambda s=saved[route]: ms._backward_cuda(A, None, s, g)) for route in plans},
        **{route: (lambda s=saved[route]: ms._tv_backward_cuda(At, None, s, g)) for route in tv_plans},
    })
    print(json.dumps({"root": root, "device": torch.cuda.get_device_name(0), "forward": forward,
                      "backward": backward}))


if __name__ == "__main__":
    main(sys.argv[1])
