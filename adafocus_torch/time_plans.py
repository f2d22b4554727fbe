"""Times candidate bf16 plans of the fused-block kernels at every flagship block shape.

    python3 -m adafocus_torch.time_plans [OUT.json]

On one CUDA GPU, for each distinct residual block of the flagship (the
glancer's inverted residuals at 224^2 and the focuser's bottlenecks at 96^2
patches, N=1024, bf16, random weights), times the planner's own plan and the
cheapest few other plans of each kind by the cost model
(``ops/fused_blocks.py`` ``inv_residual_options`` / ``bottleneck_options``)
with CUDA events. Prints one line per timed plan, then per kernel the
planner's picks against the fastest timed plans, summed over one forward's
launches, with the card's name and power limit. Writes every timing to
OUT.json when given; the cost models' rates are least-squares fits to such
timings.
"""

import json
import subprocess
import sys

# (H, Cin, Chid, Cout, stride, expand or downsample, launches in one forward)
INV_RESIDUAL = [
    (112, 32, 32, 16, 1, False, 1), (112, 16, 96, 24, 2, True, 1), (56, 24, 144, 24, 1, True, 1),
    (56, 24, 144, 32, 2, True, 1), (28, 32, 192, 32, 1, True, 2), (28, 32, 192, 64, 2, True, 1),
    (14, 64, 384, 64, 1, True, 3), (14, 64, 384, 96, 1, True, 1), (14, 96, 576, 96, 1, True, 2),
    (14, 96, 576, 160, 2, True, 1), (7, 160, 960, 160, 1, True, 2), (7, 160, 960, 320, 1, True, 1),
]
BOTTLENECK = [
    (24, 64, 64, 256, 1, True, 1), (24, 256, 64, 256, 1, False, 2), (24, 256, 128, 512, 2, True, 1),
    (12, 512, 128, 512, 1, False, 3), (12, 512, 256, 1024, 2, True, 1),
    (6, 1024, 256, 1024, 1, False, 5), (6, 1024, 512, 2048, 2, True, 1),
    (3, 2048, 512, 2048, 1, False, 2),
]
N = 1024
PER_KIND = 3   # timed plans per kind of plan (warpgroup split, ring depth, wide)


def _time_ms(fn, iters: int = 8) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _candidates(options, kind):
    """The cheapest PER_KIND modelled plans of each kind of plan."""
    seen, out = {}, []
    for cost, _, plan in sorted(options, key=lambda o: o[0]):
        if seen.get(kind(plan), 0) < PER_KIND:
            seen[kind(plan)] = seen.get(kind(plan), 0) + 1
            out.append((cost, plan))
    return out


def main() -> int:
    import torch

    from adafocus_torch.models.mobilenet import InvertedResidual
    from adafocus_torch.models.resnet import Bottleneck
    from adafocus_torch.ops import fused_blocks as fb

    if not torch.cuda.is_available():
        print("time_plans: no CUDA device is visible", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    rows, summary = [], {}
    for kernel, shapes in (("fused_inverted_residual", INV_RESIDUAL), ("fused_bottleneck", BOTTLENECK)):
        picked = fastest = 0.0
        for h, cin, chid, cout, s, flag, launches in shapes:
            if kernel == "fused_inverted_residual":
                blk = InvertedResidual(cin, cout, s, chid // cin if flag else 1).cuda().eval()
                prm = fb.fold_inv_residual(blk, torch.bfloat16)
                run = lambda x: fb.fused_inverted_residual(x, prm, s, blk.use_res)  # noqa: E731
                name, options = "plan_inv_residual", fb.inv_residual_options(h, h, cin, chid, cout,
                                                                             s, flag, N)
                kind = lambda p: (p.ns, p.g * p.th * p.tw // 24)  # noqa: E731
            else:
                blk = Bottleneck(cin, chid, s, flag).cuda().eval()
                prm = fb.fold_bottleneck(blk, torch.bfloat16)
                run = lambda x: fb.fused_bottleneck(x, prm, s, True)  # noqa: E731
                name, options = "plan_bottleneck", fb.bottleneck_options(h, h, cin, chid, cout, s,
                                                                         flag, N)
                kind = lambda p: (p.ns, p.depth, p.wide)  # noqa: E731
            planner = getattr(fb, name)
            own = planner(h, h, cin, chid, cout, s, flag, 2, N)
            cands = _candidates(options, kind)
            if own not in [p for _, p in cands]:
                cands.append((min(options)[0], own))
            x = torch.randn((N, h, h, cin), generator=gen).to("cuda", torch.bfloat16)
            times = {}
            for cost, plan in cands:
                setattr(fb, name, lambda *a, plan=plan: plan)   # the wrapper asks its planner
                try:
                    times[plan] = _time_ms(lambda: run(x))
                finally:
                    setattr(fb, name, planner)
                rows.append({"kernel": kernel, "shape": [h, cin, chid, cout, s, flag],
                             "plan": plan._asdict(), "model_cycles": cost, "ms": times[plan],
                             "planner_pick": plan == own})
                print(f"{kernel} {(h, cin, chid, cout, s)} {tuple(plan)} model {cost!r} "
                      f"ms {times[plan]!r}{' (pick)' if plan == own else ''}", flush=True)
            picked += launches * times[own]
            fastest += launches * min(times.values())
            del x
        summary[kernel] = {"planner_ms": picked, "fastest_timed_ms": fastest}
        print(f"{kernel}: planner's picks {picked!r} ms, fastest timed plans {fastest!r} ms, "
              f"summed over one forward at N={N} bf16 ({card})", flush=True)
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump({"card": card, "plans": rows, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
