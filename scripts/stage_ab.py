"""Run chosen workflow phases of one checkout's ``chip_smoke.py`` on one card.

    python3 scripts/stage_ab.py TREE PHASE[,PHASE...] [--seed S]

Run from anywhere on a machine with an NVIDIA GPU.  TREE is the root of a
checkout (this one, or another unpacked beside it, e.g. the parent commit
under ``build/parent``); its own ``src`` and ``chip_smoke.py`` are
imported and its kernels built, so two trees run side by side in turns
(parent, change, change, parent), each in its own process.  PHASE is
``irregular`` (make_data and workflow_phase: bind, fit, log_evidence,
predict at n = 8760), ``ski`` (ski_phase: the gappy tide record through
bind, fit, log_evidence, compare and predict), ``nd`` (nd_phase: the
product-SKI, Kronecker and scattered (n, 2) stages), ``stochastic``
(stochastic_phase: the 1-D and (n, 2) stages at n = 65536) or
``distributed`` (distributed_phase at world size 1).  Each phase prints the lines that chip_smoke prints for it, then one
line ``{"stage_ab": {...}}`` with the tree, the phase, its seconds, its
stage times and its ln P_max and ln Z (per stage where it has several; the SKI and N-D phases
also their ln B).
How the stages of a change were compared with its parent's (PERF.md).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("tree")
    ap.add_argument("phases")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    tree = pathlib.Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _cuda

    if not torch.cuda.is_available():
        print("stage_ab: no CUDA device is available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    _cuda.build()
    for phase in args.phases.split(","):
        t0 = time.perf_counter()
        if phase == "irregular":
            x, y, xs = cs.make_data(args.seed, dev)
            s = cs.workflow_phase(x, y, xs, args.seed, "committed")
            res = dict(stage_s=s["stage_s"], log_p_max=s["log_p_max"],
                       log_z=s["log_z"], launches=s["launches"])
        elif phase == "ski":
            s = cs.ski_phase(args.seed)
            res = dict(stage_s=s["stage_s"], log_p_max=s["log_p_max"],
                       log_z=s["log_z"], ln_b=s["ln_b_k2_vs_k1"],
                       compare=s["compare"], launches=s["launches"])
        elif phase == "nd":
            out = cs.nd_phase(args.seed)
            res = {k: dict(stage_s=out[k]["stage_s"],
                           log_p_max=out[k]["log_p_max"],
                           log_z=out[k].get("log_z"),
                           ln_b=out[k].get("ln_b_matern32_vs_se"))
                   for k in ("product_ski", "kron", "irregular")}
        elif phase == "stochastic":
            out = cs.stochastic_phase(args.seed)
            res = {k: dict(stage_s=v.get("stage_s"),
                           log_p_max=v.get("log_p_max"),
                           log_z=v.get("log_z"))
                   for k, v in out.items() if isinstance(v, dict)}
        elif phase == "distributed":
            out = cs.distributed_phase(args.seed, dev)
            res = {k: dict(s=out[k].get("s"),
                           log_p_max=out[k].get("log_p_max"),
                           grad=out[k].get("grad"),
                           launches=out[k].get("launches"))
                   for k in ("tile", "example", "ski") if k in out}
        else:
            raise ValueError(f"unknown phase {phase!r}")
        print(json.dumps({"stage_ab": dict(
            tree=str(tree), phase=phase, s=time.perf_counter() - t0,
            **res)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
