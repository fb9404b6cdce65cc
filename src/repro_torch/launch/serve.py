"""Serving launcher: run the port's DualPath serving system on an arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --agents 4 --mode dualpath --device cuda

Mirrors ``repro.launch.serve``: the reduced config, random weights from
a seed, ``--rounds`` rounds of (20 append, 4 generated) tokens per agent.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving import ServingSystem
from repro_torch.sim.traces import Round, Trajectory


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--agents", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--mode", choices=("dualpath", "basic"),
                    default="dualpath")
    ap.add_argument("--pe", type=int, default=1)
    ap.add_argument("--de", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    params = init_params(cfg, seed=0, device=args.device)
    system = ServingSystem(cfg, params, n_pe=args.pe, n_de=args.de,
                           mode=args.mode, block_tokens=16, max_seq=256,
                           de_slots=max(4, args.agents), device=args.device)
    trajs = [Trajectory(i, [Round(20, 4)] * args.rounds)
             for i in range(args.agents)]
    sessions = system.run_offline(trajs)
    print(f"completed {sum(s.rounds_done for s in sessions)} rounds "
          f"across {len(sessions)} agents ({args.mode}, {args.device})")
    for k, v in system.stats().items():
        print(f"  {k}: {v:,}" if isinstance(v, int) else f"  {k}: {v}")


if __name__ == "__main__":
    main()
