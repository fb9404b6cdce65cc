"""Training launcher: the port's train step with periodic checkpoints and
resume, on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
        --steps 50 --reduced --device cuda

Mirrors ``repro.launch.train`` without ``--mesh`` (the mesh layer is
ROADMAP Queue 1 item 4): random weights from seed 0, ``SyntheticLM``
batches, 2 microbatches, a checkpoint every 25 steps in ``--ckpt-dir``,
from which a rerun resumes.
"""
from __future__ import annotations

import argparse

from repro_torch.ckpt import FaultTolerantRunner
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.training import SyntheticLM, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt_init, train_step = make_train_step(cfg, lr=args.lr,
                                           n_microbatches=2)
    params = init_params(cfg, seed=0, device=args.device)
    pipe = SyntheticLM(cfg.vocab_size, args.batch, args.seq, seed=0)
    runner = FaultTolerantRunner(args.ckpt_dir, train_step, params,
                                 opt_init(params), pipe, ckpt_every=25)
    if runner.try_resume():
        print(f"resumed at step {runner.step}")
    losses = runner.run(args.steps)
    print(f"steps {runner.step}: loss {losses[0]:.3f} -> {losses[-1]:.3f}")


if __name__ == "__main__":
    main()
