"""Checkpoint save/restore + fault-tolerant training runner (port of
``repro.ckpt.checkpoint``).

Layout, as the reference's: one ``ckpt_{step:08d}.npz`` per checkpoint
holding every leaf under ``params//<path>`` and ``opt//<path>`` (a path
being the tree's keys and list indices joined by ``//``) and a pickled
``__meta__`` (step and extra, e.g. the data pipeline's state).  npz holds
no bfloat16, so a bf16 leaf is stored as its ``uint16`` view and restored
by the dtype of the ``*_like`` leaf.  Saves are atomic (a temp file, then
``os.replace``).  Restore puts each tensor on the device of its
``*_like`` leaf; the reference's ``shardings=`` (re-sharding onto
another mesh) comes with the mesh layer (ROADMAP Queue 1 item 4).

``FaultTolerantRunner`` wraps a train loop with periodic checkpointing
and crash/resume semantics; a resumed run reproduces the uninterrupted
one bit for bit.
"""
from __future__ import annotations

import os
import pickle
import re
import tempfile
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.training.tree import leaves_with_paths, tree_map

SEP = "//"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {SEP.join(path): _to_numpy(leaf)
            for path, leaf in leaves_with_paths(tree)}


def save_checkpoint(path: str, step: int, params, opt_state,
                    extra: Optional[dict] = None):
    """Atomic save (write temp + rename) — a crash mid-save never
    corrupts the latest checkpoint."""
    os.makedirs(path, exist_ok=True)
    flat = {"params" + SEP + k: v for k, v in _flatten(params).items()}
    flat.update({"opt" + SEP + k: v for k, v in _flatten(opt_state).items()})
    meta = dict(step=step, extra=extra or {})
    fname = os.path.join(path, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            pickle.dumps(meta), dtype=np.uint8), **flat)
    os.replace(tmp, fname)
    return fname


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _leaf(raw: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(raw)).to(like.dtype)
    return t.to(like.device)


def restore_checkpoint(path: str, params_like, opt_like,
                       step: Optional[int] = None):
    """Restore into the structure (and dtypes and devices) of
    (params_like, opt_like); the latest step unless ``step`` is given.
    Returns None when there is no checkpoint."""
    step = step if step is not None else latest_step(path)
    if step is None:
        return None
    with np.load(os.path.join(path, f"ckpt_{step:08d}.npz")) as data:
        meta = pickle.loads(data["__meta__"].tobytes())

        def rebuild(tree_like, prefix):
            flat = dict(leaves_with_paths(tree_like))
            out = {p: _leaf(data[prefix + SEP + SEP.join(p)], leaf)
                   for p, leaf in flat.items()}
            it = iter(out.values())
            return tree_map(lambda _: next(it), tree_like)

        params = rebuild(params_like, "params")
        opt = rebuild(opt_like, "opt")
    return dict(step=meta["step"], params=params, opt_state=opt,
                extra=meta["extra"])


class FaultTolerantRunner:
    """Train loop with periodic checkpointing and resume.

    ``run(n_steps)`` executes from wherever the latest checkpoint left
    off; crash injection (``crash_at``) raises after that step to let
    tests verify recovery reproduces the uninterrupted run bitwise.
    """

    def __init__(self, ckpt_dir: str, train_step: Callable, params,
                 opt_state, pipeline, ckpt_every: int = 10):
        self.ckpt_dir = ckpt_dir
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.pipeline = pipeline
        self.ckpt_every = ckpt_every
        self.step = 0
        self.losses = []

    def try_resume(self) -> bool:
        r = restore_checkpoint(self.ckpt_dir, self.params, self.opt_state)
        if r is None:
            return False
        self.params, self.opt_state = r["params"], r["opt_state"]
        self.step = r["step"]
        if "pipeline" in r["extra"]:
            self.pipeline.load_state_dict(r["extra"]["pipeline"])
        return True

    def run(self, n_steps: int, crash_at: Optional[int] = None):
        while self.step < n_steps:
            batch = torch.from_numpy(self.pipeline.next_batch())
            self.params, self.opt_state, loss = self.train_step(
                self.params, self.opt_state, batch)
            self.step += 1
            self.losses.append(float(loss))
            if self.step % self.ckpt_every == 0 or self.step == n_steps:
                save_checkpoint(self.ckpt_dir, self.step, self.params,
                                self.opt_state,
                                extra=dict(pipeline=self.pipeline.state_dict()))
            if crash_at is not None and self.step == crash_at:
                raise RuntimeError(f"injected crash at step {self.step}")
        return self.losses
