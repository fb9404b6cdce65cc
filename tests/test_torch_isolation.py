"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

* Importing every ``repro_torch`` module in a fresh interpreter leaves
  neither ``jax`` nor any ``repro``/``repro.*`` module in sys.modules.
* No source file of the port says ``import jax``, ``from jax``,
  ``import repro`` or ``from repro.``.
* An entry point called without ``device=`` on a machine without CUDA
  raises instead of running on the CPU (the dense, MoE + MLA and SSM
  families alike, and training's launcher and optimizer-state bridge),
  and so does the simulator's settle asked for ``"cuda"``.
* A family without the config its blocks need (MoE, SSM, hybrid) is
  refused, naming that config.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parent.parent / "src"
PKG = SRC / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_importing_every_module_pulls_in_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20, out          # every module was imported
    assert out[1].strip() == "[]", out[1]


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


def test_no_source_file_imports_jax_or_repro():
    files = sorted(PKG.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) >= 20
    offenders = [str(f) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert offenders == []


def test_entry_points_without_device_raise_without_cuda(monkeypatch):
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import init_decode_state, init_params
    from repro_torch.serving import ServingSystem
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(cfg, 1, 16)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSystem(cfg, params)
    # the bridge carries the reference's weights and state across: on the
    # card unless the CPU is named
    blocks = {"w": np.zeros((cfg.n_layers, 2), np.float32)}
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.to_torch(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_jax({"embed": np.zeros(2, np.float32),
                                "blocks": blocks}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.state_from_jax({"kv": {"k": np.zeros(2, np.float32)}})
    assert bridge.to_torch(np.ones(3, np.float32), "cpu").device.type == "cpu"
    # ds27b (MoE + MLA) the same way: its parameters, its latent decode
    # state, the bridge's MoE stacks and state, and serving
    ds = get_config("ds27b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(ds)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(ds, 1, 16)
    ds_params = init_params(ds, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSystem(ds, ds_params)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.params_from_jax(
            {"embed": np.zeros(2, np.float32),
             "dense_blocks": {"w": np.zeros((1, 2), np.float32)},
             "super_blocks": {"moe": {"w": np.zeros((3, 2), np.float32)}}},
            ds)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.state_from_jax(
            {"dense": {"c": np.zeros((1, 1, 2, 3), np.float32)},
             "moe": {"c": np.zeros((3, 1, 2, 3), np.float32)}})
    # mamba2 (SSM) the same way: its parameters, its state, the state
    # blob's way back to the card, and serving
    from repro_torch.engines import kvio
    m2 = get_config("mamba2-1.3b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(m2)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(m2, 1, 16)
    m2_params = init_params(m2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSystem(m2, m2_params)
    blob = kvio.state_to_blob(init_decode_state(m2, 1, 16, "cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        kvio.blob_to_state(m2, blob)
    # zamba2 (hybrid: Mamba2 + a shared attention block) the same way:
    # its parameters, its state (Mamba2 leaves and the shared K/V), the
    # bridge's (n_super, period) stacks, the blob's way back, and serving
    z2 = get_config("zamba2-2.7b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(z2)
    with pytest.raises(RuntimeError, match="cuda"):
        init_decode_state(z2, 1, 16)
    z2_params = init_params(z2, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServingSystem(z2, z2_params)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.state_from_jax(
            {"mamba": {"ssm": np.zeros((2, 2, 1, 3), np.float32)},
             "shared": {"k": np.zeros((2, 1, 4, 3), np.float32)}})
    blob = kvio.state_to_blob(init_decode_state(z2, 1, 16, "cpu"))
    with pytest.raises(RuntimeError, match="cuda"):
        kvio.blob_to_state(z2, blob, max_seq=16)
    # the simulator runs on the host; only its opt-in settle names a
    # device, and a missing card raises instead of settling on the CPU
    from repro_torch.sim import (DS_660B, HOPPER_NODE, SimConfig, VectorSim,
                                 generate_dataset)
    sim_cfg = SimConfig(HOPPER_NODE, DS_660B, 1, 1)
    trajs = generate_dataset(2, 2048)
    with pytest.raises(RuntimeError, match="cuda"):
        VectorSim(sim_cfg, trajs, settle_device="cuda")
    assert VectorSim(sim_cfg, trajs)._settle_kernel is None


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """Training's entry points default to the card too: the launcher and
    the bridge's optimizer state raise without one."""
    import numpy as np
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    cfg = get_config("qwen1.5-0.5b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.opt_state_from_jax(
            {"m": {"embed": np.zeros(2, np.float32)},
             "v": {"embed": np.zeros(2, np.float32)},
             "step": np.zeros((), np.int32)}, cfg)
    assert not any(tmp_path.iterdir())       # nothing ran, nothing saved


def test_cuda_path_raises_on_cpu_only_arguments():
    """A kernel wrapper never quietly falls back: mixed devices raise."""
    from repro_torch.kernels import build
    with pytest.raises(ValueError):
        build.require_cuda("k", torch.zeros(1))


@pytest.mark.parametrize("family,match", [
    ("moe", "MoE config"),            # MoE needs its MoEConfig
    ("ssm", "SSM config"),            # the SSM family needs its SSMConfig
    ("hybrid", "SSM config"),         # and so does the hybrid's backbone
])
def test_unported_families_raise_with_their_slice(family, match):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              family=family)
    assert cfg.ssm is None
    with pytest.raises(NotImplementedError, match=match):
        init_params(cfg, device="cpu")
