"""The event simulator and its inputs (port of ``repro.sim``).

``Sim`` and ``VectorSim`` model a DualPath cluster in modelled time on
the host (no device work; see sim/simulator.py); ``generate_dataset``
draws the paper's Table 2 agent trajectories; the fault classes inject
slowdowns, stragglers and engine deaths; the specs describe the paper's
hardware and models.
"""
from repro_torch.sim.faults import (
    EngineDeath,
    FaultSchedule,
    SlowdownWindow,
    StragglerModel,
)
from repro_torch.sim.simulator import Sim, SimConfig
from repro_torch.sim.spec import (
    DS_660B,
    HOPPER_NODE,
    QWEN25_32B,
    GPUSpec,
    ModelSimSpec,
    NodeSpec,
)
from repro_torch.sim.traces import Trajectory, dataset_stats, generate_dataset
from repro_torch.sim.vectorized import VectorSim, VectorSimUnsupported
