"""The I/O-bound claims of the reference's tests/test_sim.py on the
port's simulator, at the reference's sizes (the port's parity with the
reference is in tests/test_torch_sim.py):

* adaptive scheduling no worse than round robin at an I/O-bound point,
  with every storage NIC busy;
* dualpath moves bytes on every node's storage NIC, basic leaves the DE
  nodes' NICs ~idle (the §4.2 assumption);
* split reads never cost JCT.
"""
import dataclasses

from repro_torch.sim import (DS_660B, HOPPER_NODE, Sim, SimConfig,
                             generate_dataset)

SLOW = dataclasses.replace(HOPPER_NODE, snic_bw=10e9)   # I/O-bound point


def test_adaptive_no_worse_than_round_robin():
    """Adaptive JCT <= round-robin JCT at an I/O-bound point, and
    adaptive engages every storage NIC."""
    res = {}
    for scheduler in ("adaptive", "rr"):
        trajs = generate_dataset(96, 32768, seed=0)
        cfg = SimConfig(node=SLOW, model=DS_660B, P=1, D=2,
                        mode="dualpath", scheduler=scheduler)
        sim = Sim(cfg, trajs).run()
        res[scheduler] = sim.results()["jct_max"]
        assert all(n.total_bytes > 0 for n in sim.snic.values())
    assert res["adaptive"] <= res["rr"] * 1.03, res


def test_sim_steady_state_matches_analysis():
    """Dualpath moves bytes on every node's storage NIC; basic leaves
    the DE nodes' NICs ~idle."""
    trajs = generate_dataset(96, 32768, seed=0)
    cfg = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=2,
                    mode="dualpath")
    sim = Sim(cfg, trajs).run()
    tot = [n.total_bytes for n in sim.snic.values()]
    assert all(t > 0 for t in tot), tot
    cfgb = SimConfig(node=HOPPER_NODE, model=DS_660B, P=1, D=2, mode="basic")
    simb = Sim(cfgb, trajs).run()
    totb = [n.total_bytes for n in simb.snic.values()]
    assert totb[1] == 0 or totb[1] < totb[0] * 0.05


def test_split_reads_option_is_safe():
    trajs = generate_dataset(64, 32768, seed=0)
    res = {}
    for split in (False, True):
        cfg = SimConfig(node=SLOW, model=DS_660B, P=1, D=2,
                        mode="dualpath", split_reads=split)
        r = Sim(cfg, trajs).run().results()
        assert r["finished_agents"] == 64
        res[split] = r["jct_max"]
    assert res[True] <= res[False] * 1.05
