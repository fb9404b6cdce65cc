"""The finite compute network (port of ``repro.network``, paper §5.1).

:class:`SharedLink` multiplexes model collectives against KV transfers
under the weighted-VL arbiter (or a FIFO arm, the ablation) in the
simulator; :class:`CollectiveVolumeModel` gives the collectives' bytes
per processed token; :func:`drain_times` with
:func:`kv_share_when_contended` is the closed-form two-class drain the
serving clock charges when those collectives share a compute NIC's link
with KV transfers.
"""
from repro_torch.network.collectives import CollectiveVolumeModel
from repro_torch.network.link import (ARBITERS, SharedLink, drain_times,
                                      kv_share_when_contended)

__all__ = [
    "ARBITERS",
    "CollectiveVolumeModel",
    "SharedLink",
    "drain_times",
    "kv_share_when_contended",
]
