"""The finite compute network as the serving runtime uses it (port of
``repro.network``, paper §5.1): :class:`CollectiveVolumeModel` gives the
model collectives' bytes per processed token, and :func:`drain_times`
with :func:`kv_share_when_contended` is the closed-form two-class drain
the serving clock charges when those collectives share a compute NIC's
link with KV transfers.
"""
from repro_torch.network.collectives import CollectiveVolumeModel
from repro_torch.network.link import drain_times, kv_share_when_contended

__all__ = ["CollectiveVolumeModel", "drain_times", "kv_share_when_contended"]
