"""Model-collective volumes for the finite compute network (port of
``repro.network.collectives``, the analytic form).

Per layer a TP-sharded transformer all-reduces the attention output and
the FFN output, each moving ``2·(g−1)/g`` of one hidden activation
vector across the link (ring all-reduce), so

    bytes/token ≈ n_layers · 2 · d_model · dtype_bytes · 2(g−1)/g.

``ModelSimSpec`` (the simulator's model descriptor) carries no
``d_model``, so :meth:`CollectiveVolumeModel.from_spec` takes the
attention width ``n_heads · qk_head_dim`` as the activation width: equal
for dense models, an over-estimate for MLA's widened QK heads.  The
reference's ``from_hlo_text`` (volumes counted in a compiled program)
waits for the mesh layer.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CollectiveVolumeModel:
    """Collective bytes the compute network carries per processed token
    (prefill and decode alike: the collectives run per forward step and
    scale with its tokens), with the per-layer share."""

    bytes_per_token: float
    n_layers: int

    @property
    def bytes_per_token_layer(self) -> float:
        return self.bytes_per_token / max(self.n_layers, 1)

    def step_bytes(self, tokens: int) -> float:
        """Collective volume of one forward or decode step over
        ``tokens`` freshly processed tokens."""
        return self.bytes_per_token * max(tokens, 0)

    @classmethod
    def analytic(cls, n_layers: int, act_width: int, group_size: int,
                 dtype_bytes: int = 2) -> "CollectiveVolumeModel":
        g = max(group_size, 1)
        if g == 1:                     # unsharded: nothing crosses the net
            return cls(0.0, n_layers)
        per_layer = 2.0 * act_width * dtype_bytes * 2.0 * (g - 1) / g
        return cls(per_layer * n_layers, n_layers)

    @classmethod
    def from_config(cls, cfg, group_size: int,
                    dtype_bytes: int = 2) -> "CollectiveVolumeModel":
        """Analytic volume for a ModelConfig (the serving runtime)."""
        return cls.analytic(cfg.n_layers, cfg.d_model, group_size,
                            dtype_bytes)

    @classmethod
    def from_spec(cls, spec, group_size: int,
                  dtype_bytes: int = 2) -> "CollectiveVolumeModel":
        """Analytic volume for a ModelSimSpec (the simulator)."""
        return cls.analytic(spec.n_layers,
                            max(spec.n_heads * spec.qk_head_dim, 1),
                            group_size, dtype_bytes)
