from repro_torch.models.model import (
    append_step,
    decode_step,
    embed,
    forward,
    init_decode_state,
    lm_loss,
    logits_from_hidden,
)
from repro_torch.models.params import (
    count_params_analytic,
    init_params,
    model_schema,
)

__all__ = [
    "append_step", "decode_step", "embed", "forward", "init_decode_state",
    "lm_loss", "logits_from_hidden", "count_params_analytic", "init_params",
    "model_schema",
]
