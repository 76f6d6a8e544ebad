"""Model families + single-device training (GPT-2, Llama; dense path)."""

from dlrover_tpu_torch.models.config import (  # noqa: F401
    TransformerConfig,
    gpt2_small,
    gpt2_xl,
    llama2_7b,
    tiny,
)
from dlrover_tpu_torch.models.train import (  # noqa: F401
    TrainState,
    build_train_step,
    init_state,
)
from dlrover_tpu_torch.models.transformer import (  # noqa: F401
    Transformer,
    forward,
    init_params,
    loss_fn,
)
