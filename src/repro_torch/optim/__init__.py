from repro_torch.optim.adam import (  # noqa: F401
    AdamConfig,
    AdamState,
    adam_update,
    global_norm,
    init_adam,
)
from repro_torch.optim import schedule  # noqa: F401
