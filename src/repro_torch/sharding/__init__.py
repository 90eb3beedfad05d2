"""Sharding of the port's trainer over a device mesh: placement rules
(``rules``), the step-time mesh contexts (``ctx``), collectives with their
gradients (``comm``) and a model held as this rank's shards (``fsdp``)."""

from repro_torch.sharding.rules import (  # noqa: F401
    P,
    batch_spec,
    data_axes,
    opt_state_pspecs,
    param_pspecs,
    pool_shard_devices,
    token_pspec,
)
