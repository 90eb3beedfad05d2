"""The port's serving engine layer: the continuous-batching slot-pool
engine (``serve.continuous``), contiguous and paged, which
``launch.serve.generate`` rides.  The whole-generation ``DecodeEngine``,
the SLA scheduler and the sharded router wait for ROADMAP A7 and A8."""

from repro_torch.serve.continuous import (  # noqa: F401
    ContinuousEngine,
    PoolConfig,
    PoolExhausted,
    Request,
    build_request,
    clear_engines,
    engine_for,
    padding_safe,
    pool_engine,
    pow2_bucket,
)
