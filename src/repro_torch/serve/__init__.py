"""The port's serving engine layer (twin of ``repro/serve``):

* ``DecodeEngine`` (``serve.engine``): the whole-generation engine, one
  cached entry a signature, greedy or sampled; ``launch.serve.generate``
  takes it for sampling or when handed one.
* ``ContinuousEngine`` (``serve.continuous``): the continuous-batching
  slot-pool engine, contiguous and paged, greedy or sampled, which
  ``launch.serve.generate`` rides by default; its device counters, the
  simulator bridge ``make_sim_server``.
* ``ShardedEngine`` (``serve.router``): one engine a shard behind an
  occupancy-aware router with the same engine surface.
* ``SLAScheduler`` (``serve.scheduler``): EDF-within-priority admission
  with preemption, expiry and bounded retry, in front of an engine or the
  router.
"""

from repro_torch.serve.continuous import (  # noqa: F401
    ContinuousEngine,
    PoolConfig,
    PoolExhausted,
    Request,
    build_request,
    clear_engines,
    engine_for,
    make_sim_server,
    padding_safe,
    pool_engine,
    pow2_bucket,
)
from repro_torch.serve.engine import (  # noqa: F401
    CompiledGenerate,
    DecodeEngine,
    default_engine,
    engine_generate,
    generate_key,
)
from repro_torch.serve.router import (  # noqa: F401
    ShardedEngine,
    clear_routers,
    shard_devices,
    sharded_engine,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    SLA,
    SLAScheduler,
    VirtualClock,
    protocol_feasibility,
)
