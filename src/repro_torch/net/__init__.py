"""The network layer of the port (twin of ``repro.net``):

    channels   packet-loss processes (i.i.d., Gilbert-Elliott, Markov
               fading, trace replay), numpy-stateful and functional on torch
    fec        XOR and Cauchy Reed-Solomon erasure codes over packets, and
               their channel-equivalent masks on the train/serve path
    protocol   unreliable, ARQ-with-deadline and hybrid FEC+ARQ policies
               with analytic latency PMFs (generalising Eq. 4-5)
    simulator  event-driven multi-client serving simulation
    chaos      scheduled fault injection over the simulator and the engine
    traces     record / load / synthesise loss traces
    evalhook   model accuracy under realized delivery masks
"""

from repro_torch.net.channels import (  # noqa: F401
    CHANNELS,
    Channel,
    FadingMarkovChannel,
    GilbertElliottChannel,
    IIDChannel,
    TraceChannel,
    gilbert_elliott_scan,
    make_channel,
)
from repro_torch.net.fec import (  # noqa: F401
    FECSpec,
    block_recovery_mask,
    decode,
    decode_floats,
    encode,
    encode_floats,
    fec_element_keep,
    residual_loss_rate,
)
from repro_torch.net.evalhook import (  # noqa: F401
    accuracy_per_request_masks,
    accuracy_vs_delivery_curve,
    accuracy_with_packet_masks,
    make_request_eval_fn,
    train_tiny_model,
)
from repro_torch.net.chaos import (  # noqa: F401
    ChaosSchedule,
    EngineChaos,
    Fault,
    block_pool_squeeze,
    burst_storm,
    channel_collapse,
    server_stall,
)
from repro_torch.net.protocol import (  # noqa: F401
    ARQProtocol,
    HybridFECARQProtocol,
    PROTOCOLS,
    RoundResult,
    UnreliableProtocol,
    deadline_feasible,
    make_protocol,
)
from repro_torch.net.simulator import (  # noqa: F401
    SimConfig,
    SimReport,
    accuracy_curve_fn,
    run_sim,
)
from repro_torch.net.traces import (  # noqa: F401
    load_trace,
    record_trace,
    save_trace,
    synthetic_burst_trace,
    trace_channel,
)
