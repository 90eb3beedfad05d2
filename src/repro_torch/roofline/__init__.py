"""Roofline of the port's sharded steps (twin of ``repro/roofline``):
``analytic`` (the napkin FLOP / HBM-byte model) and ``analysis`` (the
three-term report with H100 constants).

The reference's ``hlo_parse.py`` has no counterpart.  It multiplies the
collectives of XLA's ``while`` bodies by their trip counts, since a scanned
layer stack's HLO holds its collectives once.  The port has no HLO and no
scanned layer body: every collective is an explicit call in
``sharding/comm.py``, and the dry run's tally (``comm.tally``) counts each
call once, as it runs.
"""

from repro_torch.roofline.analysis import (  # noqa: F401
    HBM_BW,
    LINK_BW,
    PEAK_FLOPS,
    RooflineReport,
    active_params,
    analyze,
    count_params,
    model_flops,
)
