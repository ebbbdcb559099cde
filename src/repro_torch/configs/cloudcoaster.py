"""The paper's own configuration (§4 Evaluation): the scheduler, not a NN.

Baseline cluster of 4000 on-demand servers, 80 reserved for short jobs
(N_s = 80); p = 0.5 of the short partition replaceable by transient servers;
cost ratio r in {1, 2, 3}; long-load-ratio threshold L_r^T = 0.95; transient
provisioning delay 120 s.
"""

from repro_torch.core.cluster import SimConfig

PAPER_SIM = SimConfig(
    n_servers=4000,
    n_short_reserved=80,
    replace_fraction=0.5,
    cost_ratio=3.0,
    threshold=0.95,
    provisioning_delay=120.0,
)

COST_RATIOS = (1.0, 2.0, 3.0)
