"""Multi-tenant SLO & fairness layer (ROADMAP item 4; BoPF, Le et al. 2019).

One elastic fleet, many competing user populations: :mod:`tenancy.spec`
declares who the tenants are (arrival shape, job mix, SLO target, burst
credits), :mod:`tenancy.admission` enforces the token-bucket credit
economy and tracks live SLO headroom, :mod:`tenancy.metrics` turns
per-tenant waits into the ``tenant/<name>/*`` RunResult metrics and the
Jain fairness index. The ``multi_tenant`` trace builder
(``repro_torch.workload.builders``) and the ``tenant_guard`` policy
(``repro_torch.sched.policy``) are the workload- and sched-side entry points.
"""

from repro_torch.tenancy.admission import (TenancyState, TenantCredits,  # noqa: F401
                                     TokenBucket)
from repro_torch.tenancy.metrics import jain_index, tenant_metric_block  # noqa: F401
from repro_torch.tenancy.spec import (TENANT_SETS, TenantSet,  # noqa: F401
                                TenantSpec, get_tenant_set,
                                register_tenant_set, tenant_set_names)
