from repro_torch.traces.synthetic import google_like, yahoo_like  # noqa: F401
from repro_torch.workload.builders import (diurnal_like, flash_crowd_like,  # noqa: F401
                                     multi_tenant, poisson_like)
