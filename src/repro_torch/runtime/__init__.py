from repro_torch.runtime.serving import (ElasticServingFleet, Request,  # noqa: F401
                                         ServingFleetConfig,
                                         build_serving_workload)
