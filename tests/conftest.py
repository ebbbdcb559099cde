# Multi-device CPU tests (sharding, shard_map MoE, elastic rescale, HLO
# parsing) need >1 device. 8 is enough for a (2,4) or (4,2) mesh and keeps
# single-device smoke tests unaffected (jit without a mesh uses device 0).
# NOTE: deliberately NOT 512 — only repro.launch.dryrun forces the production
# device count, and only in its own process.
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped (by a fixture) without one")
