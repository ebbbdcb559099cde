from repro_torch.configs.registry import ARCH_IDS, get_config, smoke_config
from repro_torch.configs.shapes import SHAPES, ShapeCfg, cell_applicable

__all__ = ["ARCH_IDS", "SHAPES", "ShapeCfg", "cell_applicable", "get_config",
           "smoke_config"]
