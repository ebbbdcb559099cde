from repro_torch.data.pipeline import SyntheticBatches

__all__ = ["SyntheticBatches"]
