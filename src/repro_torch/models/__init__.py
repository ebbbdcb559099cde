from repro_torch.models.decoder import DecoderLM, build_model

__all__ = ["DecoderLM", "build_model"]
