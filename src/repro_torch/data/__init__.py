from .pipeline import DataConfig, SyntheticLM, make_batch_shapes

__all__ = ["DataConfig", "SyntheticLM", "make_batch_shapes"]
