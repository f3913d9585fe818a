"""Training data: synthetic token streams and the bitmap corpus filter
(the counterpart of `repro.data`)."""
from repro_torch.data.bitmap_filter import CorpusCatalog, build_filter
from repro_torch.data.pipeline import SyntheticLM, host_shard

__all__ = ["SyntheticLM", "host_shard", "CorpusCatalog", "build_filter"]
