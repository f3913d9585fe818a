"""Synthetic training data (the counterpart of `repro.data`; the bitmap
corpus filter waits for ROADMAP §A9)."""
from repro_torch.data.pipeline import SyntheticLM, host_shard

__all__ = ["SyntheticLM", "host_shard"]
