"""Paper §8 applications: bitmap indices, BitWeaving scans, bitvector sets."""
from repro_torch.apps.cost import DEFAULT_APP_SYSTEM, AppSystem

__all__ = ["AppSystem", "DEFAULT_APP_SYSTEM"]
