"""LM serving: the KV cache and the generation loop."""
from repro_torch.serve.kvcache import cache_bytes, extend_cache
from repro_torch.serve.step import generate, make_serve_step

__all__ = ["cache_bytes", "extend_cache", "generate", "make_serve_step"]
