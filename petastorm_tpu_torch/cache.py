"""Row-group cache interface (the JAX package's ``petastorm_tpu/cache.py``).

A cache intercepts row-group loads in the reader workers: ``get(key,
fill)`` returns the cached value, or computes, stores and returns it.
:class:`~petastorm_tpu_torch.autotune.InMemoryRowGroupCache` is the one
cache the port has besides :class:`NullCache`.
"""
from __future__ import annotations


class CacheBase:
    def get(self, key, fill_cache_func):
        """Return the value for ``key``; on a miss call ``fill_cache_func()``,
        store its result and return it."""
        raise NotImplementedError

    def cleanup(self):
        """Release any resources held by the cache."""


class NullCache(CacheBase):
    """A cache that caches nothing (the default)."""

    def get(self, key, fill_cache_func):
        return fill_cache_func()
