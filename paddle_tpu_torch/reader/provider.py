"""PyDataProvider2 compatibility — the v1 data-provider protocol; the
port of ``paddle_tpu/reader/provider.py`` (host-only Python, the same
code).

Reference: python/paddle/trainer/PyDataProvider2.py:365 `@provider`
decorates a generator `process(settings, filename)` yielding per-sample
values; the trainer instantiates it per file from
`define_py_data_sources2` with optional shuffling pool and caching.

Here the decorated provider adapts onto the v2 reader protocol (the
framework's native path): `provider_reader(process, file_list)` returns a
zero-arg reader factory usable with paddle.reader.batch / SGD.train, with
CacheType.CACHE_PASS_IN_MEM materializing samples once and should_shuffle
mapped onto reader.shuffle's buffered pool.
"""

from __future__ import annotations

import random
from typing import Any, Callable, List, Optional, Sequence, Union

# re-export the v2 InputTypes under their PyDataProvider2 names so v1
# configs import everything from one place
from paddle_tpu_torch.core.data_type import (InputType, SeqType,  # noqa: F401
                                       dense_vector, dense_vector_sequence,
                                       dense_vector_sub_sequence,
                                       integer_value, integer_value_sequence,
                                       integer_value_sub_sequence,
                                       sparse_binary_vector,
                                       sparse_float_vector)


class SequenceType:
    NO_SEQUENCE = SeqType(0)
    SEQUENCE = SeqType(1)
    SUB_SEQUENCE = SeqType(2)


class CacheType:
    NO_CACHE = 0
    CACHE_PASS_IN_MEM = 1


class _ProviderSettings:
    """The `settings` object handed to process(); init_hook may hang
    arbitrary state (slots, dictionaries) off it, as the reference allows."""

    def __init__(self, input_types, **kwargs):
        self.input_types = input_types
        self.slots = input_types
        for k, v in kwargs.items():
            setattr(self, k, v)


class DataProvider:
    """A decorated provider function plus its protocol options."""

    def __init__(self, generator, input_types, should_shuffle, pool_size,
                 cache, init_hook, check):
        self.generator = generator
        self.input_types = input_types
        self.should_shuffle = should_shuffle
        self.pool_size = pool_size
        self.cache = cache
        self.init_hook = init_hook
        self.check = check
        self.__name__ = getattr(generator, "__name__", "provider")

    def settings(self, **hook_kwargs) -> _ProviderSettings:
        s = _ProviderSettings(self.input_types, **hook_kwargs)
        if self.init_hook is not None:
            self.init_hook(s, **hook_kwargs)
        return s

    def __call__(self, settings, filename):
        return self.generator(settings, filename)


def provider(input_types=None, should_shuffle=None, pool_size=-1,
             min_pool_size=-1, can_over_batch_size=True,
             calc_batch_size=None, cache=CacheType.NO_CACHE,
             check=False, check_fail_continue=False, init_hook=None,
             **outter_kwargs):
    """`@provider(input_types=..., cache=...)` — PyDataProvider2.py:365.

    The decorated `process(settings, filename)` generator becomes a
    DataProvider; feed it to provider_reader() (or SGD.train via
    define_py_data_sources2) to train.
    """

    def wrapper(fn):
        return DataProvider(fn, input_types, should_shuffle,
                            pool_size if pool_size > 0 else min_pool_size,
                            cache, init_hook, check)

    return wrapper


def provider_reader(p: Union[DataProvider, Callable],
                    file_list: Union[str, Sequence[str]],
                    **hook_kwargs) -> Callable:
    """Adapt a @provider onto the v2 reader protocol.

    file_list: list of filenames, or a path to a text file with one
    filename per line (the reference's train.list / test.list contract).
    """
    assert isinstance(p, DataProvider), \
        "provider_reader needs an @provider-decorated function"
    if isinstance(file_list, str):
        with open(file_list) as f:
            files: List[str] = [ln.strip() for ln in f if ln.strip()]
    else:
        files = list(file_list)

    cached: Optional[List[Any]] = None

    def reader():
        nonlocal cached
        if cached is not None:
            samples = cached
            if p.should_shuffle in (None, True):
                samples = list(samples)
                random.shuffle(samples)
            yield from samples
            return
        settings = p.settings(**hook_kwargs)
        out: List[Any] = [] if p.cache == CacheType.CACHE_PASS_IN_MEM else None
        if p.should_shuffle in (None, True):
            # reference semantics: shuffle by default; pool_size <= 0 means
            # an UNBOUNDED pool (whole pass buffered then shuffled)
            pool_cap = p.pool_size if p.pool_size and p.pool_size > 0 \
                else float("inf")
            pool: List[Any] = []
            for fname in files:
                for sample in p(settings, fname):
                    pool.append(sample)
                    if len(pool) >= pool_cap:
                        random.shuffle(pool)
                        for s in pool:
                            if out is not None:
                                out.append(s)
                            yield s
                        pool = []
            random.shuffle(pool)
            for s in pool:
                if out is not None:
                    out.append(s)
                yield s
        else:
            for fname in files:
                for sample in p(settings, fname):
                    if out is not None:
                        out.append(sample)
                    yield sample
        if out is not None:
            cached = out

    return reader


def define_py_data_sources2(train_list, test_list, module, obj,
                            args=None) -> dict:
    """Config-level helper (reference config_parser define_py_data_sources2):
    resolve `module.obj` providers and return v2 readers for each split."""
    import importlib

    if isinstance(module, str):
        module = importlib.import_module(module)
    prov = getattr(module, obj) if isinstance(obj, str) else obj
    kwargs = dict(args or {})
    out = {}
    if train_list is not None:
        out["train"] = provider_reader(prov, train_list, **kwargs)
    if test_list is not None:
        out["test"] = provider_reader(prov, test_list, **kwargs)
    return out
