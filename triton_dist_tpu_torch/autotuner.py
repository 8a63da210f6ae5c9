"""Contextual autotuner for whole multi-kernel distributed ops.

Counterpart of ``triton_dist_tpu/autotuner.py``, itself the analog of the
Triton-distributed ``contextual_autotune``: a *whole op* (which may call
several autotuned functions, each needing the op's surrounding context:
symmetric buffers, barriers, the world) is re-run until every inner
tuner's config sweep completes, one (config, iteration) step per outer
call, so the tuners of one op sweep in lockstep; in ``is_dist`` mode the
times are MAX-reduced across processes so every process picks the same
config.  The same rules as the reference:

- a config is a plain dict of keyword overrides merged into the wrapped
  function's kwargs (:func:`Config`);
- a config that raises is skipped; when every config raises, the sweep
  raises RuntimeError with the last cause chained;
- winners are cached per key: the ``key`` kwargs, the shape and dtype of
  every tensor argument, and every other kwarg as its ``str`` (a scalar
  kwarg splits entries);
- an aborted region purges its unfinished sweeps, so it cannot poison the
  next region;
- ``prune(configs, args, kwargs)`` may drop configs per call, and a
  ``measure(fn, args, kwargs, config) -> (result, ms)`` hook replaces the
  timing.

Timing: when any tensor argument lies on a CUDA device, CUDA events on the
current stream around the call (the eager sweep makes a warm call first,
the contextual one drops its ``n_warmup`` iterations); otherwise
``time.perf_counter`` around the call.  ``is_dist`` MAX-reduces only over
a ``torch.distributed`` group of more than one process; on the port's
one-process virtual world it is the identity, as the reference's
single-host path is (``jax.process_count() == 1``).  Each process logs to
``<log_dir>/rank-<i>.log``.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

__all__ = ["autotune", "contextual_autotune", "Config", "AutotunedFunction",
           "ContextualAutotuner"]


def Config(**kwargs) -> dict:
    """A tunable config: keyword overrides for the wrapped function."""
    return dict(kwargs)


def _process_group():
    """(rank, world size) of the initialized ``torch.distributed`` group,
    (0, 1) without one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _allreduce_max(times: Sequence[float]) -> list[float]:
    """MAX-reduce per-config times across processes (the identity in one
    process)."""
    _, n_proc = _process_group()
    if n_proc == 1:
        return list(times)
    t = torch.tensor(list(times), dtype=torch.float64)
    if torch.distributed.get_backend() == "nccl":
        t = t.cuda()
    torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX)
    return t.cpu().tolist()


def _tensors(args, kwargs):
    return [v for v in (*args, *kwargs.values())
            if isinstance(v, torch.Tensor)]


def _timed_call(fn, args, kwargs):
    """(result, milliseconds) of one call: CUDA events when a tensor
    argument is on the card, the host clock otherwise."""
    cuda = [t for t in _tensors(args, kwargs) if t.is_cuda]
    if cuda:
        with torch.cuda.device(cuda[0].device):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            ret = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            return ret, start.elapsed_time(end)
    t0 = time.perf_counter()
    ret = fn(*args, **kwargs)
    return ret, (time.perf_counter() - t0) * 1e3


class _TuningState:
    """Per-(tuner, key) sweep state."""

    def __init__(self, configs: list[dict]):
        self.configs = configs
        self.cfg_i = 0
        self.iter_j = 0
        self.cur_times: list[float] = []
        self.okay: list[tuple[int, dict]] = []
        self.times: list[float] = []
        self.finished = False


class ContextualAutotuner:
    """Callable wrapping a whole op; the active instance gates inner
    tuners."""

    _INSTANCE: "ContextualAutotuner | None" = None

    def __init__(self, fn: Callable, is_dist: bool = False, n_repeat: int = 5,
                 n_warmup: int = 3, log_dir: str = ".autotune_logs"):
        self.fn = fn
        self.is_dist = is_dist
        self.n_repeat = n_repeat
        self.n_warmup = n_warmup
        self.log_dir = log_dir
        self._log_file = None
        # (owner AutotunedFunction, cache key, state) per active sweep
        self._states: list[tuple] = []

    def log(self, *args):
        rank, _ = _process_group()
        if self._log_file is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._log_file = open(
                os.path.join(self.log_dir, f"rank-{rank}.log"), "a")
        print(f"[rank-{rank}]", *args, file=self._log_file, flush=True)

    def __call__(self, *args, **kwargs):
        if ContextualAutotuner._INSTANCE is not None:  # nested: run plainly
            return self.fn(*args, **kwargs)
        ContextualAutotuner._INSTANCE = self
        self._states = []
        try:
            ret = self.fn(*args, **kwargs)  # discovers the inner tuners
            if not self._states:
                return ret  # nothing to tune (all cached already)
            while not all(st.finished for _, _, st in self._states):
                ret = self.fn(*args, **kwargs)
            # the sweep's last call ran whatever config came last; one
            # more call runs every inner tuner's cached winner
            return self.fn(*args, **kwargs)
        finally:
            # purge unfinished sweeps from their owners, so an aborted
            # region cannot poison the next one with stale per-key state
            for owner, key, st in self._states:
                if not st.finished:
                    owner._states.pop(key, None)
            ContextualAutotuner._INSTANCE = None
            self._states = []
            if self._log_file is not None:   # reopened (append) next region
                self._log_file.close()
                self._log_file = None


def contextual_autotune(is_dist: bool = False, n_repeat: int = 5,
                        n_warmup: int = 3):
    """Decorator: tune every inner ``@autotune`` function within one op."""

    def decor(fn):
        return ContextualAutotuner(fn, is_dist=is_dist, n_repeat=n_repeat,
                                   n_warmup=n_warmup)

    return decor


class AutotunedFunction:
    """An ``@autotune``-wrapped function with a per-key best-config
    cache."""

    def __init__(self, fn: Callable, configs: Sequence[dict],
                 key: Sequence[str] = (), prune: Callable | None = None,
                 measure: Callable | None = None):
        self.fn = fn
        self.configs = [dict(c) for c in configs]
        self.key_names = tuple(key)
        self.prune = prune
        self.measure = measure
        self.cache: dict[tuple, dict] = {}
        # per key, [(config, ms), ...] of its finished sweep
        self.sweeps: dict[tuple, list] = {}
        self._states: dict[tuple, _TuningState] = {}
        self.__name__ = getattr(fn, "__name__", "autotuned")

    def _key(self, args, kwargs) -> tuple:
        """The key kwargs, the shape and dtype of every tensor argument,
        and every other kwarg (a scalar as its str)."""
        parts: list[Any] = [kwargs.get(k) for k in self.key_names]
        for a in args:
            if isinstance(a, torch.Tensor):
                parts.append((tuple(a.shape), str(a.dtype)))
        for k in sorted(kwargs):
            if k in self.key_names:
                continue
            v = kwargs[k]
            if isinstance(v, torch.Tensor):
                parts.append((tuple(v.shape), str(v.dtype)))
            else:
                parts.append((k, str(v)))
        return tuple(parts)

    def _configs_for(self, args, kwargs) -> list[dict]:
        if self.prune is None:
            return list(self.configs)
        pruned = self.prune(self.configs, args, kwargs)
        return list(pruned) if pruned else list(self.configs)

    def _run(self, args, kwargs, config):
        return self.fn(*args, **{**kwargs, **config})

    def _timed(self, args, kwargs, config) -> tuple[Any, float]:
        """(result, milliseconds) of one config's call."""
        if self.measure is not None:
            return self.measure(self.fn, args, kwargs, config)
        return _timed_call(self.fn, args, {**kwargs, **config})

    def __call__(self, *args, **kwargs):
        if len(self.configs) <= 1:
            cfg = self.configs[0] if self.configs else {}
            return self._run(args, kwargs, cfg)
        key = self._key(args, kwargs)
        best = self.cache.get(key)
        if best is not None:
            return self._run(args, kwargs, best)
        tuner = ContextualAutotuner._INSTANCE
        if tuner is None:
            return self._tune_eager(key, args, kwargs)
        return self._tune_step(tuner, key, args, kwargs)

    def _tune_eager(self, key, args, kwargs):
        """The whole sweep in one call (no cross-process agreement: eager
        calls need not be collective)."""
        configs = self._configs_for(args, kwargs)
        okay, times = [], []
        last = None
        last_exc = None
        for i, cfg in enumerate(configs):
            try:
                if self.measure is not None:
                    # custom hooks own their warm-up
                    last, ms = self._timed(args, kwargs, cfg)
                else:
                    for _ in range(2):  # a warm call, then the measured one
                        last, ms = self._timed(args, kwargs, cfg)
                okay.append((i, cfg))
                times.append(ms)
            except Exception as e:  # bad config; keep the cause
                last_exc = e
                continue
        if not okay:
            raise RuntimeError(
                f"{self.__name__}: no valid config among {configs}"
            ) from last_exc
        (_, best), _ = min(zip(okay, times), key=lambda t: t[-1])
        self.cache[key] = best
        self.sweeps[key] = [(cfg, ms) for (_, cfg), ms in zip(okay, times)]
        return self._run(args, kwargs, best)

    def _tune_step(self, tuner: ContextualAutotuner, key, args, kwargs):
        """One (config, iteration) step per call of the outer op."""
        st = self._states.get(key)
        if st is None:
            st = self._states[key] = _TuningState(
                self._configs_for(args, kwargs))
            tuner._states.append((self, key, st))

        n_iters = tuner.n_warmup + tuner.n_repeat
        while st.cfg_i < len(st.configs):
            cfg = st.configs[st.cfg_i]
            try:
                ret, ms = self._timed(args, kwargs, cfg)
                if ret is None:
                    # a measure hook may time a surrogate and return no
                    # result; the op still needs a real output
                    ret = self._run(args, kwargs, cfg)
            except Exception as e:  # bad config
                tuner.log(f"func: {self.__name__} | config {st.cfg_i} "
                          f"{cfg} | error: {e}")
                self._advance_config(tuner, key, ok=False)
                if st.finished:
                    return self._run(args, kwargs, self.cache[key])
                continue
            if st.iter_j >= tuner.n_warmup:
                st.cur_times.append(ms)
            tuner.log(f"func: {self.__name__} | config {st.cfg_i} {cfg} | "
                      f"iter {st.iter_j} | {ms:.4f} ms")
            st.iter_j += 1
            if st.iter_j >= n_iters:
                self._advance_config(tuner, key, ok=True)
            return ret
        raise AssertionError("unreachable")

    def _advance_config(self, tuner, key, ok: bool):
        st = self._states[key]
        if ok:
            st.okay.append((st.cfg_i, st.configs[st.cfg_i]))
            st.times.append(float(np.mean(st.cur_times)))
        st.cur_times = []
        st.iter_j = 0
        st.cfg_i += 1
        if st.cfg_i < len(st.configs):
            return
        # the sweep is complete: agree on the best config
        if not st.okay:
            raise RuntimeError(
                f"{self.__name__}: no valid config among {st.configs}")
        times = _allreduce_max(st.times) if tuner.is_dist else st.times
        (best_i, best), best_ms = min(
            zip(st.okay, times), key=lambda t: t[-1])
        tuner.log(f"func: {self.__name__} | best-config-id: {best_i} | "
                  f"best-config: {best} | best-latency: {best_ms:.4f} ms")
        self.cache[key] = best
        self.sweeps[key] = [(cfg, ms) for (_, cfg), ms in zip(st.okay,
                                                              times)]
        st.finished = True
        del self._states[key]

    @property
    def best_config(self) -> dict | None:
        """The most recently selected config (None before any tuning)."""
        return next(iter(reversed(self.cache.values())), None)


def autotune(configs: Sequence[dict], key: Sequence[str] = (),
             prune: Callable | None = None, measure: Callable | None = None):
    """Decorator marking a function tunable over ``configs``: config
    kwargs merge into the call's kwargs, later calls take the per-key
    cached winner.  ``prune(configs, args, kwargs)`` may drop redundant
    configs per call; ``measure(fn, args, kwargs, config) -> (ret, ms)``
    replaces the timing."""

    def decor(fn):
        return AutotunedFunction(fn, configs, key, prune, measure)

    return decor
