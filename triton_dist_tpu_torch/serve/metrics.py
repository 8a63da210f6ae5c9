"""Serving metrics: per-request latencies + engine-level counters.

Counterpart of ``triton_dist_tpu/serve/metrics.py``: :class:`RequestMetrics`
(copied whole) and the part of ``ServeMetrics`` the core engine touches —
TTFT / ITL / queue / step histograms, the prefill / decode token and step
counters, the streaming per-step gauges, the KV pool capacity view
(:meth:`ServeMetrics.kv_stats`) and :meth:`ServeMetrics.summary`.
The compilation, speculative, recovery, migration, network, SLO-class and
Prometheus views wait for the planes that feed them (ROADMAP Queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from triton_dist_tpu_torch.serve.trace import LogHistogram

#: Recent token timestamps one request retains (the bounded window
#: behind ``inter_token_latencies``; full distributions live in the
#: engine-level histograms).
TOKEN_TIMES_WINDOW = 256

#: Retired requests ``ServeMetrics.requests`` keeps before pruning the
#: oldest (per-request detail only; counters and histograms keep going).
REQUESTS_RETAIN = 4096


@dataclass
class RequestMetrics:
    """Timestamps (engine clock) and derived latencies for one request."""

    arrival_time: float
    first_scheduled_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # recent token timestamps only (bounded: a long stream must not grow
    # host memory); times_dropped counts the forgotten prefix, so
    # n_tokens and index math stay exact
    token_times: list[float] = field(default_factory=list)
    times_dropped: int = 0
    # queue-time histogram guard: only the FIRST admission's wait feeds
    # hist_queue (a preempted request's re-admissions would re-observe it)
    queue_observed: bool = False
    n_preemptions: int = 0
    # prompt tokens covered by shared cached blocks at admission (the
    # prefix cache is not ported yet, so this stays 0 here)
    cached_prefix_tokens: int = 0

    def on_scheduled(self, now: float) -> None:
        if self.first_scheduled_time is None:
            self.first_scheduled_time = now

    def on_token(self, now: float) -> Optional[float]:
        """Record one emission; returns the inter-token latency this
        token closes (``None`` for the first token)."""
        itl = (now - self.token_times[-1]) if self.token_times else None
        if self.first_token_time is None:
            self.first_token_time = now
            itl = None
        self.token_times.append(now)
        extra = len(self.token_times) - TOKEN_TIMES_WINDOW
        if extra > 0:
            del self.token_times[:extra]
            self.times_dropped += extra
        return itl

    @property
    def n_tokens(self) -> int:
        return self.times_dropped + len(self.token_times)

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival → first emission)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def queue_time(self) -> Optional[float]:
        if self.first_scheduled_time is None:
            return None
        return self.first_scheduled_time - self.arrival_time

    @property
    def inter_token_latencies(self) -> list[float]:
        t = self.token_times
        return [b - a for a, b in zip(t, t[1:])]

    @property
    def mean_itl(self) -> Optional[float]:
        itl = self.inter_token_latencies
        return sum(itl) / len(itl) if itl else None

    def to_dict(self) -> dict:
        return {
            "arrival_time": self.arrival_time,
            "ttft": self.ttft,
            "queue_time": self.queue_time,
            "mean_itl": self.mean_itl,
            "n_tokens": self.n_tokens,
            "n_preemptions": self.n_preemptions,
            "cached_prefix_tokens": self.cached_prefix_tokens,
            "finish_time": self.finish_time,
        }


@dataclass
class ServeMetrics:
    """Engine-level counters + streaming per-step gauges."""

    steps: int = 0
    decode_steps: int = 0
    prefill_tokens: int = 0
    preemptions: int = 0
    completed: int = 0
    decode_tokens: int = 0        # tokens committed by the decode loop
    dispatches: int = 0           # decode-path device dispatches
    host_syncs: int = 0           # decode-path host sync points
    callback_errors: int = 0      # on_token / on_finish raised
    finish_reasons: dict = field(default_factory=dict)
    queue_depth_last: int = 0
    queue_depth_peak: int = 0
    running_last: int = 0
    running_sum: int = 0
    kv_util_last: float = 0.0
    kv_util_peak: float = 0.0
    kv_util_sum: float = 0.0
    kv_pool_bytes: int = 0        # device bytes pinned by the KV pools
    kv_token_slots: int = 0       # num_blocks * page_size token capacity
    kv_quant: bool = False        # int8 pools (+ f32 scale planes)
    hist_ttft: LogHistogram = field(default_factory=LogHistogram,
                                    repr=False)
    hist_itl: LogHistogram = field(default_factory=LogHistogram,
                                   repr=False)
    hist_queue: LogHistogram = field(default_factory=LogHistogram,
                                     repr=False)
    hist_step: LogHistogram = field(default_factory=LogHistogram,
                                    repr=False)
    requests: dict = field(default_factory=dict)
    requests_retain: Optional[int] = REQUESTS_RETAIN

    def observe_step(self, *, queue_depth: int, running: int,
                     kv_utilization: float) -> None:
        self.steps += 1
        self.queue_depth_last = queue_depth
        self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)
        self.running_last = running
        self.running_sum += running
        self.kv_util_last = kv_utilization
        self.kv_util_sum += kv_utilization
        self.kv_util_peak = max(self.kv_util_peak, kv_utilization)

    def set_kv_capacity(self, *, pool_bytes: int, token_slots: int,
                        quantized: bool) -> None:
        """Stamp the engine's KV pool geometry (the engine calls this at
        construction, right after allocating pools): resident device
        bytes across every pool tensor (int8 pages and their f32 scales
        both count), the token slots those bytes buy
        (``num_blocks * page_size``), and whether the pools are
        quantized."""
        self.kv_pool_bytes = int(pool_bytes)
        self.kv_token_slots = int(token_slots)
        self.kv_quant = bool(quantized)

    def kv_stats(self) -> dict:
        """KV pool capacity (``summary()["kv"]``): pool bytes, token
        slots, bytes per token, quantized."""
        return {
            "pool_bytes": self.kv_pool_bytes,
            "token_slots": self.kv_token_slots,
            "bytes_per_token": (self.kv_pool_bytes / self.kv_token_slots
                                if self.kv_token_slots else 0.0),
            "quantized": self.kv_quant,
        }

    def observe_finish(self, request_id: str, rm: RequestMetrics,
                       reason=None) -> None:
        self.completed += 1
        self.requests[request_id] = rm
        if self.requests_retain is not None:
            while len(self.requests) > self.requests_retain:
                del self.requests[next(iter(self.requests))]
        if reason is not None:
            key = getattr(reason, "value", str(reason))
            self.finish_reasons[key] = self.finish_reasons.get(key, 0) + 1

    def decode_stats(self) -> dict:
        """Decode-loop dispatch economics: one dispatch per step emits a
        token per active row."""
        return {
            "decode_steps": self.decode_steps,
            "decode_tokens": self.decode_tokens,
            "dispatches": self.dispatches,
            "host_syncs": self.host_syncs,
            "tokens_per_dispatch": (self.decode_tokens / self.dispatches
                                    if self.dispatches else 0.0),
            "dispatches_per_token": (self.dispatches / self.decode_tokens
                                     if self.decode_tokens else 0.0),
        }

    def latency_stats(self) -> dict:
        return {
            "ttft": self.hist_ttft.stats(),
            "itl": self.hist_itl.stats(),
            "queue": self.hist_queue.stats(),
            "step": self.hist_step.stats(),
        }

    def summary(self) -> dict:
        """Aggregate view (what the CLI prints)."""
        if self.hist_ttft.count:
            mean_ttft, max_ttft = self.hist_ttft.mean, self.hist_ttft.max
        else:
            ttfts = [m.ttft for m in self.requests.values()
                     if m.ttft is not None]
            mean_ttft = sum(ttfts) / len(ttfts) if ttfts else None
            max_ttft = max(ttfts) if ttfts else None
        if self.hist_itl.count:
            mean_itl = self.hist_itl.mean
        else:
            itls = [x for m in self.requests.values()
                    for x in m.inter_token_latencies]
            mean_itl = sum(itls) / len(itls) if itls else None
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "prefill_tokens": self.prefill_tokens,
            "preemptions": self.preemptions,
            "completed": self.completed,
            "finish_reasons": dict(self.finish_reasons),
            "max_queue_depth": self.queue_depth_peak,
            "mean_running": (self.running_sum / self.steps
                             if self.steps else 0.0),
            "peak_kv_utilization": self.kv_util_peak,
            "mean_kv_utilization": (self.kv_util_sum / self.steps
                                    if self.steps else 0.0),
            "mean_ttft": mean_ttft,
            "max_ttft": max_ttft,
            "mean_itl": mean_itl,
            "latency": self.latency_stats(),
            "decode": self.decode_stats(),
            "kv": self.kv_stats(),
            "requests": {rid: m.to_dict()
                         for rid, m in self.requests.items()},
        }
