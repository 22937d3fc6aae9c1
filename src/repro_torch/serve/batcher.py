"""Dynamic micro-batching request queue (the port of ``repro.serve.batcher``).

At serving row counts the per-launch dispatch cost rivals the kernel
itself, so N concurrent requests dispatched naively pay it N times — the
same failure mode ``repro_torch.batch`` fixes for many-problem *fits*, here
fixed for *requests*. The :class:`MicroBatcher` coalesces whatever arrived
inside the batching window into one row-concatenated batch, hands it to a
single dispatch call, and scatters the result rows back to each caller's
ticket.

The batcher is generic over the dispatch function: any callable taking
the concatenated ``(rows, ...)`` batch and returning a tuple whose
row-shaped entries scatter per request (other entries — version tags,
detection counters — fan out to every ticket unchanged). The LM launcher
(``repro_torch.launch.serve``) and the k-means service
(``repro_torch.serve.service``) share it.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch


def _host_read(value: tuple) -> tuple:
    """The batcher's one sanctioned device->host sync: reading the
    *completed* batch back before the scatter, one ``.cpu()`` per device
    tensor of the dispatch tuple. Results are leaving for the callers
    anyway, and per-ticket device-side slicing would pay one eager
    dispatch per request per output. Host-side slices are views: the
    whole scatter costs one transfer per output."""
    return tuple(v.cpu() if isinstance(v, torch.Tensor) else v
                 for v in value)


class Ticket:
    """One submitted request's future result (thread-safe)."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Optional[tuple] = None
        self._error: Optional[BaseException] = None

    def _resolve(self, value: tuple) -> None:
        self._value = value
        self._event.set()

    def _reject(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> tuple:
        """Block until the request's micro-batch flushed; returns the
        scattered dispatch tuple for this request's rows."""
        if not self._event.wait(timeout):
            raise TimeoutError("micro-batch not flushed within timeout")
        if self._error is not None:
            raise self._error
        assert self._value is not None
        return self._value


def _concat_rows(xs: Sequence[Any]) -> Any:
    """Row-concatenate request payloads. All-host (numpy) requests
    assemble on the host — one memcpy, leaving the single device transfer
    to the dispatch call — mixed/device requests concatenate on the device
    of the first tensor among them."""
    if len(xs) == 1:
        return xs[0]
    if all(isinstance(x, np.ndarray) for x in xs):
        return np.concatenate(xs, axis=0)
    dev = next(x.device for x in xs if isinstance(x, torch.Tensor))
    return torch.cat([torch.as_tensor(x, device=dev) for x in xs], dim=0)


class MicroBatcher:
    """Coalesce concurrent requests into one dispatch call.

    ``submit`` enqueues a ``(rows, ...)`` payload and returns a
    :class:`Ticket`. ``flush`` drains the queue: one ``dispatch`` call on
    the concatenation, one host readback, then per-request numpy row
    views resolve the tickets.
    Call ``flush`` directly for deterministic single-threaded serving
    (tests, benchmarks), or ``start()`` a background loop that flushes
    ``window_s`` after each first arrival — the window is the latency the
    slowest-arriving request pays to share a launch, tuned alongside the
    bucket ladder (``repro_torch.serve.tuning.plan_ladder``).
    """

    def __init__(self, dispatch: Callable[[Any], tuple], *,
                 window_s: float = 0.0) -> None:
        self._dispatch = dispatch
        self.window_s = window_s
        self._cond = threading.Condition()
        self._pending: list[tuple[Any, Ticket]] = []
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    # -- queue -------------------------------------------------------------

    def submit(self, x: Any) -> Ticket:
        if x.ndim != 2:
            raise ValueError(f"requests are (rows, features) batches, got "
                             f"shape {tuple(x.shape)}")
        ticket = Ticket()
        with self._cond:
            self._pending.append((x, ticket))
            self._cond.notify_all()
        return ticket

    def flush(self) -> int:
        """Serve everything queued right now; returns the request count."""
        with self._cond:
            pending, self._pending = self._pending, []
        if not pending:
            return 0
        xs = [x for x, _ in pending]
        rows = [x.shape[0] for x in xs]
        total = sum(rows)
        try:
            out_h = _host_read(tuple(self._dispatch(_concat_rows(xs))))
        except BaseException as e:
            for _, ticket in pending:
                ticket._reject(e)
            raise
        offset = 0
        for (_, ticket), n in zip(pending, rows):
            ticket._resolve(tuple(
                o[offset:offset + n]
                if getattr(o, "ndim", 0) >= 1 and o.shape[0] == total
                else o
                for o in out_h))
            offset += n
        return len(pending)

    # -- background window loop --------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        if self.running:
            return
        self._stopping = False
        self._thread = threading.Thread(target=self._loop,
                                        name="repro-serve-microbatch",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop the window loop, flushing anything still queued."""
        thread = self._thread
        if thread is None:
            return
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        thread.join()
        self._thread = None
        self.flush()

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stopping:
                    self._cond.wait()
                if self._stopping:
                    return
            if self.window_s > 0:
                time.sleep(self.window_s)   # coalescing horizon
            try:
                self.flush()
            except Exception:
                # the tickets of the failed batch carry the error; the
                # loop keeps serving subsequent batches
                pass


__all__ = ["MicroBatcher", "Ticket"]
