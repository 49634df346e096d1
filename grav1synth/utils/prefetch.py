"""Bounded background iteration for host/device pipeline overlap.

SURVEY §2 P1 names pipeline parallelism — host-demux/decode →
device-apply → host-mux — as the third parallelism leg. The render and
diff pipelines use this to decode batch N+1 on a host thread while the
device runs batch N: the generator (typically a dav1d decode loop) is
drained by a daemon thread into a bounded queue, so the consumer's
blocking device waits no longer serialize against decode. Ordering is
preserved exactly (single producer, single FIFO), so pipeline outputs
stay byte-identical to the serial loop.

The reference has no analogue (its packet and dual-decode loops are
strictly sequential on one thread, grav1synth src/parser.rs:129-168,
src/main.rs:432-521).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator, TypeVar, Union

T = TypeVar("T")

_DONE = object()


class PrefetchIterator(Iterator[T]):
    """Iterate ``src`` on a background thread through a bounded queue.

    ``depth`` bounds the number of buffered items (frames are ~12 MB at
    4K10, so callers size this in batches). Exceptions raised by the
    producer re-raise at the consuming ``next()`` call. ``close()``
    stops the producer early (e.g. when the consumer errors); the
    thread is a daemon either way, so an abandoned iterator never
    blocks interpreter exit.
    """

    def __init__(self, src: Iterable[T], depth: int):
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(src,), daemon=True
        )
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, src) -> None:
        try:
            for item in src:
                if not self._put(item):
                    return
            self._put(_DONE)
        except BaseException as e:  # propagate to the consumer
            self._put(e)

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _DONE:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self) -> None:
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "PrefetchIterator[T]":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Passthrough(Iterator[T]):
    """Same interface, no thread — the serial fallback."""

    def __init__(self, src: Iterable[T]):
        self._it = iter(src)

    def __iter__(self):
        return self

    def __next__(self) -> T:
        return next(self._it)

    def close(self) -> None:
        pass


def maybe_prefetch(
    src: Iterable[T], depth: int
) -> Union["PrefetchIterator[T]", "_Passthrough[T]"]:
    """Thread the iterator only when the host has cores to spare.

    On a 2-core host the producer threads fight the decoder and the
    device transfers for CPU, and the threaded diff loop ran slower
    than the serial one there. With >= 4 cores the stages overlap and
    threading wins.
    GRAV1_PREFETCH=1/0 forces either mode."""
    env = os.environ.get("GRAV1_PREFETCH")
    if env is not None:
        use = env.strip().lower() not in ("0", "false", "no", "")
    else:
        use = (os.cpu_count() or 1) >= 4
    return PrefetchIterator(src, depth) if use else _Passthrough(src)
