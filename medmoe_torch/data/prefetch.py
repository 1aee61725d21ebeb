"""Background-thread batch prefetch: overlap host work with device compute.

The reference overlaps input preparation with GPU compute through
DataLoader worker processes (reference configs/data/unimed.yaml
num_workers: 5, src/data/unimed_datamodule.py:82-122). Here images are
decoded in-line in a generator (the serve CLI's waves), so without
prefetch the card idles while the host prepares the next batch: the host
cannot start decoding batch i+1 until it has *pulled* it from the
generator, which only happens after batch i's work returns.

``prefetch`` runs the loader generator on a daemon thread, ``depth``
batches ahead, behind a bounded queue. The optional ``transform`` (e.g. image
decode for a serving wave) also runs on the worker thread, so host work
for batch i+1 rides alongside the device's work on batch i instead of
serializing with it.

Early exit is safe: closing the generator (or a break in the consuming
for-loop, which triggers GeneratorExit) signals the worker to stop and
waits for it (up to ``JOIN_TIMEOUT_S``) to finish the item in hand and
close its source, so a truncated epoch (limit_train_batches, preemption)
leaves no thread behind: neither one blocked on a full queue nor one still
inside torch or PIL when the interpreter exits (a daemon thread running
C++ code at exit aborts the process).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

__all__ = ["prefetch"]

_SENTINEL = object()
JOIN_TIMEOUT_S = 60.0


class _WorkerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable, depth: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Yield from ``iterable``, produced ``depth`` items ahead on a
    background thread. ``transform`` is applied on the worker thread.

    depth <= 0 disables prefetching (synchronous passthrough) — useful to
    keep one code path in callers with a config knob.
    """
    if depth <= 0:
        for item in iterable:
            yield transform(item) if transform is not None else item
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def worker():
        it = None
        try:
            # inside the try: an __iter__ that raises (e.g. missing shard
            # files opened there) must surface as _WorkerError, not kill
            # the thread silently and deadlock the consumer's q.get()
            it = iter(iterable)
            while True:
                # check stop BEFORE pulling: a consumer that exited early
                # shouldn't trigger one more (possibly expensive) decode.
                # A source blocked inside next() (shard fetch, IO) still
                # runs until its next item — documented limitation.
                if stop.is_set():
                    return
                try:
                    item = next(it)
                except StopIteration:
                    _put_final(_SENTINEL)
                    return
                if transform is not None:
                    item = transform(item)
                # bounded-wait put so a stopped consumer can't strand us
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as exc:    # propagate to the consumer
            _put_final(_WorkerError(exc))
        finally:
            # release the source's resources (file handles, decode pools)
            # promptly instead of waiting for GC — generators expose close()
            close = getattr(it, "close", None) if it is not None else None
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def _put_final(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    thread = threading.Thread(target=worker, daemon=True,
                              name="medmoe-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        if thread is not threading.current_thread():
            thread.join(JOIN_TIMEOUT_S)
