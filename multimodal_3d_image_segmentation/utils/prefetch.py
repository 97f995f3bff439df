"""Double-buffered host->device feeding.

While the device executes step N, the host decodes/augments batch N+1 (in
the multiprocess input pipeline) and ships it to device memory — the analog
of the reference's DataLoader worker prefetching, extended across the
host-to-device boundary. JAX transfers are async, so ``device_put`` on the *next* batch
overlaps with the current step's compute; this wrapper keeps ``depth``
batches in flight.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator

__all__ = ["device_prefetch"]


def device_prefetch(iterable: Iterable, put: Callable, depth: int = 2
                    ) -> Iterator:
    """Yield items from ``iterable`` with ``put`` (e.g. a sharded
    ``jax.device_put``) applied ``depth`` items ahead."""
    assert depth >= 1
    it = iter(iterable)
    buf = deque()

    def fill():
        try:
            buf.append(put(next(it)))
            return True
        except StopIteration:
            return False

    for _ in range(depth):
        if not fill():
            break
    while buf:
        out = buf.popleft()
        fill()
        yield out
