"""The serving heap out of the cyclic collector's reach.

A process that serves searches holds a large heap that lives as long as
it does: the modules of torch and this package (~170,000 tracked
objects), the engine and its table.  None of it is ever garbage, yet
every full collection walks all of it, and a search's results, which
survive the younger generations until the caller drops them, set one off
every few requests.  Once an engine has built or loaded its index it
`settle`s: one `gc.collect()`, so that no garbage is kept, then
`gc.freeze()`, which moves every tracked object into the interpreter's
permanent generation, where no collection looks.  Reference counting
still frees a frozen object; only a cycle through one outlives it.  So
`release`, from the engine's close, drops the engine, and the last
engine released unfreezes the heap: what closed engines leave in cycles
is collectable again.

The permanent generation is one per process, so is this module's state:
the engines settled, by identity (each held weakly, and released when
it dies unclosed), and the number frozen at the last settle.
"""

from __future__ import annotations

import gc
import threading
import weakref
from typing import Dict

_lock = threading.RLock()     # a weakref callback may fire inside settle
_owners: Dict[int, weakref.ref] = {}
_frozen = 0


def settle(owner: object) -> int:
    """Collect, then freeze every tracked object; count `owner` (once,
    however often it settles).  Returns the number frozen."""
    global _frozen
    with _lock:
        gc.collect()
        gc.freeze()
        _frozen = gc.get_freeze_count()
        key = id(owner)
        if key not in _owners:
            _owners[key] = weakref.ref(owner, lambda _, k=key: _drop(k))
        return _frozen


def release(owner: object) -> None:
    """Drop `owner`; the last owner dropped unfreezes the heap."""
    _drop(id(owner))


def _drop(key: int) -> None:
    global _frozen
    with _lock:
        if _owners.pop(key, None) is not None and not _owners:
            gc.unfreeze()
            _frozen = 0


def frozen() -> int:
    """Objects frozen at the last settle; 0 while nothing is settled."""
    return _frozen
