"""Spans around the program's op wrappers, for the traced run only.

Every function of the program's ``ops`` modules that carries a ``launches``
counter is an op wrapper. ``OpTap`` replaces each, in every loaded module of
the program that holds it by name, with a function that opens the profiler
range ``port_bench.op::<wrapper>`` around the call and, while ``active``,
keeps the call's FLOPs and bytes from ``counts/<wrapper>.py``. The profiler
then ties each kernel to the wrapper call that launched it, the backward's
too (the autograd functions call the wrappers by name). ``restore`` puts
the originals back.
"""

from __future__ import annotations

import functools
import sys
from typing import Callable, Dict, List

from port_bench import trace as tr
from port_bench.common import PROGRAM


def op_wrappers() -> Dict[str, Callable]:
    """name -> function of every launch-counted wrapper in the loaded ops modules."""
    out = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod is None or not mod_name.startswith(PROGRAM + ".ops."):
            continue
        for attr, fn in vars(mod).items():
            if callable(fn) and hasattr(fn, "launches") and getattr(fn, "__module__", "") == mod_name:
                out[attr] = fn
    return out


class OpTap:
    def __init__(self, counts: Dict[str, object]):
        import torch

        self._rf = torch.profiler.record_function
        self.counts = counts
        self.active = False
        self.calls: Dict[str, List[tuple]] = {}
        self.uncounted: Dict[str, int] = {}
        self._patched: List[tuple] = []
        for name, fn in op_wrappers().items():
            tapped = self._wrap(name, fn)
            for mod_name, mod in list(sys.modules.items()):
                if mod is None or not mod_name.startswith(PROGRAM):
                    continue
                if vars(mod).get(name) is fn:
                    self._patched.append((mod, name, fn))
                    setattr(mod, name, tapped)

    def _wrap(self, name: str, fn: Callable) -> Callable:
        count = self.counts.get(name)
        label = tr.OP_PREFIX + name

        @functools.wraps(fn)
        def tapped(*args, **kwargs):
            with self._rf(label):
                out = fn(*args, **kwargs)
            if self.active:
                if count is None:
                    self.uncounted[name] = self.uncounted.get(name, 0) + 1
                else:
                    self.calls.setdefault(name, []).append(count.count(*args, **kwargs))
            return out

        tapped.launches = fn.launches
        return tapped

    def restore(self) -> None:
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self._patched = []
