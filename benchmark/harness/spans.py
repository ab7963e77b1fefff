"""Spans from outside the program: a callable of one of its modules is
wrapped, while the traced window runs, by CUDA events recorded on the
current stream before and after each call (the program is not changed),
and the inputs of its first calls may be kept. Times are read once the
window has closed and the device has been synchronised."""
from __future__ import annotations

import contextlib
import importlib

import torch


class Spans:
    """Wraps each span's (module, attribute) while in use; `ms` gives each
    span's event times in ms, `captured` a clone of one positional
    argument of its first calls, as `keep` {span: (calls, argument
    index)} asks."""

    def __init__(self, spec: dict, keep: dict | None = None):
        self.spec = spec                  # {span: (module, attribute)}
        self.keep = keep or {}
        self.events = {name: [] for name in spec}
        self.captured = {name: [] for name in spec}
        self.on = True

    def _wrap(self, name, fn):
        events, captured = self.events[name], self.captured[name]
        calls, index = self.keep.get(name, (0, 0))

        def spy(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            if len(captured) < calls:
                captured.append(args[index].detach().clone())
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events.append((a, b))
            return out
        return spy

    @contextlib.contextmanager
    def active(self):
        saved = []
        try:
            for name, (mod_name, attr) in self.spec.items():
                mod = importlib.import_module(mod_name)
                fn = getattr(mod, attr)
                saved.append((mod, attr, fn))
                setattr(mod, attr, self._wrap(name, fn))
            yield self
        finally:
            for mod, attr, fn in reversed(saved):
                setattr(mod, attr, fn)

    def ms(self) -> dict:
        """{span: [ms of each call]}; call after a synchronize."""
        return {name: [a.elapsed_time(b) for a, b in ev]
                for name, ev in self.events.items()}
