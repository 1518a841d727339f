"""Faults planted under the timed path, to see ``correct`` come out false:

- ``altered_answer``: one logit of every prediction is altered where it is
  produced (the dense engine's ``predict_logits``, the MAG engine's
  ``head_logits``, which ``predict_logits_sparse`` calls);
- ``stale_answer``: the propagation returns its first result on every
  later call, as a cache that misses the updates would.
"""

from __future__ import annotations

import contextlib

FAULTS = ("altered_answer", "stale_answer")


def _altered(original):
    def logits(*args, **kwargs):
        out = original(*args, **kwargs)
        out[0, 0] += 1.0 + abs(float(out[0, 0]))
        return out
    return logits


def _stale(original):
    first = []

    def call(self, *args, **kwargs):
        if not first:
            first.append(original(self, *args, **kwargs).clone())
        return first[0].clone()
    return call


@contextlib.contextmanager
def planted(name: str):
    """The port patched with fault ``name`` inside."""
    from grandtpu_torch.infer import classify, propagate

    if name == "altered_answer":
        targets = [(classify, "predict_logits", _altered),
                   (classify, "head_logits", _altered)]
    elif name == "stale_answer":
        targets = [(propagate.Propagator, "__call__", _stale)]
    else:
        raise ValueError(f"unknown fault {name!r}")
    originals = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in targets]
    for obj, attr, make in targets:
        setattr(obj, attr, make(getattr(obj, attr)))
    try:
        yield
    finally:
        for obj, attr, fn in originals:
            setattr(obj, attr, fn)
