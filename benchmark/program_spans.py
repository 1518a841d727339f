"""The port's own spans (``grandtpu_torch.observe.span``), as the metric
readers of ``program_span`` metrics read them.

The port records a span only while a ``torch.profiler`` profile records,
so in a run its records are those of the traced stretch. A program that
records no spans (no ``observe.spans``) gives no reading.
"""

import statistics


def records(obs: dict, name: str):
    """The records of the port's span ``name`` in the traced stretch, each
    a dict of ``observe.spans()``; None when the run was not traced or the
    program recorded no such span."""
    if obs.get("window") is None:
        return None
    from grandtpu_torch import observe

    read = getattr(observe, "spans", None)
    if read is None:
        return None
    return [r for r in read() if r["name"] == name] or None


def median(values):
    """The median of the values that are not None; None when none is."""
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None
