"""predict.hop_ms: device milliseconds of one hop, the port's span
``infer.propagate.hop`` (the int8 forms' quantize included), the median
over every hop of the traced requests."""

from benchmark.program_spans import median, records


def read(obs):
    recs = records(obs, "infer.propagate.hop")
    return None if recs is None else median(r["device_ms"] for r in recs)
