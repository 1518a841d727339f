"""predict.head_ms: device milliseconds of the port's span
``infer.classify.head`` (the classifier's chunks and their concatenation,
the logits still on the card), the median over the traced requests."""

from benchmark.program_spans import median, records


def read(obs):
    recs = records(obs, "infer.classify.head")
    return None if recs is None else median(r["device_ms"] for r in recs)
