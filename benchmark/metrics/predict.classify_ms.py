"""predict.classify_ms: device milliseconds from the propagation's end to
the logits on the host (the chunked classifier and the copy), from CUDA
events, the median over the window's requests."""

import statistics


def read(obs):
    spans = obs["spans_ms"].get("classify")
    if obs.get("window") is None or not spans:
        return None
    return statistics.median(spans)
