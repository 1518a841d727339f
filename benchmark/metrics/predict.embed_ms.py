"""predict.embed_ms: device milliseconds of K3's node form over every node
(``embed_all_nodes`` inside ``predict_logits_sparse``), from CUDA events,
the median over the window's requests; MAG cells only."""

import statistics


def read(obs):
    spans = obs["spans_ms"].get("embed")
    if obs.get("window") is None or not spans:
        return None
    return statistics.median(spans)
