"""predict.copy_gbps: the logits' copy to the host, GB/s: the port's counter
``copy_bytes`` (the host array's bytes) over the device seconds of its span
``infer.classify.copy``, from where the stream reaches the copy to the
host array's existence; the median over the traced requests. The span's
host seconds would also hold the wait for the classifier's kernels, which
``.cpu()`` blocks on."""

from benchmark.program_spans import median, records


def read(obs):
    recs = records(obs, "infer.classify.copy")
    if recs is None:
        return None
    return median(r["counts"]["copy_bytes"] / (r["device_ms"] * 1e6)
                  for r in recs
                  if r["device_ms"] and "copy_bytes" in r["counts"])
