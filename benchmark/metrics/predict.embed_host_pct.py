"""predict.embed_host_pct: the host's share of K3's node form over every
node, 100 x host ms / device ms of the port's span ``infer.embed``, the
median over the traced requests; near 100 the host's dispatch of the
chunks sets the pace, far below it the kernels do. MAG cells only."""

from benchmark.program_spans import median, records


def read(obs):
    recs = records(obs, "infer.embed")
    if recs is None:
        return None
    return median(100.0 * r["host_ms"] / r["device_ms"] for r in recs
                  if r["device_ms"])
