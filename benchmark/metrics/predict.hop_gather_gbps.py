"""predict.hop_gather_gbps: the rate of a hop's gathers, GB/s: the port's
counter ``gather_bytes`` (the operator's nonzeros times the input row's
bytes, each gathered row counted whole whether or not it hit in L2) over
the device seconds of its span ``infer.propagate.hop``; the median over the
traced hops. L2 hits can lift it past the HBM rate, so it is a rate and
not a share of a roofline."""

from benchmark.program_spans import median, records


def read(obs):
    recs = records(obs, "infer.propagate.hop")
    if recs is None:
        return None
    return median(r["counts"]["gather_bytes"] / (r["device_ms"] * 1e6)
                  for r in recs
                  if r["device_ms"] and "gather_bytes" in r["counts"])
