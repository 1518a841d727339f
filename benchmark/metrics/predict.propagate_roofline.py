"""predict.propagate_roofline: the propagation's least time (each hop's
operator, input, output and accumulator read or written once, at the HBM
rate) over the device time of the benchmark's call of the port's
``Propagator``, from CUDA events around it, the median over the window's
requests. Every device operation inside the call counts."""

import statistics


def read(obs):
    spans = obs["spans_ms"].get("propagate")
    if obs.get("window") is None or not spans:
        return None
    return 100.0 * obs["work"]["propagate_s"] * 1e3 / statistics.median(spans)
