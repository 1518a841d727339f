"""predict.mfu: the whole request's share of the card's peak in the traced
stretch: each request's least time (its parts' bytes or operations at the
peaks, ``predict.request_work``) times the requests traced, over the traced
seconds."""


def read(obs):
    w = obs.get("window")
    if w is None or not obs.get("traced_requests") or w.wall_s <= 0:
        return None
    return 100.0 * obs["work"]["request_s"] * obs["traced_requests"] \
        / w.wall_s
