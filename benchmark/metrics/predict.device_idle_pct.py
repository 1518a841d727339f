"""predict.device_idle_pct: the share of the traced stretch of requests in
which no operation ran on the device (torch.profiler's device activity)."""


def read(obs):
    w = obs.get("window")
    if w is None or not w.ops or w.wall_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - w.busy_s() / w.wall_s)
