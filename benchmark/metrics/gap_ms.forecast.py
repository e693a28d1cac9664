"""Host time from one forecast's outputs being ready to the next
forecast's call returning, its replay launched: what the closed loop adds
between two forecasts. Mean over the window (host clock)."""


def read(obs: dict):
    if obs["kind"] != "forecast" or not obs.get("gap_s"):
        return None
    return 1e3 * sum(obs["gap_s"]) / len(obs["gap_s"])
