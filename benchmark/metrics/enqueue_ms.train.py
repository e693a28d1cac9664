"""Host time of one call of the captured training step, from its call to
its return, without waiting for the device: the copy of the batch into
the graph's inputs, the replay's launch and the loss's copy. Mean over
the window (host clock)."""


def read(obs: dict):
    if obs["kind"] != "train" or not obs.get("enqueue_s"):
        return None
    return 1e3 * sum(obs["enqueue_s"]) / len(obs["enqueue_s"])
