"""poll_ms.live: the mean host span of Engine.trigger_reloads (the watcher's
poll) in the window, in ms."""


def read(rec):
    spans = rec.spans.get("poll")
    if rec.loop != "live" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
