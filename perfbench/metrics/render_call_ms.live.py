"""render_call_ms.live: the mean host span of Engine.render_frame (the
graph's launches and the in-flight queue's wait) in the window, in ms."""


def read(rec):
    spans = rec.spans.get("render_frame")
    if rec.loop != "live" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
