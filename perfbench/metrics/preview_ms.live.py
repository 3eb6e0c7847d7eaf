"""preview_ms.live: the mean host span of Engine.read_output_scaled (the
device downsample, the sRGB encode and the copy to the host) in the
window, in ms."""


def read(rec):
    spans = rec.spans.get("preview")
    if rec.loop != "live" or not spans:
        return None
    return sum(spans) / len(spans) * 1e3
