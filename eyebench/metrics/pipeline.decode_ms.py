"""pipeline.decode_ms: host milliseconds per photo in the program's decode
(``api.load_source_image``: JPEG decode, EXIF), from the harness's spans
around that call in the traced window."""


def read(run):
    if not run.window.photos or not any(s[0] == "decode" for s in run.spans):
        return None
    return sum(t1 - t0 for n, t0, t1 in run.spans if n == "decode") / 1e6 / run.window.photos
