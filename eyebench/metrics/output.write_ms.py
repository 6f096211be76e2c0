"""output.write_ms: host milliseconds per photo in the program's output
stage (``DepthMap.output_image``: the render's dispatch, the copy to the
host, the Lanczos3 upsizing and the PNG encode and write), from the
harness's spans around that call in the traced window."""


def read(run):
    if not run.window.photos or not any(s[0] == "output" for s in run.spans):
        return None
    return sum(t1 - t0 for n, t0, t1 in run.spans if n == "output") / 1e6 / run.window.photos
