"""Host ms an output in the object extraction that runs inline in it: the
program's span `object_extraction/track` (one a finished track, its pulls
included), over the outputs of `active_window/extract_output`."""


def read(ctx):
    spans = ctx["spans"]
    tracks, outputs = spans.get("object_extraction/track"), spans.get("active_window/extract_output")
    return tracks["total_s"] * 1e3 / outputs["n_samples"] if tracks and outputs else None
