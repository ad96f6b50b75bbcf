"""Host ms an output in the archived surface's emission round: the
program's span `extract/emit`, over the outputs of
`active_window/extract_output`."""


def read(ctx):
    spans = ctx["spans"]
    emit, outputs = spans.get("extract/emit"), spans.get("active_window/extract_output")
    return emit["total_s"] * 1e3 / outputs["n_samples"] if emit and outputs else None
