"""Host waits on the card a frame: the count of the program's `wait/<site>`
spans, over the frames of `active_window/all`."""


def read(ctx):
    spans = ctx["spans"]
    frames = spans.get("active_window/all")
    waits = [row for name, row in spans.items() if name.startswith("wait/")]
    if not frames or not waits:
        return None
    return sum(row["n_samples"] for row in waits) / frames["n_samples"]
