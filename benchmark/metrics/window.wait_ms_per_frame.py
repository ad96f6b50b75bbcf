"""Host ms a frame blocked on the card: the summed time of the program's
`wait/<site>` spans (each a point where the host waits for the card: a pull
that has not landed, a blocking copy), over the frames of `active_window/all`."""


def read(ctx):
    spans = ctx["spans"]
    frames = spans.get("active_window/all")
    waits = [row for name, row in spans.items() if name.startswith("wait/")]
    if not frames or not waits:
        return None
    return sum(row["total_s"] for row in waits) * 1e3 / frames["n_samples"]
