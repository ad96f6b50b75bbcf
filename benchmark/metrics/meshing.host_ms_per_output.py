"""Host ms an output in the window's emission and mesh pulls: the
program's span `active_window/extract_output`, its mean over the outputs
of the window (one every 0.4 s of stamps a robot)."""


def read(ctx):
    row = ctx["spans"].get("active_window/extract_output")
    return row["mean_s"] * 1e3 if row else None
