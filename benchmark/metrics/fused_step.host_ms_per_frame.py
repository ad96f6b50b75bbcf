"""Host ms a frame in the fused step's call: the program's span
`active_window/fused_step`, its mean over the window's frames."""


def read(ctx):
    row = ctx["spans"].get("active_window/fused_step")
    return row["mean_s"] * 1e3 if row else None
