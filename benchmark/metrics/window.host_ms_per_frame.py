"""Host ms a frame inside ActiveWindow.spin_once: the program's span
`active_window/all`, its mean over the window's frames."""


def read(ctx):
    row = ctx["spans"].get("active_window/all")
    return row["mean_s"] * 1e3 if row else None
