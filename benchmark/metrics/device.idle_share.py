"""Share of the traced stretch in which no kernel ran on the card: one
minus the union of the kernels' intervals over the stretch's wall time."""


def read(ctx):
    tr = ctx["tracer"]
    if tr is None or tr.window_s <= 0 or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
