"""The share of the traced window, in %, in which no device operation
ran (the union of the kernels', copies' and memsets' intervals against
the window's host length)."""


def read(view):
    return 100.0 * (1.0 - view.busy_s / view.window_s)
