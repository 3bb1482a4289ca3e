"""K2 'highest''s share of its roofline, in %: the least time for one
launch's bytes (portbench/work.py:k2_work) over its mean device time."""


def read(view):
    launches = view.kernels('pixel_sampler_kernel')
    if not launches:
        return None
    return 100.0 * view.info['k2_bound'] * len(launches) / (
        sum(o.dur for o in launches) / 1e6)
