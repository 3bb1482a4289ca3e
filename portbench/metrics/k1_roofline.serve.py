"""K1 'highest''s share of its roofline, in %: the sum over its launches
of the least time the card could take for each launch's work
(portbench/work.py:k1_work on the points of that DESA call) over the sum
of the launches' device times."""


def read(view):
    launches = view.kernels('desa_dense_kernel')
    bounds = view.info.get('k1_bounds', [])
    if not launches or len(launches) != len(bounds):
        return None
    return 100.0 * sum(bounds) / (sum(o.dur for o in launches) / 1e6)
