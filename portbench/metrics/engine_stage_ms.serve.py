"""Host ms a request staging the five arrays of a request: the host
seconds of the port's `kpf.engine.stage` span (serving.py: contiguity,
the pinned allocation, the host copy into it and the copies' enqueue)
in its registry (utils/profiling.py) over the traced requests."""


def read(view):
    try:
        from keypointfusion_torch.utils.profiling import totals
    except ImportError:     # a port without the registry
        return None
    entry = totals().get('kpf.engine.stage')
    if not entry or not view.units:
        return None
    return entry['host_s'] / view.units * 1e3
