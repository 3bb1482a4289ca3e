"""Host ms a request inside StreamingEngine.submit: the host seconds of
the port's `kpf.engine.submit` span (serving.py) in its registry
(utils/profiling.py) over the traced requests; stage_ms.serve's twin,
measured inside the program."""


def read(view):
    try:
        from keypointfusion_torch.utils.profiling import totals
    except ImportError:     # a port without the registry
        return None
    entry = totals().get('kpf.engine.submit')
    if not entry or not view.units:
        return None
    return entry['host_s'] / view.units * 1e3
