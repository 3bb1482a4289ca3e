"""Host ms a step inside the model's forward: the host seconds of the
port's `kpf.model` span (models/kpfusion.py: the forward's Python and
launches, and the host waits among them) in its registry
(utils/profiling.py) over the traced steps."""


def read(view):
    try:
        from keypointfusion_torch.utils.profiling import totals
    except ImportError:     # a port without the registry
        return None
    entry = totals().get('kpf.model')
    if not entry or not view.units:
        return None
    return entry['host_s'] / view.units * 1e3
