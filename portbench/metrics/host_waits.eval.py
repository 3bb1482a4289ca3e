"""Host waits a unit: the synchronizing CUDA calls the port made on its
thread inside its `kpf.*` spans, as its registry counts them
(utils/profiling.py), over the traced units; None where no span ran."""


def read(view):
    try:
        from keypointfusion_torch.utils.profiling import totals
    except ImportError:     # a port without the registry
        return None
    entries = totals()
    if not entries or not view.units:
        return None
    return sum(e['waits'] for e in entries.values()) / view.units
