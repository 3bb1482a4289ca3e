"""Device ms a batch launched under the port's `kpf.model` span
(models/kpfusion.py, the forward) and outside its `kpf.model.backbones`:
the fusion head, K1 and K2 among it; head_ms.serve's twin."""


def read(view):
    return view.per_unit_ms(lambda o: 'kpf.model' in o.ranges
                            and 'kpf.model.backbones' not in o.ranges)
