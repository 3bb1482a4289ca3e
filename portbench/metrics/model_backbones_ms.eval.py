"""Device ms a batch launched under the port's `kpf.model.backbones` span
(models/kpfusion.py, around backbone_d and backbone_rgb);
backbone_ms.eval's twin."""


def read(view):
    return view.per_unit_ms(lambda o: 'kpf.model.backbones' in o.ranges)
