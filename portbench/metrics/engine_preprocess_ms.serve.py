"""Device ms a request launched under the port's `kpf.engine.preprocess`
span (serving.py, around device_preprocess: the crops, their
normalization, the point draw); preprocess_ms.serve's twin."""


def read(view):
    return view.per_unit_ms(lambda o: 'kpf.engine.preprocess' in o.ranges)
