"""Device ms a request of the work launched inside
data/device_preprocess.py (the crop, its normalization and the point
draw), under the harness's `pb.preprocess` range around the engine's
call of device_preprocess."""


def read(view):
    return view.per_unit_ms(lambda o: o.under('pb.preprocess'))
