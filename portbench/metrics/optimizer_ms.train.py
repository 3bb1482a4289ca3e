"""Device ms a step in the optimizer's step: under torch's
`Optimizer.step#...` range."""


def read(view):
    return view.per_unit_ms(lambda o: o.under('Optimizer.step'))
