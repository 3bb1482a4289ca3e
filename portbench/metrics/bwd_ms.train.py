"""Device ms a step launched by autograd's backward: under an
`autograd::engine::evaluate_function` call of the backward's thread."""


def read(view):
    return view.per_unit_ms(
        lambda o: o.under('autograd::engine::evaluate_function'))
