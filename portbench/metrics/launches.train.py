"""Kernel launches a step in the traced steps (kernels on the device's
timeline; copies and memsets apart)."""


def read(view):
    if not view.units:
        return None
    return sum(1 for o in view.ops if o.cat == 'kernel') / view.units
