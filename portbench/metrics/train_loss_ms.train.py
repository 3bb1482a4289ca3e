"""Device ms a step launched under the port's `kpf.train.loss` span
(training/train_step.py: compute_losses) on the step's thread."""


def read(view):
    return view.per_unit_ms(lambda o: 'kpf.train.loss' in o.ranges)
