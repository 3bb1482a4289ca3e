"""Device ms a step launched under the port's `kpf.train.forward` span
(training/train_step.py: the train-mode forward) on the step's thread."""


def read(view):
    return view.per_unit_ms(lambda o: 'kpf.train.forward' in o.ranges)
