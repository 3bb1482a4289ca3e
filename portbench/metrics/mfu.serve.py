"""The whole step's model FLOP/s over the card's peak, in %: the plain
reference's FLOPs of the traced units (3x the forward for a train step)
over the traced window's length, against the dense TF32 peak of 495
TFLOP/s, above any float32-accurate rate."""

TF32_FLOP_PER_S = 495e12


def read(view):
    flops = view.info.get('flops_per_unit')
    if not flops or not view.units:
        return None
    return 100.0 * flops * view.units / view.window_s / TF32_FLOP_PER_S
