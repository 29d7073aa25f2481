"""K004 bad twin: a wrapper that picks the plain version on the CPU."""


def scale_plain(x):
    return x * 2


def scale(x):
    if x.device.type == "cpu":
        return scale_plain(x)
    return _launch(x)


def _launch(x):
    return x
