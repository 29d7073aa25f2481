"""K004 clean twin: one route whatever the device."""


def scale_plain(x):
    return x * 2


def scale(x):
    if x.dtype.is_floating_point:
        return scale_plain(x)
    raise TypeError("floats only")
