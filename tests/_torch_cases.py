"""Test cases shared by the port's CPU tests and its card tests; imports
nothing of JAX."""
import pytest


def conv_case(h, w, kh, kw, shift, tap_lo=0):
    """A K1 case, its id the shape and shift (and ``wrap`` for taps from
    ``tap_lo`` = 2**23 - 64 on, whose products come near 2**31, so the
    int32 sums overflow)."""
    return pytest.param(h, w, kh, kw, shift, tap_lo, id="-".join(
        map(str, (h, w, kh, kw, shift))) + ("-wrap" if tap_lo else ""))
