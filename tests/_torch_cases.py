"""Test cases shared by the port's CPU tests and its card tests; imports
nothing of JAX."""
import pytest


def conv_case(h, w, kh, kw, shift, tap_lo=0):
    """A K1 case, its id the shape and shift (and ``wrap`` for taps from
    ``tap_lo`` = 2**23 - 64 on, whose products come near 2**31, so the
    int32 sums overflow)."""
    return pytest.param(h, w, kh, kw, shift, tap_lo, id="-".join(
        map(str, (h, w, kh, kw, shift))) + ("-wrap" if tap_lo else ""))


def map_chain(lats, total=48, rates=None, depth=3):
    """A chain of Maps with the given latencies, ``rates`` (Fractions, in
    turn; 1 by default) and FIFO depths ``i % depth``: (modules, edges,
    depths) for the port's cycle engines."""
    from fractions import Fraction
    from repro_torch.core.buffers import Edge
    from repro_torch.core.dtypes import UInt
    from repro_torch.core.rigel import Interface, RModule, ScheduleType
    rates = rates or (Fraction(1),)
    st = ScheduleType(UInt(8), total, 1)
    mods = [RModule(f"m{i}", "Map", Interface("Static", st),
                    Interface("Static", st), rates[i % len(rates)], lat)
            for i, lat in enumerate(lats)]
    edges = [Edge(i, i + 1, 8, 0, 0) for i in range(len(lats) - 1)]
    return mods, edges, {(i, i + 1): i % depth for i in range(len(edges))}
