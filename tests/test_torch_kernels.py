"""The port's kernel modules (repro_torch.kernels) against the reference's
(repro.kernels): the plain PyTorch versions and the HWImg-site adapters
on the same seeded numpy inputs, bit-exact (both sides are integer).

On the CPU a wrapper takes its plain version; test_torch_card.py holds the
tests that need the card.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.conv2d.ops import conv2d_hwimg_site as jax_conv_site  # noqa: E402
from repro.kernels.conv2d.ops import conv2d_stencil as jax_conv  # noqa: E402
from repro.kernels.conv2d.ref import conv2d_ref as jax_conv_ref  # noqa: E402
from repro.kernels.sad.ops import sad_disparity as jax_sad  # noqa: E402
from repro.kernels.sad.ops import sad_hwimg_site as jax_sad_site  # noqa: E402
from repro.kernels.sad.ref import sad_ref as jax_sad_ref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.conv2d.ops import (conv2d_hwimg_site,  # noqa: E402
                                            conv2d_stencil)
from repro_torch.kernels.conv2d.ref import conv2d_ref  # noqa: E402
from repro_torch.kernels.sad.ops import sad_disparity, sad_hwimg_site  # noqa: E402
from repro_torch.kernels.sad.ref import sad_ref  # noqa: E402
from repro_torch.kernels.util import shift2d  # noqa: E402
from _torch_cases import conv_case  # noqa: E402

FRAMES = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _conv_inputs(seed, h, w, kh, kw, tap_lo=0):
    rng = np.random.RandomState(seed)
    p = rng.randint(0, 256, (FRAMES, h + kh - 1, w + kw - 1)).astype(np.int32)
    k = rng.randint(tap_lo, tap_lo + 64, (kh, kw)).astype(np.int32)
    return p, k


def _sad_inputs(seed, h, w, nd, bh, bw):
    rng = np.random.RandomState(seed)
    shape = (FRAMES, h + bh - 1, w + bw - 1 + nd - 1)
    return (rng.randint(0, 256, shape).astype(np.int32),
            rng.randint(0, 256, shape).astype(np.int32))


@pytest.mark.parametrize("h,w,kh,kw,shift,tap_lo", [
    conv_case(13, 37, 3, 5, 0), conv_case(13, 37, 3, 5, 11),
    conv_case(16, 40, 8, 8, 11), conv_case(13, 37, 1, 1, 11),
    conv_case(13, 37, 11, 2, 11), conv_case(13, 37, 2, 16, 11),
    conv_case(16, 40, 8, 8, 11, 2 ** 23 - 64),
    conv_case(13, 37, 3, 5, 11, 2 ** 23 - 64)])
def test_conv2d_matches_reference(h, w, kh, kw, shift, tap_lo):
    p, k = _conv_inputs(h * w + shift, h, w, kh, kw, tap_lo)
    out = conv2d_stencil(_t(p), _t(k), shift=shift).numpy()
    assert out.shape == (FRAMES, h, w) and out.dtype == np.int32
    assert np.array_equal(out, conv2d_ref(_t(p), _t(k), shift).numpy())
    # the jnp oracle on one frame, the Pallas kernel (interpret) on another;
    # the Pallas kernel reads one 8-row halo strip below its 8 output rows,
    # so it takes at most 9 tap rows
    ref = jax_conv_ref(jnp.asarray(p[0]), jnp.asarray(k), shift=shift)
    assert np.array_equal(out[0], np.asarray(ref))
    if kh <= 9:
        assert np.array_equal(out[1],
                              np.asarray(jax_conv(p[1], k, shift=shift)))
    else:
        ref1 = jax_conv_ref(jnp.asarray(p[1]), jnp.asarray(k), shift=shift)
        assert np.array_equal(out[1], np.asarray(ref1))
    if tap_lo:   # the case wraps: its exact sums leave int32's range
        exact = sum(int(k[dy, dx]) * p[:, dy:dy + h, dx:dx + w].astype(
            np.int64) for dy in range(kh) for dx in range(kw))
        assert exact.max() >= 2 ** 31


@pytest.mark.parametrize("h,w,kh,kw,l,b,shift", [
    (13, 37, 3, 5, -4, -2, 11),      # trailing window (the app's form)
    (13, 37, 3, 5, -2, -1, 0),       # centred window
    (40, 96, 8, 8, -7, -7, 11),      # CONVOLUTION's site
])
def test_conv2d_site_matches_reference(h, w, kh, kw, l, b, shift):
    rng = np.random.RandomState(h + w + kh)
    x = rng.randint(0, 256, (FRAMES, h, w)).astype(np.int64)
    k = rng.randint(0, 64, (kh, kw)).astype(np.int32)
    out = conv2d_hwimg_site(_t(x), _t(k), l=l, b=b, shift=shift).numpy()
    for f in range(FRAMES):
        ref = jax_conv_site(x[f], k, l=l, b=b, shift=shift)
        assert np.array_equal(out[f], np.asarray(ref))


@pytest.mark.parametrize("h,w,nd,bh,bw", [(13, 37, 5, 3, 4), (8, 24, 8, 8, 8)])
def test_sad_matches_reference(h, w, nd, bh, bw):
    L, R = _sad_inputs(h * w + nd, h, w, nd, bh, bw)
    out = sad_disparity(_t(L), _t(R), nd=nd, bh=bh, bw=bw).numpy()
    assert out.shape == (FRAMES, h, w) and out.dtype == np.int32
    assert np.array_equal(out, sad_ref(_t(L), _t(R), nd=nd, bh=bh,
                                       bw=bw).numpy())
    # the jnp oracle on one frame, the Pallas kernel (interpret) on another
    ref = jax_sad_ref(jnp.asarray(L[0]), jnp.asarray(R[0]), nd=nd, bh=bh,
                      bw=bw)
    assert np.array_equal(out[0], np.asarray(ref))
    assert np.array_equal(out[1], np.asarray(
        jax_sad(L[1], R[1], nd=nd, bh=bh, bw=bw)))


def test_sad_all_ties_pick_disparity_zero():
    """Constant images tie every disparity: the first minimum (d=0) wins,
    as in the TPU kernel's strict-< argmin."""
    h, w, nd, bh, bw = 13, 37, 5, 3, 4
    L = np.full((FRAMES, h + bh - 1, w + bw - 1 + nd - 1), 7, np.int32)
    out = sad_disparity(_t(L), _t(L.copy()), nd=nd, bh=bh, bw=bw).numpy()
    assert not out.any()
    assert not np.asarray(jax_sad(L[0], L[0], nd=nd, bh=bh, bw=bw)).any()


@pytest.mark.parametrize("h,w,nd,bh,bw", [(13, 37, 5, 3, 4), (24, 64, 8, 8, 8)])
def test_sad_site_matches_reference(h, w, nd, bh, bw):
    rng = np.random.RandomState(nd + bh)
    left = rng.randint(0, 256, (FRAMES, h, w)).astype(np.int64)
    right = np.roll(left, 2, axis=-1)
    out = sad_hwimg_site(_t(left), _t(right), nd=nd, bh=bh, bw=bw).numpy()
    for f in range(FRAMES):
        ref = jax_sad_site(left[f], right[f], nd=nd, bh=bh, bw=bw)
        assert np.array_equal(out[f], np.asarray(ref))


@pytest.mark.parametrize("top,left", [(-2, -3), (0, 0), (3, 1)])
def test_shift2d_zero_fills_outside(top, left):
    x = np.arange(2 * 5 * 6).reshape(2, 5, 6)
    out = shift2d(_t(x), top, left, 7, 9).numpy()
    for i in range(7):
        for j in range(9):
            si, sj = i + top, j + left
            want = x[:, si, sj] if 0 <= si < 5 and 0 <= sj < 6 else 0
            assert np.array_equal(out[:, i, j], want * np.ones(2, int))


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    registry.reset_launch_counts()
    p, k = _conv_inputs(0, 13, 37, 3, 5)
    conv2d_stencil(_t(p), _t(k), shift=11)
    L, R = _sad_inputs(0, 13, 37, 5, 3, 4)
    sad_disparity(_t(L), _t(R), nd=5, bh=3, bw=4)
    assert registry.get_kernel("conv2d").launches() == 0
    assert registry.get_kernel("sad").launches() == 0


def test_wrappers_refuse_other_devices_and_types():
    meta = torch.empty((1, 10, 12), dtype=torch.int32, device="meta")
    kmeta = torch.empty((3, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        conv2d_stencil(meta, kmeta)
    with pytest.raises(ValueError, match="device"):
        sad_disparity(meta, meta, nd=2, bh=2, bw=2)
    p, k = _conv_inputs(0, 13, 37, 3, 5)
    with pytest.raises(TypeError, match="int32"):
        conv2d_stencil(_t(p).long(), _t(k))
    with pytest.raises(ValueError, match="dims"):
        conv2d_stencil(_t(p[0]), _t(k))


def test_registry_lists_the_ported_kernels():
    assert sorted(registry.KERNELS) == ["conv2d", "cyclesim",
                                        "flash_attention", "megakernel",
                                        "sad"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the cycle kernel replaces an XLA loop, the others Pallas kernels
    tpu = {"conv2d": "def _conv_kernel", "sad": "def _sad_kernel",
           "megakernel": "def emit_megakernel",
           "flash_attention": "def _flash_kernel",
           "cyclesim": "def _segment_impl"}
    for e in registry.KERNELS.values():
        assert e.source.startswith("src/repro_torch/")
        assert os.path.exists(os.path.join(root, e.source))
        path, line = e.replaces.split(":")
        assert path.startswith("src/repro/")
        with open(os.path.join(root, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(tpu[e.name])
