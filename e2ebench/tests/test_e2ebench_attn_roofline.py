"""The attention kernel's roofline reader on synthetic traces."""

import pytest

from e2ebench.metrics import attn_decode_roofline as reader
from e2ebench.run import Readings

D = {"kv_heads": 8, "head_dim": 128}
HBM = 3.35e12


def readings(kernels, pages=((5.0, 1152, 64), (9.0, 1280, 128))):
    return Readings(d=D, batch=32, peak_hbm=HBM, stretch=(4.0, 9.5),
                    pages=list(pages),
                    trace={"kernels": kernels, "busy_s": 1.0, "window_s": 4.0})


def test_bytes_of_every_launch_over_both_kernels_time():
    steps, layers = 64 + 128, 8
    ctx = ((1152 + 65 / 2) * 64 + (1280 + 129 / 2) * 128) / steps
    nbytes = 2 * 32 * 8 * 128 * 2 * ctx * steps * layers
    kernels = {
        "void attn_decode_kernel<__nv_bfloat16, 128, 4>(Args)": (steps * layers, 0.3),
        "void attn_decode_combine_kernel<__nv_bfloat16>(float const*)": (steps * layers, 0.1),
        "void at::native::elementwise_kernel<128, 2>": (999, 5.0),
    }
    got = reader.read(readings(kernels))
    assert got == pytest.approx(100 * nbytes / (0.4 * HBM))


def test_pages_outside_the_stretch_are_not_counted():
    kernels = {"attn_decode_kernel<float, 64, 1>": (8, 0.001)}
    inside = reader.read(readings(kernels, pages=((5.0, 1152, 1),)))
    both = reader.read(readings(kernels, pages=((5.0, 1152, 1), (2.0, 5000, 128))))
    assert inside == both


@pytest.mark.parametrize("kernels", [
    {},  # the parent: no such kernel on the trace
    {"void at::native::elementwise_kernel<128, 2>": (10, 1.0)},
    {"attn_decode_combine_kernel<float>": (8, 0.001)},  # no main kernel
])
def test_none_without_the_kernel(kernels):
    assert reader.read(readings(kernels)) is None


def test_none_without_a_trace():
    r = readings({})
    r.trace = None
    assert reader.read(r) is None
