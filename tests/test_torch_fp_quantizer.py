"""The port's FP quantizer (``ops/fp_quantizer.py``) against the JAX
package's on the CPU: the same numpy inputs through both.

Codes and scales bit-equal, viewed as uint8 and as fp32 bits, for the fp8
formats e4m3 and e5m2 and the emulated 6- and 4-bit grids on each carrier
(both packages compute the same fp32 ops: absmax, one division, the
mantissa rounding on int32 bits, a clip and the cast, which rounds to
nearest even in both); dequantized values equal exactly (one fp32
multiply)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import fp_quantizer as jfp
from deepspeed_tpu_torch.ops import fp_quantizer as tfp

torch.set_num_threads(2)


def _inputs(seed, shape=(3, 700)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 50.0], size=shape)).astype(np.float32)
    flat = x.reshape(-1)
    flat[:5] = 0.0  # part of a group all zero
    flat[707] = 448.0 * 3  # an outlier that sets its group's scale
    return x


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("q_bits", [8, 6, 4])
def test_codes_and_scales_bit_equal(fmt, q_bits):
    x = _inputs(q_bits)
    jq = jfp.FP_Quantize(group_size=128, q_bits=q_bits, fmt=fmt)
    tq = tfp.FP_Quantize(group_size=128, q_bits=q_bits, fmt=fmt)
    jc, js = jq.quantize(jnp.asarray(x))
    tc, ts = tq.quantize(torch.from_numpy(x))
    assert tc.dtype == {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[fmt]
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(), np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    jd = np.asarray(jq.dequantize(jc, js, x.shape))
    td = tq.dequantize(tc, ts, x.shape).numpy()
    np.testing.assert_array_equal(td, jd)
    idx = np.array([0, 5, 2])
    np.testing.assert_array_equal(
        tq.selective_dequantize(tc, ts, torch.from_numpy(idx), x.shape).numpy(),
        np.asarray(jq.selective_dequantize(jc, js, jnp.asarray(idx), x.shape)))


@pytest.mark.parametrize("mbits", [1, 2, 3])
def test_round_mantissa_bit_equal(mbits):
    y = np.random.RandomState(mbits).randn(4096).astype(np.float32) * 100
    y[:4] = [0.0, -0.0, 1.5, 2.5]  # ties to even
    got = tfp._round_mantissa(torch.from_numpy(y), mbits).numpy().view(np.uint32)
    want = np.asarray(jfp._round_mantissa(jnp.asarray(y), mbits)).view(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_functional_fp8_matches(fmt):
    x = _inputs(9, (5000,))
    jc, js = jfp.quantize_fp8(jnp.asarray(x), group_size=512, fmt=fmt)
    tc, ts = tfp.quantize_fp8(torch.from_numpy(x), group_size=512, fmt=fmt)
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(), np.asarray(jc).view(np.uint8))
    np.testing.assert_array_equal(
        tfp.dequantize_fp8(tc, ts, x.shape, group_size=512, fmt=fmt).numpy(),
        np.asarray(jfp.dequantize_fp8(jc, js, x.shape, group_size=512, fmt=fmt)))


def test_bad_arguments_raise_as_in_jax():
    for kw in ({"fmt": "e3m4"}, {"q_bits": 5}):
        with pytest.raises(ValueError):
            jfp.FP_Quantize(**kw)
        with pytest.raises(ValueError):
            tfp.FP_Quantize(**kw)
