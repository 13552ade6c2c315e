"""The port's block-wise int8 codec (``ops/quantization.py``) vs the JAX
package's Pallas kernels (``deepspeed_tpu/ops/pallas/quantization.py``)
in interpret mode, on the same numpy inputs on the CPU.

Both take the scale as absmax times the fp32 constant 1/127 (XLA's
compilation of the JAX kernel's division by 127), divide ``x / scale`` in
IEEE fp32 and round ties to even, so codes, scales and dequantized values
must be bit-equal: at a length that is not a multiple
of 128 and spans more rows than one ``block_rows`` block (128 * 300 + 17),
with an all-zero row (the scale's 1e-12 floor), in fp32, bf16 and fp16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quantization as jq
from deepspeed_tpu_torch.ops import quantization as tq

torch.set_num_threads(2)

DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}
N = 128 * 300 + 17


def _x(n, seed=0, zero_row=None):
    a = np.random.RandomState(seed).randn(n).astype(np.float32) * 3.0
    if zero_row is not None:
        a[zero_row * 128:(zero_row + 1) * 128] = 0.0
    return a


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("n", [N, 256, 5])
def test_quantize_dequantize_bit_equal_to_jax_kernels(dt, n):
    jdt, tdt = DTYPES[dt]
    a = _x(n, zero_row=1 if n >= 256 else None)
    jx = jnp.asarray(a, jdt)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(tdt)  # the same rounded values
    jqc, js, jn = jq.quantize_int8(jx)
    tqc, ts, tn = tq.quantize_int8(tx)
    assert tn == jn == n
    assert tqc.dtype == torch.int8 and tqc.shape == (-(-n // 128), 128)
    assert ts.dtype == torch.float32 and ts.shape == (-(-n // 128), 1)
    np.testing.assert_array_equal(tqc.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for out_dt in sorted(DTYPES):
        ojdt, otdt = DTYPES[out_dt]
        jy = jq.dequantize_int8(jqc, js, jn, ojdt)
        ty = tq.dequantize_int8(tqc, ts, tn, otdt)
        assert ty.shape == (n,) and ty.dtype == otdt
        np.testing.assert_array_equal(ty.float().numpy(), np.asarray(jy, np.float32))


def test_zero_row_hits_the_scale_floor():
    q, s, n = tq.quantize_int8(torch.from_numpy(_x(N, zero_row=3)))
    assert float(s[3, 0]) == np.float32(1e-12) * (np.float32(1) / np.float32(127))
    assert not q[3].any()
    assert not tq.dequantize_int8(q, s, n)[3 * 128:4 * 128].any()


def test_round_trip_error_within_half_a_step():
    a = _x(N, seed=4)
    q, s, n = tq.quantize_int8(torch.from_numpy(a))
    y = tq.dequantize_int8(q, s, n).numpy()
    step = np.repeat(s.numpy()[:, 0], 128)[:n]
    assert np.all(np.abs(y - a) <= 0.5 * step * (1 + 1e-6))


def test_block_rows_validated_and_result_independent_of_it():
    x = torch.from_numpy(_x(1000))
    with pytest.raises(ValueError, match="block_rows"):
        tq.quantize_int8(x, block_rows=0)
    a, b = tq.quantize_int8(x, block_rows=2), tq.quantize_int8(x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
