"""K7's plain version (lrzip_next_tpu_torch.ops.rans_kernels.
decode_scan on a CPU tensor) against the JAX package's Pallas decode
kernel run in interpret mode, as tests/test_rans_decode_pallas.py runs
it: the same symbols and the same final states, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from lrzip_next_tpu.ops.rans_decode_pallas import decode_scan_fused

from test_torch_rans_decode import _encode, _port_scan, _zipf


@pytest.mark.parametrize("ctx_bits", [0, 4, 6, 8])
@pytest.mark.parametrize("k", [1024, 2048])
def test_k7_plain_equals_pallas_interpret(ctx_bits, k):
    """K at the Pallas kernel's floor and at the JAX package's threshold;
    n full, one short of T*K, and with whole lanes of padding.  The stream
    is zero-padded to one length, so the three share one compilation."""
    t = 8
    for cut in (0, 1, 5000):
        n = t * k - cut
        block = _zipf(t * k, ctx_bits + k + cut, hi=64)
        block[n:] = 0
        freqs, states, stream = _encode(block, n, t, k, ctx_bits)
        plane, xf = _port_scan(freqs, states, stream, n, ctx_bits, t)
        padded = np.concatenate(
            [stream, np.zeros(t * k + k - stream.shape[0], np.int32)])
        syms, pxf = decode_scan_fused(
            jnp.asarray(padded), jnp.asarray(states), jnp.asarray(freqs),
            jnp.int32(n), ctx_bits, t, interpret=True)
        assert np.array_equal(plane, np.asarray(syms).T.reshape(-1)), cut
        assert np.array_equal(xf, np.asarray(pxf)), cut
        assert np.array_equal(plane[:n], block[:n]), cut
