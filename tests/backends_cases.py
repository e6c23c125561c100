"""The shared part of the port's probe-backend parity tests: the port's
and JAX's lanes of one backend, and the check that holds them equal."""
import jax.numpy as jnp
import numpy as np

from repro.core import layout as jlayout
from repro.kernels import ref as jref
from repro.kernels.probe_area import probe_pages_area as jax_area
from repro.kernels.probe_bitserial import probe_pages_bitserial as jax_bits

from repro_torch.core import layout as tlayout
from repro_torch.kernels import ops

from probe_cases import lanes_oracle, t_pages, t_pool, t_q


def masked(a, key_bits):
    return a & np.uint32((1 << key_bits) - 1) if key_bits < 32 else a


def port_lanes(backend, kp, vp, q, pages, key_bits=32):
    """The port's (Q, 4) lanes as uint32, through the ops entry point."""
    pool, tq, tp = t_pool(kp, vp), t_q(q), t_pages(pages)
    if backend == "area":
        out = ops.probe_area(pool, tq, tp)
    else:
        planes = tlayout.pack_bitplanes(pool[..., 0], key_bits)
        out = ops.probe_bitserial(planes, pool, tq, tp, key_bits)
    return out.numpy().view(np.uint32)


def jax_results(backend, kp, vp, q, pages, key_bits=32, interpret=True):
    """(values, found) of the JAX oracle and, with ``interpret``, of the
    Pallas kernel in interpret mode."""
    pool = jlayout.interleave(jnp.asarray(kp), jnp.asarray(vp))
    jq, jp = jnp.asarray(q), jnp.asarray(pages)
    if backend == "area":
        outs = [jref.probe_pages_ref(pool, jq, jp)]
        if interpret:
            outs.append(jax_area(pool, jq, jp, interpret=True))
    else:
        planes = jlayout.pack_bitplanes(pool[..., 0], key_bits)
        outs = [jref.probe_bitplanes_ref(planes, pool, jq, jp, key_bits)]
        if interpret:
            outs.append(jax_bits(planes, pool, jq, jp, key_bits,
                                 interpret=True))
    return outs


def check_backend(backend, kp, vp, q, pages, key_bits=32, interpret=True):
    got = port_lanes(backend, kp, vp, q, pages, key_bits)
    want = lanes_oracle(masked(kp, key_bits), vp, masked(q, key_bits), pages)
    np.testing.assert_array_equal(got, want)
    for v, f in jax_results(backend, kp, vp, q, pages, key_bits, interpret):
        np.testing.assert_array_equal(got[:, 1] != 0, np.asarray(f))
        np.testing.assert_array_equal(got[:, 0], np.asarray(v))
    return got
