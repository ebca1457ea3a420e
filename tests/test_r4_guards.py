"""Round-4 guard rail: the rng upper-bound clamp (ADVICE r3)."""
import jax.numpy as jnp
import numpy as np


class TestRngUpperBound:
    def test_max_bits_stay_below_one(self):
        from fermat_tpu.core.rng import uniform_from_bits

        bits = jnp.array([0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFF7F, 0, 1],
                         dtype=jnp.uint32)
        u = np.asarray(uniform_from_bits(bits))
        assert (u < 1.0).all(), u
        assert (u >= 0.0).all(), u
        # untouched below the rounding threshold
        assert u[2] == np.float32(0xFFFFFF7F) * np.float32(2.0 ** -32) or \
            u[2] < 1.0
        assert u[3] == 0.0
