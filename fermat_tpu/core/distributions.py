"""Random-variable transforms + 2D Gaussian mixtures with EM fitting.

Reference analogs:
  * cugar/sampling/distributions.h — uniform/cosine/Pareto/bounded-Pareto/
    bounded-exponential/Cauchy/exponential/2D-Gaussian transforms, each a
    (map, density) pair over a uniform input.
  * cugar/sampling/mixtures.h — Mixture_model of 2D Gaussians.
  * cugar/sampling/em.h — (joint-entropy / stepwise) EM updates of the
    mixture from weighted samples.

Shape: everything is vectorized over flat (N,) sample arrays; the EM
step is one batched responsibility matmul + weighted moment reductions —
jit-friendly, no data-dependent shapes.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

Array = jax.Array
_SQRT2 = math.sqrt(2.0)
_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# 1D transforms (distributions.h)
# ---------------------------------------------------------------------------

class Uniform:
    """U[0, range)."""

    def __init__(self, r: float = 1.0):
        self.r = r

    def map(self, u):
        return u * self.r

    def density(self, x):
        return jnp.where((x >= 0) & (x < self.r), 1.0 / self.r, 0.0)


class Cosine:
    """cos distribution over [-pi/2, pi/2] (distributions.h:124)."""

    def map(self, u):
        return jnp.arcsin(jnp.clip(2.0 * u - 1.0, -1.0, 1.0))

    def density(self, x):
        return 0.5 * jnp.cos(x)


class Pareto:
    """Pareto with shape a, scale xm (distributions.h:146)."""

    def __init__(self, a: float, xm: float):
        self.a, self.xm = a, xm

    def map(self, u):
        return self.xm / jnp.maximum(u, 1e-12) ** (1.0 / self.a)

    def density(self, x):
        return jnp.where(
            x >= self.xm, self.a * self.xm ** self.a / x ** (self.a + 1.0), 0.0
        )


class BoundedPareto:
    """Pareto truncated to [l, h] (distributions.h:182)."""

    def __init__(self, a: float, lo: float, hi: float):
        self.a, self.lo, self.hi = a, lo, hi

    def map(self, u):
        la, ha = self.lo ** self.a, self.hi ** self.a
        return (-(u * ha - u * la - ha) / (ha * la)) ** (-1.0 / self.a)

    def density(self, x):
        la, ha = self.lo ** self.a, self.hi ** self.a
        d = self.a * la * x ** (-self.a - 1.0) / (1.0 - la / ha)
        return jnp.where((x >= self.lo) & (x <= self.hi), d, 0.0)


class BoundedExponential:
    """Two-sided bounded exponential over +-[b0, b1] (distributions.h:234)."""

    def __init__(self, b0: float, b1: float):
        self.b0, self.b1 = b0, b1

    def map(self, u):
        s = jnp.where(u < 0.5, 1.0, -1.0)
        t = jnp.where(u < 0.5, u * 2.0, (u - 0.5) * 2.0)
        ratio = self.b1 / self.b0
        return s * self.b0 * ratio ** t

    def density(self, x):
        a = jnp.abs(x)
        ln_r = math.log(self.b1 / self.b0)
        d = 1.0 / (2.0 * a * ln_r)
        return jnp.where((a >= self.b0) & (a <= self.b1), d, 0.0)


class Cauchy:
    """Cauchy with scale gamma (distributions.h Cauchy_distribution)."""

    def __init__(self, gamma: float):
        self.gamma = gamma

    def map(self, u):
        return self.gamma * jnp.tan(math.pi * (u - 0.5))

    def density(self, x):
        g = self.gamma
        return g / (math.pi * (x * x + g * g))


class Exponential:
    """Exponential with rate lam."""

    def __init__(self, lam: float):
        self.lam = lam

    def map(self, u):
        return -jnp.log(jnp.maximum(1.0 - u, 1e-12)) / self.lam

    def density(self, x):
        return jnp.where(x >= 0, self.lam * jnp.exp(-self.lam * x), 0.0)


class Gaussian:
    """N(mu, sigma^2) via the inverse-erf transform."""

    def __init__(self, mu: float = 0.0, sigma: float = 1.0):
        self.mu, self.sigma = mu, sigma

    def map(self, u):
        z = jax.scipy.special.erfinv(jnp.clip(2.0 * u - 1.0, -0.999999, 0.999999))
        return self.mu + self.sigma * _SQRT2 * z

    def density(self, x):
        s = self.sigma
        return jnp.exp(-0.5 * ((x - self.mu) / s) ** 2) / (s * math.sqrt(_TWO_PI))


# ---------------------------------------------------------------------------
# 2D Gaussian mixture + EM (mixtures.h + em.h)
# ---------------------------------------------------------------------------

class GaussianMixture2D(NamedTuple):
    """K-component 2D Gaussian mixture (Mixture_model analog)."""

    weights: Array  # (K,) normalized
    means: Array  # (K, 2)
    covs: Array  # (K, 2, 2) SPD

    @staticmethod
    def create(k: int, spread: float = 0.25) -> "GaussianMixture2D":
        """Uniformly-spread init over [0,1]^2 (the EM warm start)."""
        g = int(math.ceil(math.sqrt(k)))
        xs = (jnp.arange(k) % g + 0.5) / g
        ys = (jnp.arange(k) // g + 0.5) / g
        return GaussianMixture2D(
            weights=jnp.full(k, 1.0 / k),
            means=jnp.stack([xs, ys], axis=1),
            covs=jnp.tile(jnp.eye(2) * spread**2, (k, 1, 1)),
        )

    @property
    def k(self) -> int:
        return self.weights.shape[0]

    def component_pdf(self, x: Array) -> Array:
        """(N, K) per-component densities at x (N, 2)."""
        d = x[:, None, :] - self.means[None]  # (N, K, 2)
        inv = jnp.linalg.inv(self.covs)  # (K, 2, 2)
        det = jnp.maximum(jnp.linalg.det(self.covs), 1e-20)
        q = jnp.einsum("nki,kij,nkj->nk", d, inv, d,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.exp(-0.5 * q) / (_TWO_PI * jnp.sqrt(det))

    def pdf(self, x: Array) -> Array:
        return jnp.sum(self.component_pdf(x) * self.weights[None], axis=1)

    def sample(self, u0: Array, u1: Array, u2: Array) -> Array:
        """(N, 2) samples from (u0, u1) Gaussian + u2 component pick."""
        cdf = jnp.cumsum(self.weights)
        k = jnp.minimum(
            jnp.sum((cdf[None, :] < u2[:, None]).astype(jnp.int32), axis=1),
            self.k - 1,
        )
        # standard normal pair (Box-Muller)
        r = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u0, 1e-12)))
        z = jnp.stack(
            [r * jnp.cos(_TWO_PI * u1), r * jnp.sin(_TWO_PI * u1)], axis=1
        )
        chol = jnp.linalg.cholesky(self.covs)  # (K, 2, 2)
        return self.means[k] + jnp.einsum("nij,nj->ni", chol[k], z,
                                          precision=jax.lax.Precision.HIGHEST)


def em_step(
    mix: GaussianMixture2D, x: Array, w: Array = None, min_var: float = 1e-6
) -> GaussianMixture2D:
    """One weighted batch EM update (em.h EM(); the stepwise_E/M pair
    collapses to this in the batch setting).

    x: (N, 2) samples; w: optional (N,) importance weights.
    """
    n = x.shape[0]
    w = jnp.ones(n) if w is None else w
    resp = mix.component_pdf(x) * mix.weights[None]  # (N, K)
    resp = resp / jnp.maximum(jnp.sum(resp, axis=1, keepdims=True), 1e-20)
    rw = resp * w[:, None]  # (N, K)
    nk = jnp.maximum(jnp.sum(rw, axis=0), 1e-12)  # (K,)
    means = jnp.matmul(rw.T, x,
                       precision=jax.lax.Precision.HIGHEST) / nk[:, None]
    d = x[:, None, :] - means[None]  # (N, K, 2)
    covs = jnp.einsum("nk,nki,nkj->kij", rw, d, d,
                      precision=jax.lax.Precision.HIGHEST) / nk[:, None, None]
    covs = covs + jnp.eye(2) * min_var  # regularize (em.h epsilon)
    weights = nk / jnp.sum(nk)
    return GaussianMixture2D(weights=weights, means=means, covs=covs)
