"""Derivative-free optimizers: Nelder-Mead simplex + directional direct search.

Parity with the reference's generic DFO headers
(`PointCloudProcessor/include/dfo/optimizer.hpp:8-48`,
`nelder_mead.hpp:8-117`, `directional_direct_search.hpp:8-99`), which back
its projection inversion (`estimate_fov.cpp:17-34`, a 2-dof Nelder-Mead).

Array-native formulation: both optimizers are branch-free `lax.while_loop`
bodies over fixed-shape state, so they jit, vmap (batched independent
problems — e.g. one inverse-projection per pixel), and differentiate-through
is not needed (they exist precisely for non-differentiable objectives).
The primary pipeline path does NOT use them for bearings — fixed-point
undistortion (`models/camera.py:undistort`) is closed-form there — but they
remain available for black-box calibration objectives and are cross-checked
against the closed form in tests.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class DFOResult(NamedTuple):
    x: jnp.ndarray  # best parameters (N,)
    value: jnp.ndarray  # objective at x
    iterations: jnp.ndarray  # int32 iterations used


def nelder_mead(
    f: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    init_step: float = 0.1,
    max_iterations: int = 256,
    xtol: float = 1e-8,
    alpha: float = 1.0,  # reflection   (nelder_mead.hpp:49-97 coefficients)
    beta: float = 2.0,  # expansion
    gamma: float = 0.5,  # contraction
    delta: float = 0.5,  # shrink
) -> DFOResult:
    """Minimize ``f`` from ``x0`` with a Nelder-Mead simplex.

    ``f`` maps (N,) -> scalar and must be jittable; the loop is a
    `lax.while_loop`, so the whole optimize is one compiled program.
    """
    n = x0.shape[0]
    dtype = x0.dtype

    # Initial simplex: x0 plus a step along each axis (nelder_mead.hpp init).
    simplex = jnp.concatenate(
        [x0[None, :], x0[None, :] + init_step * jnp.eye(n, dtype=dtype)], axis=0
    )  # (n+1, n)
    values = jax.vmap(f)(simplex)

    def cond(state):
        simplex, values, it = state
        spread = jnp.max(jnp.abs(simplex - simplex[0:1]))
        return (it < max_iterations) & (spread > xtol)

    def body(state):
        simplex, values, it = state
        order = jnp.argsort(values)
        simplex = simplex[order]
        values = values[order]
        best_v, worst_v = values[0], values[-1]
        second_worst_v = values[-2]
        centroid = jnp.mean(simplex[:-1], axis=0)

        xr = centroid + alpha * (centroid - simplex[-1])
        fr = f(xr)
        xe = centroid + beta * (xr - centroid)
        fe = f(xe)
        xc = centroid + gamma * (simplex[-1] - centroid)
        fc = f(xc)

        # Branch-free selection of the replacement for the worst vertex.
        use_expand = (fr < best_v) & (fe < fr)
        use_reflect = (fr < second_worst_v) & ~use_expand
        use_contract = (fc < worst_v) & ~use_expand & ~use_reflect
        shrink = ~(use_expand | use_reflect | use_contract)

        new_last = jnp.where(
            use_expand, xe, jnp.where(use_reflect, xr, jnp.where(use_contract, xc, simplex[-1]))
        )
        new_last_v = jnp.where(
            use_expand, fe, jnp.where(use_reflect, fr, jnp.where(use_contract, fc, worst_v))
        )
        updated = simplex.at[-1].set(new_last)
        updated_v = values.at[-1].set(new_last_v)

        # Shrink all vertices toward the best (evaluated every iteration,
        # selected only when needed — the price of branch-free control flow).
        shrunk = simplex[0:1] + delta * (simplex - simplex[0:1])
        shrunk_v = jax.vmap(f)(shrunk)
        simplex = jnp.where(shrink, shrunk, updated)
        values = jnp.where(shrink, shrunk_v, updated_v)
        return simplex, values, it + 1

    simplex, values, it = jax.lax.while_loop(cond, body, (simplex, values, jnp.int32(0)))
    best = jnp.argmin(values)
    return DFOResult(x=simplex[best], value=values[best], iterations=it)


def directional_direct_search(
    f: Callable[[jnp.ndarray], jnp.ndarray],
    x0: jnp.ndarray,
    init_step: float = 0.1,
    max_iterations: int = 256,
    step_tol: float = 1e-8,
    shrink: float = 0.5,
) -> DFOResult:
    """Coordinate-direction direct search
    (`directional_direct_search.hpp:29-93`): poll +-e_i * step; move to the
    best improving poll point, else halve the step. All 2N polls evaluate as
    one vmapped batch per iteration.
    """
    n = x0.shape[0]
    dirs = jnp.concatenate([jnp.eye(n, dtype=x0.dtype), -jnp.eye(n, dtype=x0.dtype)])

    def cond(state):
        x, fx, step, it = state
        return (it < max_iterations) & (step > step_tol)

    def body(state):
        x, fx, step, it = state
        cand = x[None, :] + step * dirs  # (2N, N)
        fv = jax.vmap(f)(cand)
        j = jnp.argmin(fv)
        improved = fv[j] < fx
        x = jnp.where(improved, cand[j], x)
        fx = jnp.where(improved, fv[j], fx)
        step = jnp.where(improved, step, step * shrink)
        return x, fx, step, it + 1

    x, fx, _, it = jax.lax.while_loop(
        cond, body, (x0, f(x0), jnp.asarray(init_step, x0.dtype), jnp.int32(0))
    )
    return DFOResult(x=x, value=fx, iterations=it)


def estimate_direction_nm(camera, pixel: jnp.ndarray, max_iterations: int = 128) -> jnp.ndarray:
    """Bearing of a pixel by Nelder-Mead over two rotation angles — the
    reference's exact inversion strategy (`estimate_fov.cpp:17-34`), kept as
    a cross-check for the closed-form `camera.bearing`.
    """
    from ..models import camera as cam

    def angles_to_dir(x):
        # (pitch, yaw) applied to +z, as the reference parameterizes.
        sp, cp = jnp.sin(x[0]), jnp.cos(x[0])
        sy, cy = jnp.sin(x[1]), jnp.cos(x[1])
        return jnp.stack([cp * sy, sp, cp * cy])

    def objective(x):
        d = angles_to_dir(x)
        px = cam.project(camera, d)
        return jnp.sum((px - pixel) ** 2)

    res = nelder_mead(objective, jnp.zeros((2,), jnp.float32), init_step=0.3,
                      max_iterations=max_iterations, xtol=1e-10)
    d = angles_to_dir(res.x)
    return d / jnp.linalg.norm(d)
