"""Fused Pallas (Triton route) kernel: B-spline joint histogram for the NID.

The XLA path (`opt/nid._joint_histogram_xla`) computes, per evaluation:
spline weights (N, 16) -> per-tap one-hot accumulation into (N, bins)
image-bin masses -> a (bins, N) x (N, bins) contraction. Those
intermediates and their cotangents round-trip device memory between
fusions (~134 MB each at 8 x 262,144 points). This kernel reads each
point's inputs once (two nibble-packed tap words, two fractional offsets,
its intensity bin and inlier weight: 24 bytes) and keeps everything else
in registers:

* each program owns one power-of-two block of points, computes the cubic
  B-spline weights in registers, builds the (block, 16) image-bin mass
  matrix and contracts it with the point-bin one-hot in one ``pl.dot``
  at full f32 (``Precision.HIGHEST`` -> Triton ``ieee``, no TF32);
* it writes its own (16, 16) partial histogram; XLA sums the
  ``(num_programs, 16, 16)`` partials. Deterministic: no atomics and no
  sum carried from one program to the next.

The adjoint kernel (pose gradient through the fractional offsets sx, sy)
is wired through `jax.custom_vjp`: each program gathers its points' rows
of the (16, 16) cotangent and writes ``dsx`` and ``dsy`` — the same
structure the reference gets from Ceres Jets over `nid_cost.hpp:42-116`,
as an explicit adjoint.

`opt.nid` runs this kernel on CUDA devices (``jax.lax.platform_dependent``)
and the XLA path elsewhere; CPU tests run it with ``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# Points per program and warps per program. The kernel's bins axis is
# always 16 (the nibble-packed taps hold values < 16, and Triton's dot
# needs every dimension >= 16); smaller ``bins`` slice the result.
BLOCK = 512
NUM_WARPS = 4
_LANES = 16


def _weights(s):
    """(blk,) fractional offsets -> four (blk,) uniform cubic B-spline
    weights: the closed forms of the basis matrix in `opt/nid._SPLINE`."""
    s2 = s * s
    s3 = s2 * s
    return (
        (1.0 - 3.0 * s + 3.0 * s2 - s3) / 6.0,
        (4.0 - 6.0 * s2 + 3.0 * s3) / 6.0,
        (1.0 + 3.0 * s + 3.0 * s2 - 3.0 * s3) / 6.0,
        s3 / 6.0,
    )


def _dweights(s):
    s2 = s * s
    return (
        (-3.0 + 6.0 * s - 3.0 * s2) / 6.0,
        (-12.0 * s + 9.0 * s2) / 6.0,
        (3.0 + 6.0 * s - 9.0 * s2) / 6.0,
        3.0 * s2 / 6.0,
    )


def _tap(w0, w1, t):
    """Tap t (0..15, (dy, dx) order) of the nibble-packed words (see
    opt.nid.pack_tap_nibbles). Arithmetic shift + mask: exact in int32."""
    word = w0 if t < 8 else w1
    return (word >> (4 * (t % 8))) & 0xF


def _load_block(refs, n, block):
    """Masked loads of this program's points; points past ``n`` read zeros
    (zero inlier weight, so they contribute nothing)."""
    idx = pl.program_id(0) * block + jnp.arange(block)
    mask = idx < n
    return idx, mask, [plgpu.load(r.at[idx], mask=mask, other=0) for r in refs]


def _fwd_kernel(w0_ref, w1_ref, sx_ref, sy_ref, bp_ref, inl_ref, out_ref,
                *, n: int, block: int):
    _, _, (w0, w1, sx, sy, bp, inl) = _load_block(
        (w0_ref, w1_ref, sx_ref, sy_ref, bp_ref, inl_ref), n, block
    )
    bx, by = _weights(sx), _weights(sy)
    lanes = jnp.arange(_LANES)[None, :]
    # M[n, b] = sum_t w_t[n] * [tap_t[n] == b]: per-point image-bin mass.
    m = jnp.zeros((block, _LANES), jnp.float32)
    for t in range(16):
        w_t = by[t // 4] * bx[t % 4] * inl
        m = m + jnp.where(_tap(w0, w1, t)[:, None] == lanes, w_t[:, None], 0.0)
    p = jnp.where(bp[:, None] == lanes, 1.0, 0.0)  # point-bin one-hot
    # joint[pt, img] = P^T M, full f32 (ieee) — TF32 keeps ~3 decimal
    # digits, which visibly moves the entropy sums downstream.
    out_ref[...] = pl.dot(p, m, trans_a=True, precision=jax.lax.Precision.HIGHEST)


def _bwd_kernel(g_ref, w0_ref, w1_ref, sx_ref, sy_ref, bp_ref, inl_ref,
                dsx_ref, dsy_ref, *, n: int, block: int):
    idx, mask, (w0, w1, sx, sy, bp, inl) = _load_block(
        (w0_ref, w1_ref, sx_ref, sy_ref, bp_ref, inl_ref), n, block
    )
    bx, by = _weights(sx), _weights(sy)
    dbx, dby = _dweights(sx), _dweights(sy)
    dsx = jnp.zeros((block,), jnp.float32)
    dsy = jnp.zeros((block,), jnp.float32)
    for t in range(16):
        # d joint[bp, tap] / d s: gather this tap's cotangent entry (the
        # 1 KB cotangent stays in L1).
        gsel = plgpu.load(g_ref.at[bp, _tap(w0, w1, t)])
        ty, tx = t // 4, t % 4
        dsx = dsx + dbx[tx] * by[ty] * gsel
        dsy = dsy + bx[tx] * dby[ty] * gsel
    plgpu.store(dsx_ref.at[idx], dsx * inl, mask=mask)
    plgpu.store(dsy_ref.at[idx], dsy * inl, mask=mask)


def _columns(taps, s, bin_pts, inlier):
    return (
        taps[:, 0].astype(jnp.int32),
        taps[:, 1].astype(jnp.int32),
        s[:, 0].astype(jnp.float32),
        s[:, 1].astype(jnp.float32),
        bin_pts.astype(jnp.int32),
        inlier.astype(jnp.float32),
    )


def num_programs(n: int) -> int:
    return pl.cdiv(n, BLOCK)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5))
def joint_histogram(taps, s, bin_pts, inlier, bins: int = 16,
                    interpret: bool = False):
    """(bins, bins) joint histogram [point_bin, image_bin].

    Args:
        taps: (N, 2) int32 nibble-packed image-bin values of each point's
            4x4 window ((dy, dx) tap order, packed by
            `opt.nid.pack_tap_nibbles`, from the tap-table row gather).
        s: (N, 2) fractional projection offsets (the pose-differentiable part).
        bin_pts: (N,) int32 LiDAR-intensity bins.
        inlier: (N,) float32 0/1 mask (already includes validity gates).
        bins: histogram bins, at most 16.
        interpret: run the Pallas interpreter (CPU tests only).
    """
    return _fwd(taps, s, bin_pts, inlier, bins, interpret)[0]


def partial_histograms(taps, s, bin_pts, inlier, interpret: bool = False):
    """(num_programs(N), 16, 16) per-program partial joint histograms
    [point_bin, image_bin]: program i covers points [i*BLOCK, (i+1)*BLOCK)."""
    return _partials(_columns(taps, s, bin_pts, inlier), interpret)


def _partials(cols, interpret):
    n = cols[0].shape[0]
    grid = num_programs(n)
    return pl.pallas_call(
        functools.partial(_fwd_kernel, n=n, block=BLOCK),
        grid=(grid,),
        out_specs=pl.BlockSpec((None, _LANES, _LANES), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((grid, _LANES, _LANES), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="nid_joint_hist_fwd",
    )(*cols)


def _fwd(taps, s, bin_pts, inlier, bins, interpret):
    assert bins <= _LANES, bins
    cols = _columns(taps, s, bin_pts, inlier)
    hist = jnp.sum(_partials(cols, interpret), axis=0)[:bins, :bins]
    return hist, cols


def _bwd(bins, interpret, residuals, g):
    cols = residuals
    n = cols[0].shape[0]
    g16 = jnp.zeros((_LANES, _LANES), jnp.float32).at[:bins, :bins].set(
        g.astype(jnp.float32)
    )
    out = jax.ShapeDtypeStruct((n,), jnp.float32)
    dsx, dsy = pl.pallas_call(
        functools.partial(_bwd_kernel, n=n, block=BLOCK),
        grid=(num_programs(n),),
        out_shape=(out, out),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="nid_joint_hist_bwd",
    )(g16, *cols)
    return (None, jnp.stack([dsx, dsy], axis=-1), None, None)


joint_histogram.defvjp(_fwd, _bwd)
