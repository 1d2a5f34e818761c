"""Batched Euclidean projection onto the parity polytope.

The parity polytope PP_d is the convex hull of the even-weight binary
vectors in {0,1}^d. Projecting onto it is the inner kernel of ADMM LP
decoding (reference src/parity_polytope/projection.cpp:30-248, called once
per check per ADMM iteration through a ctypes CSR loop,
projection.cpp:266-275 / exact.py:41-60).

Batched re-design. The reference walks a data-dependent merged
breakpoint list with early exit — serial, branchy, one check at a time.
Here the same two-slope waterfilling problem is solved with fixed shapes
and no data-dependent control flow, so it vmaps over every check of every
codeword in the batch at once:

1. sort each row descending (d is the check degree, <= ~32);
2. cube-clip; compute the even parity residual r = 2*floor(floor(sum)/2)
   and the facet normal f (+1 on the r+1 largest coords, -1 elsewhere);
3. if f.z <= r the cube projection is already inside PP_d — done;
4. otherwise the solution is clip(u - beta*f, 0, 1) where
   T(beta) = f.clip(u - beta*f, 0, 1) is piecewise linear and
   non-increasing with T(beta*) = r. Every breakpoint of T is one of the
   2d candidate values {u_i - 1, u_i} (top block) / {-u_i, 1 - u_i}
   (bottom block): evaluate T at ALL candidates in parallel (O(d^2)
   vectorized work — trivially small), bracket r between the largest
   candidate with T >= r and the smallest with T <= r (no breakpoint can
   lie strictly between them, so T is linear there), and interpolate
   exactly.

Mixed check degrees need no bucketing: a padded slot filled with a value
below -(beta_max) projects to exactly 0 because {x : x_pad = 0} is a face
of PP_{d+1} equal to PP_d x {0}; we fill pads with -(row max|v| + 4),
which is below any reachable breakpoint.
"""

from __future__ import annotations

import jax.numpy as jnp


def project_parity_polytope(v: jnp.ndarray,
                            mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Project rows of v [..., D] onto the parity polytope PP_D.

    mask [..., D] bool marks real slots (True) vs padding; padded slots
    project to exactly 0. Shapes are static; everything vmaps/jits.

    Sort-free: the algorithm only needs each coordinate's descending
    RANK (to split the top r+1 block from the rest), and rank is a D^2
    pairwise comparison — elementwise work with no sort on the tiny
    trailing axis.
    """
    dt = v.dtype
    D = v.shape[-1]
    if mask is not None:
        pad_val = -(jnp.max(jnp.abs(v) * mask, axis=-1, keepdims=True) + 4.0)
        v = jnp.where(mask, v, pad_val)

    # Descending rank with index tie-break (== rank in a stable sort).
    gt = (v[..., None, :] > v[..., :, None]) | (
        (v[..., None, :] == v[..., :, None])
        & (jnp.arange(D)[None, :] < jnp.arange(D)[:, None]))
    rank = gt.sum(axis=-1).astype(dt)                           # [..., D]

    z = jnp.clip(v, 0.0, 1.0)
    s = jnp.floor(z.sum(axis=-1))
    r = (s - (s % 2)).astype(dt)                                # even floor
    f = jnp.where(rank <= r[..., None], 1.0, -1.0).astype(dt)   # facet normal
    fz = (f * z).sum(axis=-1)
    easy = fz <= r                                              # inside PP_D

    # T at all candidate breakpoints (clamped into the beta >= 0 domain),
    # plus beta = 0 itself where T(0) = fz. All in unsorted coordinates:
    # top coords shift by -beta, bottom by +beta.
    top = f > 0
    cand = jnp.concatenate(
        [jnp.where(top, v - 1.0, -v), jnp.where(top, v, 1.0 - v)], axis=-1)
    cand = jnp.maximum(cand, 0.0)                               # [..., 2D]
    zb = jnp.clip(v[..., None, :] - cand[..., :, None] * f[..., None, :],
                  0.0, 1.0)                                     # [..., 2D, D]
    T = (f[..., None, :] * zb).sum(axis=-1)                     # [..., 2D]
    cand = jnp.concatenate([cand, jnp.zeros_like(cand[..., :1])], axis=-1)
    T = jnp.concatenate([T, fz[..., None]], axis=-1)            # [..., 2D+1]

    rr = r[..., None]
    big = jnp.asarray(jnp.inf, dt)
    # Largest candidate with T >= r (beta = 0 qualifies on the non-easy
    # branch since fz > r) and smallest with T <= r (cand contains the
    # largest coordinate's own value, at which the whole top block has
    # clipped to 0, giving T <= 0 <= r). T is monotone non-increasing and
    # has no breakpoint strictly between lo and hi, so it is linear on
    # [lo, hi]: interpolate exactly.
    lo = jnp.max(jnp.where(T >= rr, cand, 0.0), axis=-1)
    hi = jnp.min(jnp.where(T <= rr, cand, big), axis=-1)
    t_lo = jnp.max(jnp.where(cand == lo[..., None], T, -big), axis=-1)
    t_hi = jnp.min(jnp.where(cand == hi[..., None], T, big), axis=-1)

    denom = t_lo - t_hi
    beta = jnp.where(denom > 0, lo + (t_lo - r) * (hi - lo)
                     / jnp.where(denom > 0, denom, 1.0), lo)
    out = jnp.where(easy[..., None], z,
                    jnp.clip(v - beta[..., None] * f, 0.0, 1.0))
    if mask is not None:
        out = jnp.where(mask, out, 0.0)
    return out


def project_check_rows(graph, v_edges: jnp.ndarray) -> jnp.ndarray:
    """Project every check's edge slice of v [..., E] onto its PP_deg.

    Batched equivalent of the reference's per-row CSR loop
    (projection.cpp:266-275): gather to the [..., C, Dc] layout, project
    all rows at once (padding handled by chk_mask), scatter back to edges.
    """
    rows = graph.gather_chk(v_edges, fill=0.0)
    proj = project_parity_polytope(rows, mask=graph.chk_mask)
    return graph.scatter_chk(proj)
