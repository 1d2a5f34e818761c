"""Parity-polytope projection demos in 2D/3D.

Capability parity with reference src/parity_polytope/plot.py:32-123
(interactive demos showing points and their projections onto PP_2/PP_3);
here rendered headlessly to files, with the batched JAX projection
supplying them.
"""

from __future__ import annotations

import argparse

import numpy as np


def _plt(agg=True):
    import matplotlib
    if agg:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def demo_2d(n_points: int = 40, seed: int = 0, out: str = "polytope_2d.png"):
    """PP_2 = conv{(0,0), (1,1)}: a segment; points project onto it."""
    import jax.numpy as jnp

    from ldpc_decoders_tpu.ops.projection import project_parity_polytope

    rng = np.random.default_rng(seed)
    v = rng.normal(0.5, 0.8, (n_points, 2))
    z = np.asarray(project_parity_polytope(jnp.asarray(v, jnp.float32)))

    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot([0, 1], [0, 1], "k-", linewidth=3, label="PP$_2$")
    ax.scatter(v[:, 0], v[:, 1], c="tab:red", s=18, label="inputs")
    ax.scatter(z[:, 0], z[:, 1], c="tab:blue", s=18, label="projections")
    for a, b in zip(v, z):
        ax.plot([a[0], b[0]], [a[1], b[1]], "gray", linewidth=0.6)
    ax.set_aspect("equal"), ax.legend(), ax.grid(True)
    ax.set_title("Euclidean projection onto the parity polytope, d=2")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    return out


def demo_3d(n_points: int = 60, seed: int = 0, out: str = "polytope_3d.png"):
    """PP_3 = conv{000, 011, 101, 110}: a tetrahedron."""
    import jax.numpy as jnp

    from ldpc_decoders_tpu.ops.projection import project_parity_polytope

    rng = np.random.default_rng(seed)
    v = rng.normal(0.5, 0.7, (n_points, 3))
    z = np.asarray(project_parity_polytope(jnp.asarray(v, jnp.float32)))

    plt = _plt()
    fig = plt.figure(figsize=(7, 7))
    ax = fig.add_subplot(111, projection="3d")
    verts = np.array([[0, 0, 0], [0, 1, 1], [1, 0, 1], [1, 1, 0]], float)
    for i in range(4):
        for j in range(i + 1, 4):
            ax.plot(*zip(verts[i], verts[j]), "k-", linewidth=1.5)
    ax.scatter(*v.T, c="tab:red", s=14, label="inputs")
    ax.scatter(*z.T, c="tab:blue", s=14, label="projections")
    for a, b in zip(v, z):
        ax.plot(*zip(a, b), color="gray", linewidth=0.5)
    ax.legend()
    ax.set_title("Euclidean projection onto the parity polytope, d=3")
    fig.savefig(out, dpi=120, bbox_inches="tight")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="parity polytope demos")
    p.add_argument("dim", type=int, choices=[2, 3])
    p.add_argument("--out", default=None)
    p.add_argument("--points", type=int, default=40)
    args = p.parse_args(argv)
    fn = demo_2d if args.dim == 2 else demo_3d
    print(fn(n_points=args.points,
             out=args.out or f"polytope_{args.dim}d.png"))


if __name__ == "__main__":
    main()
