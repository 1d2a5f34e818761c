"""ADMMA: ADMM LP decoding with a learned parity-polytope projection.

Capability parity with the reference's TF1 pipeline (src/admm.py:80-106,
src/parity_polytope/apprx.py, train.py): an MLP (relu hidden layers,
sigmoid output) approximates the exact projection for a fixed regular
check degree; it can be trained offline from random vectors, or online
*during decoding* with the exact projection as the teacher
(admm.py:96-99), and checkpoints under cache/model_<dims>.

Batched re-design: the reference crosses into a TF1 session once per ADMM
iteration (apprx.py:62-63). Here the MLP is a pure-jax function whose
parameters ride the ``lax.while_loop`` carry — so in train mode the
optimizer (optax.adam) steps INSIDE the compiled decode loop: decode and
teacher-student training fuse into one device program, zero host
round-trips. The MLP matmuls are [B*C, D] x [D, H] at the default
matmul precision (TF32 on the GPU's tensor cores; chip_smoke.py holds
its WER on the GPU within Monte-Carlo bounds of the CPU's).

Modes (reference admm.py:89-104):
- train=True: every z-update computes the exact projection (used by the
  decoder) and takes one Adam step toward it.
- train=False: z-update = MLP forward; with ``apprx`` > 0 iterations
  beyond it fall back to the exact projection.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from ldpc_decoders_tpu.ops.graph import TannerGraph
from ldpc_decoders_tpu.ops.projection import project_parity_polytope
from ldpc_decoders_tpu.utils.math import pseudo_to_cw_jnp


# ----------------------------------------------------------------------
# Plain-jax MLP: relu hidden layers + sigmoid output (apprx.py:47-57)
# ----------------------------------------------------------------------

def mlp_init(key, dim: int, layers) -> list:
    sizes = [dim] + list(layers) + [dim]
    params = []
    for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        key, sub = jax.random.split(key)
        scale = jnp.sqrt(6.0 / (n_in + n_out))  # glorot uniform
        W = jax.random.uniform(sub, (n_in, n_out), jnp.float32,
                               -scale, scale)
        params.append({"w": W, "b": jnp.zeros((n_out,), jnp.float32)})
    return params


def mlp_apply(params, x: jnp.ndarray) -> jnp.ndarray:
    for layer in params[:-1]:
        x = jax.nn.relu(x @ layer["w"] + layer["b"])
    last = params[-1]
    return jax.nn.sigmoid(x @ last["w"] + last["b"])


def model_name(dim: int, layers) -> str:
    return "-".join(str(i) for i in [dim] + list(layers) + [dim])


def ckpt_path(cache_dir: str, dim: int, layers) -> str:
    return os.path.join(cache_dir, f"model_{model_name(dim, layers)}.npz")


def save_params(path: str, params) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    flat = {}
    for i, layer in enumerate(params):
        flat[f"w{i}"] = np.asarray(layer["w"])
        flat[f"b{i}"] = np.asarray(layer["b"])
    np.savez(path, **flat)


def load_params(path: str) -> list:
    z = np.load(path)
    n = len([k for k in z.files if k.startswith("w")])
    return [{"w": jnp.asarray(z[f"w{i}"]), "b": jnp.asarray(z[f"b{i}"])}
            for i in range(n)]


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

class _State(NamedTuple):
    x: jnp.ndarray
    z: jnp.ndarray
    lam: jnp.ndarray
    done: jnp.ndarray
    all_done: jnp.ndarray   # scalar: every word (globally, if sharded) done
    updates: jnp.ndarray
    it: jnp.ndarray
    params: list
    opt_state: tuple


class ADMMADecoder:
    """Batched ADMM with learned projection. Host-side it carries the MLP
    parameters across decode() calls (the jitted inner function is pure)."""

    id_keys = ["mu", "eps", "max_iter", "allow_pseudo", "layers"]
    track_iter_hist = True

    def __init__(self, graph: TannerGraph, mu: float = 3.0, eps: float = 1e-5,
                 max_iter: int = 10, allow_pseudo: bool = False,
                 layers=(100, 100), train: bool = False, apprx: int = -1,
                 cache_dir: str = "cache", iter_cap: int = 2000,
                 learning_rate: float = 1e-3, seed: int = 0, **_):
        if len(graph.chk_degrees) != 1:
            # reference admm.py:86-88
            raise ValueError("ADMMA requires a regular check degree")
        self.graph = graph
        self.dim = int(graph.chk_degrees[0])
        self.mu, self.eps = float(mu), float(eps)
        self.max_iter = int(max_iter)
        self.allow_pseudo = bool(allow_pseudo)
        self.iter_cap = self.max_iter if self.max_iter > 0 else int(iter_cap)
        self.thresh = self.eps ** 2 * graph.n_edge
        self.layers = list(layers)
        self.train = bool(train)
        self.switch = int(apprx)
        self.cache_dir = cache_dir or "cache"
        self.opt = optax.adam(learning_rate)

        path = ckpt_path(self.cache_dir, self.dim, self.layers)
        if not self.train:
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"no trained projection model at {path}; run with "
                    "train=True (or the offline trainer) first")
            self.params = load_params(path)
        else:
            self.params = mlp_init(jax.random.PRNGKey(seed), self.dim,
                                   self.layers)
        self.opt_state = self.opt.init(self.params)
        self._decode = jax.jit(self._decode_impl)

    # -- persistence ----------------------------------------------------
    def save(self) -> str:
        path = ckpt_path(self.cache_dir, self.dim, self.layers)
        save_params(path, self.params)
        return path

    # -- projection variants --------------------------------------------
    def _rows(self, v_edges):
        g = self.graph
        return g.gather_chk(v_edges, fill=0.0).reshape(
            v_edges.shape[0] * g.n_chk, self.dim)

    def _unrows(self, rows, batch):
        g = self.graph
        return g.scatter_chk(rows.reshape(batch, g.n_chk, self.dim))

    def _decode_impl(self, gamma, params, opt_state, axis_name=None):
        """Pure decode + train step. With ``axis_name`` set (shard_map over
        a batch mesh) this is synchronous data-parallel training: grads
        pmean over the axis keep the replicated params/optimizer in
        lockstep, and the loop runs until every word on every device is
        done (a collective in the carried flag, so all devices execute the
        same iteration count and the grad collectives line up)."""
        g = self.graph
        B = gamma.shape[0]
        var_deg = g.var_deg.astype(jnp.float32)

        def exact_rows(rows):
            return project_parity_polytope(rows)

        def loss_fn(p, rows, target):
            return jnp.mean((mlp_apply(p, rows) - target) ** 2)

        def projection(s_it, params, opt_state, v_edges):
            rows = self._rows(v_edges)
            if self.train:
                target = exact_rows(rows)
                grads = jax.grad(loss_fn)(params, rows, target)
                if axis_name is not None:
                    grads = lax.pmean(grads, axis_name)
                upd, opt_state = self.opt.update(grads, opt_state, params)
                params = optax.apply_updates(params, upd)
                z_rows = target        # decode with the teacher (admm.py:97)
            elif self.switch > 0:
                # Reference admm.py:101 (`0 < switch < iter_count`): the
                # MLP serves iterations 0..switch INCLUSIVE.
                z_rows = lax.cond(s_it <= self.switch,
                                  lambda r: mlp_apply(params, r),
                                  exact_rows, rows)
            else:
                z_rows = mlp_apply(params, rows)
            return self._unrows(z_rows, B), params, opt_state

        def body(s: _State):
            x = jnp.clip(
                (g.sum_per_var(s.z - s.lam / self.mu) - gamma / self.mu)
                / var_deg, 0.0, 1.0)
            x_e = g.expand_var(x)
            z_new, params, opt_state = projection(
                s.it, s.params, s.opt_state, x_e + s.lam / self.mu)
            lam = s.lam + self.mu * (x_e - z_new)
            close = (((x_e - z_new) ** 2).sum(-1) < self.thresh) \
                & (((s.z - z_new) ** 2).sum(-1) < self.thresh)
            active = ~s.done
            m = active[:, None]
            done = s.done | (active & close)
            all_done = done.all()
            if axis_name is not None:
                all_done = lax.pmin(all_done.astype(jnp.int32),
                                    axis_name) == 1
            return _State(
                x=jnp.where(m, x, s.x), z=jnp.where(m, z_new, s.z),
                lam=jnp.where(m, lam, s.lam),
                done=done, all_done=all_done,
                updates=s.updates + active.astype(jnp.int32),
                it=s.it + 1, params=params, opt_state=opt_state)

        def cond(s: _State):
            return (s.it < self.iter_cap) & ~s.all_done

        init = _State(
            x=jnp.zeros((B, g.n_var), jnp.float32),
            z=jnp.full((B, g.n_edge), 0.5, jnp.float32),
            lam=jnp.zeros((B, g.n_edge), jnp.float32),
            done=jnp.zeros(B, bool),
            all_done=jnp.asarray(False),
            updates=jnp.zeros(B, jnp.int32),
            it=jnp.zeros((), jnp.int32),
            params=params, opt_state=opt_state)

        final = lax.while_loop(cond, body, init)
        x_hat = pseudo_to_cw_jnp(final.x, self.allow_pseudo)
        iters = jnp.where(final.done, final.updates - 1, final.updates)
        return x_hat, iters, final.params, final.opt_state

    # The harness must NOT close over decode() inside its own jit: the
    # parameter update is host-side state (see `stateful`), and tracing
    # it would silently discard training and leak tracers into
    # self.params. The runner dispatches stateful decoders eagerly
    # (self._decode is jitted internally, so the hot loop still compiles)
    # — OR threads the state functionally through begin_pure()/end_pure()
    # when sharding over a mesh.
    stateful = True

    # -- functional-state protocol (mesh sharding) ----------------------
    def get_state(self):
        return self.params, self.opt_state

    def set_state(self, state) -> None:
        self.params, self.opt_state = state

    def begin_pure(self, state, axis_name=None) -> None:
        """Enter pure mode: the next decode() call (typically under an
        outer trace, e.g. the harness's shard_map'd chunk) consumes
        ``state`` and leaves the updated state for end_pure() instead of
        mutating host attributes. Tracing is single-threaded, so the side
        channel is sound: state flows only through the traced function's
        arguments and results."""
        self._pure = [state, axis_name]

    def end_pure(self):
        state, _ = self._pure
        self._pure = None
        return state

    _pure = None

    def decode(self, llr: jnp.ndarray, key=None) -> tuple:
        import jax.core

        if self._pure is not None:
            (params, opt_state), axis_name = self._pure
            x_hat, iters, params, opt_state = self._decode_impl(
                llr.astype(jnp.float32), params, opt_state,
                axis_name=axis_name)
            self._pure = [(params, opt_state), axis_name]
            return x_hat, iters
        if isinstance(llr, jax.core.Tracer):
            raise RuntimeError(
                "ADMMADecoder.decode must not be traced by an outer jit: "
                "its parameter/optimizer state update is a host-side "
                "side effect (use begin_pure()/end_pure() to thread the "
                "state functionally, or let the harness drive it eagerly "
                "via the `stateful` attribute)")
        x_hat, iters, params, opt_state = self._decode(
            llr.astype(jnp.float32), self.params, self.opt_state)
        if self.train:
            self.params, self.opt_state = params, opt_state
        return x_hat, iters



# ----------------------------------------------------------------------
# Offline trainer (reference parity_polytope/train.py:35-44)
# ----------------------------------------------------------------------

def train_offline(dim: int, layers, steps: int = 10000, batch: int = 1024,
                  cache_dir: str = "cache", learning_rate: float = 1e-3,
                  seed: int = 0, log_every: int = 500):
    """Train the MLP against the exact batched projection on random rows
    from [0,1)^dim; returns (params, final eval loss)."""
    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    params = mlp_init(sub, dim, list(layers))
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, key):
        x = jax.random.uniform(key, (batch, dim))
        y = project_parity_polytope(x)
        loss, grads = jax.value_and_grad(
            lambda p: jnp.mean((mlp_apply(p, x) - y) ** 2))(params)
        upd, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    loss = None
    for i in range(steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step(params, opt_state, sub)
        if log_every and i % log_every == 0:
            print(f"step {i} loss {float(loss):.6f}")
    save_params(ckpt_path(cache_dir, dim, list(layers)), params)
    return params, float(loss)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="offline projection training")
    p.add_argument("dim", type=int)
    p.add_argument("--layers", nargs="+", type=int, default=[100, 100])
    p.add_argument("--steps", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--cache_dir", default="cache")
    args = p.parse_args(argv)
    _, loss = train_offline(args.dim, args.layers, args.steps, args.batch,
                            args.cache_dir)
    print("final loss", loss)


if __name__ == "__main__":
    main()
