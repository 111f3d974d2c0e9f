"""Differentiable graphs: gradients of compiled texture programs.

The reference is a Rust engine — its graphs are opaque imperative pixel
loops. Here a fused `CompiledGraph` is a pure jittable function of its leaf
bindings, so JAX transforms compose with it for free: this module exposes
gradients w.r.t. `Value` nodes and a small fitting loop (inverse procedural
texturing — recover graph parameters from a target image by gradient
descent). No counterpart exists in the reference; this is a capability the
JAX design gets structurally.

Notes:
- Gradients flow through every op (all kernels are plain jnp
  formulations — see `ops/height_to_normal.py`'s lowering note).
- Losses are computed on the f32 channel planes; the u8 export (truncating
  cast) is intentionally outside the differentiable path.
- `jnp.clip` in the resampler gives zero gradient outside [0, 1] — the
  same saturation behavior a user would expect from the render.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .ids import NodeId, SlotId


def value_grad_fn(prog, loss_fn: Callable, wrt: list) -> Callable:
    """`f(params) -> (loss, grads)`, jitted.

    `params` is `{node_id: float}` over `wrt` (Value nodes); `loss_fn`
    receives `{(node_id, slot_id): (planes...)}` for the program's targets
    and returns a scalar.

    Every `wrt` id must name a TOP-LEVEL Value node of the program —
    otherwise the param key would be silently unused and its gradient
    exactly 0.0 (nested-graph Value nodes bind under `g<graph_id>_value_*`
    keys and are not fittable through this helper).

    The program's other bindings are passed as ARGUMENTS on every call (not
    closed over): a closure would bake image/input planes into the jitted
    gradient program as XLA compile-time constants — the const-fold
    rounding hazard `compiler._const_guard` exists for — and would go
    silently stale after `prog.set_value`/`bind_input`.
    """
    import jax

    from .errors import ErrorKind, TexProError

    wrt_keys = [f"value_{int(n)}" for n in wrt]
    missing = [k for k in wrt_keys if k not in prog._bindings]
    if missing:
        raise TexProError(
            ErrorKind.INVALID_NODE_ID,
            f"not top-level Value bindings of this program: {missing} "
            "(nested-graph Values bind as g<graph_id>_value_* and cannot "
            "be fitted through value_grad_fn)",
        )

    def wrapped(params: dict, base: dict):
        args = dict(base)
        for node_id, key in zip(wrt, wrt_keys):
            args[key] = params[int(node_id)]
        return loss_fn(prog._raw_fn(args))

    jitted = jax.jit(jax.value_and_grad(wrapped))

    def f(params: dict):
        return jitted(params, dict(prog._bindings))

    f._jitted = jitted  # two-arg form, for callers composing under jit
    return f


def fit_values(
    prog,
    targets: dict,
    wrt: list,
    steps: int = 200,
    learning_rate: float = 0.1,
    optimizer=None,
    init: Optional[dict] = None,
):
    """Fit `Value` nodes so the program's target planes match `targets`.

    `targets` maps `(node_id, slot_id)` (the program's target keys) to a
    tuple/list of reference planes. Returns `(values, losses)` where
    `values` is `{node_id: fitted float}` and `losses` the per-step MSE
    trajectory. Uses optax (Adam by default); the fitted values are NOT
    written back into the program's bindings — call `prog.set_value` with
    the results to adopt them.
    """
    import jax
    import jax.numpy as jnp
    import optax

    target_arrays = {
        key: tuple(jnp.asarray(p, jnp.float32) for p in planes)
        for key, planes in targets.items()
    }

    def loss_fn(outs):
        total = jnp.float32(0.0)
        for key, ref_planes in target_arrays.items():
            for got, ref in zip(outs[key], ref_planes):
                total = total + jnp.mean((got - ref) ** 2)
        return total

    grad_fn = value_grad_fn(prog, loss_fn, wrt)._jitted

    params = {
        int(n): jnp.float32(
            (init or {}).get(int(n), float(np.asarray(prog._bindings[f"value_{int(n)}"])))
        )
        for n in wrt
    }
    optimizer = optimizer or optax.adam(learning_rate)
    opt_state = optimizer.init(params)

    # bindings ride as step ARGUMENTS (see value_grad_fn's docstring) —
    # closing over them here would re-bake them as trace constants
    @jax.jit
    def step(params, opt_state, base):
        loss, grads = grad_fn(params, base)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, dict(prog._bindings))
        losses.append(float(loss))

    return {NodeId(k): float(v) for k, v in params.items()}, losses
