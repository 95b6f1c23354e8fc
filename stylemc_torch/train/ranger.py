"""Ranger (RAdam + Lookahead + gradient centralization) over trees of
tensors (counterpart of `stylemc_tpu/train/ranger.py`), written to
optax's arithmetic: gradient centralization, then optax's
`scale_by_radam`, optional decayed weights, −lr, and lookahead last.

A transform is a pair of functions over nested dicts of tensors, as an
optax `GradientTransformation` is: `init(params) → state` and
`update(grads, state, params) → (updates, state)`; `apply_updates` adds
the updates to the params in place. States are nested dicts of tensors
(and Python ints), so a checkpoint stores them as numpy arrays.

The schedule's scalars (β^t, the SMA ρ_t and its rectification) are
float32, as optax computes them, on the host; XLA's float32 pow and
torch's may differ in the last bit. No transform synchronises with the
device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import torch

Tree = Dict[str, Any]


class GradientTransformation(NamedTuple):
    init: Callable[[Tree], Any]
    update: Callable[..., Any]


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of nested dicts of the same layout."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def apply_updates(params: Tree, updates: Tree) -> None:
    """params += updates, in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(tree_leaves(params), tree_leaves(updates)):
            p.add_(u.to(p.dtype))


def _f32(v: float) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init_fn(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update_fn(updates, state, params=None):
        new_state = {}
        for i, t in enumerate(transforms):
            updates, new_state[str(i)] = t.update(updates, state[str(i)],
                                                  params)
        return updates, new_state

    return GradientTransformation(init_fn, update_fn)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """optax's clip: g · max_norm / ‖g‖ when ‖g‖ ≥ max_norm, with
    ‖g‖ = sqrt(Σ g²) over every leaf (no epsilon, unlike
    `torch.nn.utils.clip_grad_norm_`)."""
    def update_fn(updates, state, params=None):
        g_norm = torch.sqrt(sum(torch.sum(g.square())
                                for g in tree_leaves(updates)))
        trigger = g_norm < max_norm
        return tree_map(lambda g: torch.where(
            trigger, g, (g / g_norm.to(g.dtype)) * max_norm), updates), state

    return GradientTransformation(lambda params: {}, update_fn)


def gradient_centralization(conv_only: bool = False) -> GradientTransformation:
    """Subtract the mean over every axis but the first from gradients with
    ndim > 1 (> 3 when `conv_only`)."""
    threshold = 3 if conv_only else 1

    def gc(g):
        if g.ndim > threshold:
            return g - g.mean(dim=tuple(range(1, g.ndim)), keepdim=True)
        return g

    return GradientTransformation(
        lambda params: {}, lambda updates, state, params=None:
        (tree_map(gc, updates), state))


def scale_by_radam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   threshold: float = 5.0) -> GradientTransformation:
    """optax.scale_by_radam: bias-corrected Adam moments; while the SMA
    ρ_t is below `threshold` the update is the corrected first moment
    alone, after it r_t · m̂ / (sqrt(v̂) + eps)."""
    ro_inf = 2.0 / (1.0 - b2) - 1.0

    def init_fn(params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update_fn(updates, state, params=None):
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, updates, state["mu"])
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, updates,
                      state["nu"])
        count = state["count"] + 1
        b1t, b2t = _f32(b1) ** count, _f32(b2) ** count
        ro = _f32(ro_inf) - 2 * _f32(count) * b2t / (1 - b2t)
        # float32 values as Python floats: a tensor times a Python float
        # stays in the tensor's dtype, and no scalar is copied to a device
        c1, c2 = (1 - b1t).item(), (1 - b2t).item()
        mu_hat = tree_map(lambda t: t / c1, mu)
        if float(ro) >= threshold:
            r = torch.sqrt((ro - 4.0) * (ro - 2.0) * _f32(ro_inf)
                           / ((_f32(ro_inf) - 4.0) * (_f32(ro_inf) - 2.0)
                              * ro)).item()
            out = tree_map(lambda m, v: r * m / (torch.sqrt(v / c2) + eps),
                           mu_hat, nu)
        else:
            out = mu_hat
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init_fn, update_fn)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: {}, lambda updates, state, params=None:
        (tree_map(lambda u, p: u + weight_decay * p, updates, params), state))


def scale(step_size: float) -> GradientTransformation:
    return GradientTransformation(
        lambda params: {}, lambda updates, state, params=None:
        (tree_map(lambda u: u * step_size, updates), state))


def scale_by_schedule(fn: Callable[[int], float]) -> GradientTransformation:
    """updates · fn(count), count from 0 (optax.scale_by_schedule)."""
    def update_fn(updates, state, params=None):
        step = fn(state["count"])
        return (tree_map(lambda u: u * step, updates),
                {"count": state["count"] + 1})

    return GradientTransformation(lambda params: {"count": 0}, update_fn)


def lookahead(k: int = 6, alpha: float = 0.5) -> GradientTransformation:
    """Lookahead as the last transform: every k steps the slow weights move
    alpha of the way to the fast ones and the params jump to them. The
    incoming updates are final parameter deltas (after −lr)."""
    def init_fn(params):
        return {"slow": tree_map(lambda p: p.detach().clone(), params),
                "count": 0}

    def update_fn(updates, state, params):
        count = state["count"] + 1
        sync = count % k == 0

        def leaf(u, p, s):
            fast = p + u
            if sync:
                slow = s + alpha * (fast - s)
                return slow - p, slow
            return fast - p, s

        pairs = tree_map(leaf, updates, params, state["slow"])
        return (tree_map(lambda pair: pair[0], pairs),
                {"slow": tree_map(lambda pair: pair[1], pairs),
                 "count": count})

    return GradientTransformation(init_fn, update_fn)


def ranger(learning_rate: Union[float, Callable[[int], float]],
           alpha: float = 0.5, k: int = 6, n_sma_threshold: int = 5,
           b1: float = 0.95, b2: float = 0.999, eps: float = 1e-5,
           weight_decay: float = 0.0, use_gc: bool = True,
           gc_conv_only: bool = False) -> GradientTransformation:
    parts = []
    if use_gc:
        parts.append(gradient_centralization(gc_conv_only))
    parts.append(scale_by_radam(b1=b1, b2=b2, eps=eps,
                                threshold=float(n_sma_threshold)))
    if weight_decay:
        parts.append(add_decayed_weights(weight_decay))
    if callable(learning_rate):
        parts.append(scale_by_schedule(lambda c: -learning_rate(c)))
    else:
        parts.append(scale(-learning_rate))
    parts.append(lookahead(k=k, alpha=alpha))
    return chain(*parts)
