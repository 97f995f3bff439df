"""A small module layer: dataclass modules with lazily created parameters.

The models are written as trees of modules in the style the reference's
PyTorch code and most JAX codebases use. This layer covers exactly what
they need, and nothing else:

  * ``Module``: subclasses are dataclasses. A module built inside another
    module's :func:`compact` method becomes its child, named ``name=`` or,
    when unnamed, ``<ClassName>_<n>`` (n counts that class's unnamed
    children of the parent). Parameter trees nest by those names.
  * :func:`compact` marks the method (``__call__``) that runs inside the
    module's scope; only there, and in helpers it calls, may
    :meth:`Module.param` declare parameters.
  * ``init(key, *args)`` runs the forward once and returns
    ``{"params": tree}``; ``apply({"params": tree}, *args)`` runs it with
    the given parameters. Each parameter's initial value is drawn from
    ``key`` folded with a SHA-1 hash of its module path and its index
    among that module's parameters; this is the derivation Flax uses, so
    a seed gives the same initial weights as the Flax version of these
    models did.
  * :func:`remat` wraps a module class so that its call is recomputed in
    the backward pass (``jax.checkpoint``), with its parameters passed in.
  * :class:`GroupNorm` and :func:`tabulate` (a per-call parameter table).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["Module", "compact", "remat", "GroupNorm", "tabulate",
           "param_count"]

_local = threading.local()


def _stack() -> List["_Scope"]:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


class _Scope:
    """The parameters of one module during one call of ``init``/``apply``."""

    def __init__(self, params: Dict[str, Any], path: Tuple[str, ...],
                 key: Optional[jax.Array], recorder: Optional[list]):
        self.params = params
        self.path = path
        self.key = key            # None in apply mode
        self.recorder = recorder  # tabulate's rows, or None
        self.child_names: set = set()
        self.auto_counts: Dict[str, int] = {}
        self.declared: set = set()
        self.n_created = 0  # parameters created so far (init mode)

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def child(self, name: str) -> "_Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        if not isinstance(sub, dict):
            raise ValueError(f"{'/'.join(self.path + (name,))} is a "
                             "parameter, not a submodule")
        return _Scope(sub, self.path + (name,), self.key, self.recorder)


@dataclasses.dataclass(eq=False, repr=False)
class Module:
    """Base class; every subclass is turned into a dataclass. ``name`` is a
    keyword-only field of all of them."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False, repr=False)

    def __post_init__(self):
        # Bind to the module whose compact method is running, if any.
        stack = _stack()
        parent = stack[-1] if stack else None
        name = self.name
        if parent is not None:
            if name is None:
                cls_name = type(self).__name__
                n = parent.auto_counts.get(cls_name, 0)
                parent.auto_counts[cls_name] = n + 1
                name = f"{cls_name}_{n}"
            if name in parent.child_names:
                raise ValueError(
                    f"duplicate submodule name {name!r} in "
                    f"{'/'.join(parent.path) or '<root>'}")
            parent.child_names.add(name)
        object.__setattr__(self, "_parent_scope", parent)
        object.__setattr__(self, "_bound_name", name)
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_root", None)

    def __repr__(self):
        return f"{type(self).__name__}(name={self._bound_name!r})"

    # -- parameters -------------------------------------------------------
    def param(self, name: str, init_fn: Callable, shape, dtype=jnp.float32):
        scope = self._scope
        if scope is None:
            raise RuntimeError(
                f"{type(self).__name__}.param({name!r}) called outside a "
                "compact method: parameters are declared while the module "
                "runs inside init/apply")
        full = "/".join(scope.path + (name,))
        if name in scope.declared:
            raise ValueError(f"parameter {full!r} declared twice")
        scope.declared.add(name)
        shape = tuple(int(s) for s in shape)
        if scope.initializing and name not in scope.params:
            scope.n_created += 1
            key = _fold_in_path(scope.key, scope.path + (scope.n_created,))
            scope.params[name] = init_fn(key, shape, dtype)
        if name not in scope.params:
            raise KeyError(f"missing parameter {full!r}")
        value = scope.params[name]
        if isinstance(value, dict) or tuple(value.shape) != shape:
            got = "a submodule" if isinstance(value, dict) else value.shape
            raise ValueError(f"parameter {full!r}: expected shape {shape}, "
                             f"got {got}")
        return value

    # -- entry points -----------------------------------------------------
    def init(self, key, *args, **kwargs) -> Dict[str, Any]:
        if isinstance(key, dict):
            key = key["params"]
        params: Dict[str, Any] = {}
        with self._as_root(_Scope(params, (), key, None)):
            self(*args, **kwargs)
        return {"params": _prune(params)}

    def apply(self, variables, *args, **kwargs):
        params = variables["params"]
        with self._as_root(_Scope(params, (), None, None)):
            return self(*args, **kwargs)

    @contextlib.contextmanager
    def _as_root(self, scope):
        if self._parent_scope is not None:
            raise RuntimeError("init/apply must be called on a top-level "
                               "module, not on a submodule")
        prev = self._root
        object.__setattr__(self, "_root", scope)
        try:
            yield
        finally:
            object.__setattr__(self, "_root", prev)

    def _new_scope(self) -> _Scope:
        if self._root is not None:
            root = self._root
            # a fresh per-call view of the root parameters
            return _Scope(root.params, (), root.key, root.recorder)
        parent = self._parent_scope
        if parent is None:
            raise RuntimeError(
                f"{type(self).__name__} is not bound: call it through "
                "init/apply, or build it inside another module's compact "
                "method")
        return parent.child(self._bound_name)


def _fold_in_path(key, parts) -> jax.Array:
    """``key`` folded with the first 4 bytes of SHA-1 over ``parts``
    (strings as UTF-8, ints as minimal big-endian bytes)."""
    m = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


def _prune(tree):
    """Drop submodules that hold no parameters."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


@contextlib.contextmanager
def _entered(module: Module, scope: _Scope):
    prev = module._scope
    object.__setattr__(module, "_scope", scope)
    stack = _stack()
    stack.append(scope)
    try:
        yield
    finally:
        stack.pop()
        object.__setattr__(module, "_scope", prev)


def compact(fn):
    """Run ``fn`` inside the module's scope (parameters + child names)."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        scope = self._new_scope()
        if getattr(self, "_remat", False) and not scope.initializing:
            out = _remat_call(fn, self, scope, args, kwargs)
        else:
            with _entered(self, scope):
                out = fn(self, *args, **kwargs)
        if scope.recorder is not None:
            scope.recorder.append((scope.path, type(self).__name__,
                                   _shapes(out), param_count(scope.params)))
        return out

    return wrapped


def _remat_call(fn, module, scope, args, kwargs):
    def body(params, args, kwargs):
        inner = _Scope(params, scope.path, None, None)
        with _entered(module, inner):
            return fn(module, *args, **kwargs)

    return jax.checkpoint(body)(scope.params, args, kwargs)


def remat(module_cls):
    """``module_cls`` whose calls are rematerialized in the backward pass
    (parameters, paths and forward values unchanged)."""
    return type(module_cls.__name__, (module_cls,),
                {"_remat": True, "__module__": module_cls.__module__})


def _shapes(tree):
    return [tuple(leaf.shape) for leaf in jax.tree_util.tree_leaves(tree)
            if hasattr(leaf, "shape")]


def param_count(params) -> int:
    return int(sum(int(np.prod(leaf.shape))
                   for leaf in jax.tree_util.tree_leaves(params)))


def tabulate(module: Module, *args) -> Tuple[str, list]:
    """Shape-only trace of ``module.init``: a text table with one row per
    module call (path, class, output shapes, parameters under it), in call
    order, and the rows themselves. Runs nothing on a device."""
    rows: list = []

    def run(*a):
        params: Dict[str, Any] = {}
        with module._as_root(_Scope(params, (), jax.random.PRNGKey(0),
                                    rows)):
            module(*a)
        return _prune(params)

    params = jax.eval_shape(run, *args)
    # the root call is recorded last; show it first
    rows = rows[-1:] + rows[:-1]
    lines = [f"{'path':<44} {'module':<26} {'params':>12}  outputs"]
    for path, type_name, shapes, n in rows:
        label = "/".join(path) or "<root>"
        out = ", ".join(str(s) for s in shapes)
        lines.append(f"{label:<44} {type_name:<26} {n:>12,}  {out}")
    lines.append(f"Total parameters: {param_count(params):,}")
    return "\n".join(lines) + "\n", rows


class GroupNorm(Module):
    """Group normalization over all non-batch axes, channels last, with a
    learned per-channel ``scale`` (init 1) and ``bias`` (init 0).
    Statistics are taken in at least float32 (E[x^2] - E[x]^2, clipped at
    0); the output takes the promoted type of input and parameters."""
    num_groups: int = 32
    epsilon: float = 1e-6

    @compact
    def __call__(self, x):
        c = x.shape[-1]
        g = self.num_groups
        if g <= 0 or c % g:
            raise ValueError(f"{g} groups do not divide {c} channels")
        stat_dtype = jnp.promote_types(x.dtype, jnp.float32)
        xg = x.astype(stat_dtype).reshape(x.shape[:-1] + (g, c // g))
        axes = tuple(range(1, xg.ndim - 2)) + (xg.ndim - 1,)
        mean = xg.mean(axes)
        mean2 = (xg * xg).mean(axes)
        var = jnp.maximum(0.0, mean2 - mean * mean)
        # (B, g) -> (B, 1.., C)
        bshape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
        mean = jnp.repeat(mean, c // g, axis=-1).reshape(bshape)
        var = jnp.repeat(var, c // g, axis=-1).reshape(bshape)
        scale = self.param("scale", lambda k, s, d: jnp.ones(s, d), (c,))
        bias = self.param("bias", lambda k, s, d: jnp.zeros(s, d), (c,))
        y = x - mean
        y = y * (jax.lax.rsqrt(var + self.epsilon) * scale)
        y = y + bias
        return y.astype(jnp.result_type(x, scale, bias))
