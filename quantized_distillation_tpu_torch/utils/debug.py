"""Numeric sanitizers and determinism checks (PyTorch port of the JAX
package's ``utils/debug.py``).

- :func:`find_nonfinite`: sweep a tree of tensors (dicts, lists, tuples,
  named tuples, dataclasses such as ``TrainState``) and name the leaves
  that hold NaN or Inf.
- :func:`checked`: the counterpart of the JAX package's checkify wrapper:
  run a function under ``torch.autograd.detect_anomaly()`` (a backward pass
  that makes a NaN raises at the op that made it) and sweep its outputs,
  raising :class:`NonFiniteError` that names the first non-finite leaf.
- :func:`assert_deterministic`: run a function twice on the same inputs and
  require bitwise-equal outputs.
- :func:`grad_health`: norm, largest magnitude and non-finite count of a
  gradient tree.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch


class NonFiniteError(RuntimeError):
    """A function wrapped by :func:`checked` returned NaN or Inf."""


def leaves_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` for every leaf of ``tree``, the path ``a/b/0``."""
    def join(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_path(v, join(k))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from leaves_with_path(getattr(tree, k), join(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, join(i))
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from leaves_with_path(getattr(tree, f.name), join(f.name))
    elif tree is not None:
        yield prefix, tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def find_nonfinite(tree: Any, prefix: str = "") -> List[str]:
    """Paths of the floating-point leaves holding NaN or Inf (copies each
    leaf to the host)."""
    bad = []
    for path, leaf in leaves_with_path(tree, prefix):
        arr = _host(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            bad.append(path)
    return bad


def checked(fn: Callable) -> Callable:
    """``fn`` run under ``torch.autograd.detect_anomaly()``, its outputs
    swept by :func:`find_nonfinite`: raises :class:`NonFiniteError` naming
    the first leaf with a NaN or Inf (the backward passes ``fn`` runs raise
    at the op that made one)."""

    def run(*args, **kwargs):
        with torch.autograd.detect_anomaly():
            out = fn(*args, **kwargs)
        bad = find_nonfinite(out)
        if bad:
            raise NonFiniteError(f"non-finite value (NaN or Inf) in output leaf {bad[0]!r}"
                                 f" ({len(bad)} leaves in all)")
        return out

    return run


def assert_deterministic(fn: Callable, *args, runs: int = 2, **kwargs) -> None:
    """Run ``fn`` ``runs`` times on the same inputs; raise AssertionError
    unless every run's outputs equal the first's bit for bit (NaNs equal).
    Catches nondeterministic reductions, unseeded randomness, and inputs
    mutated by a run."""
    outs = [[(p, _host(x).copy()) for p, x in leaves_with_path(fn(*args, **kwargs))]
            for _ in range(runs)]
    ref = outs[0]
    for i, other in enumerate(outs[1:], start=2):
        mism = []
        for (path, a), (_, b) in zip(ref, other):
            if not np.array_equal(a, b, equal_nan=True):
                diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
                mism.append((path, float(np.max(diff))))
        if mism or len(ref) != len(other):
            raise AssertionError(f"run {i} differs from run 1 at {len(mism)} leaves: {mism[:5]}")


def grad_health(grads: Any) -> Dict[str, float]:
    """Global norm, largest |value| (NaN if any value is) and count of
    non-finite values of a gradient tree."""
    leaves = [torch.as_tensor(g).detach().float() for _, g in leaves_with_path(grads)]
    if not leaves:
        return {"norm": 0.0, "max_abs": 0.0, "nonfinite": 0.0}
    return {
        "norm": float(torch.sqrt(sum(torch.sum(g * g) for g in leaves))),
        "max_abs": float(torch.stack([g.abs().max() for g in leaves]).max()),  # NaN wins
        "nonfinite": float(sum((~torch.isfinite(g)).sum() for g in leaves)),
    }
