"""Experiment manager: checkpoints and a run registry (PyTorch port of the
JAX package's ``train/manager.py``; same ``registry.json`` schema, same
methods).

A small persistent registry maps model name → its config, its latest
checkpoint step and the list of runs made on it, so a driver can reload a
model and go on. Checkpoints are ``torch.save`` files in place of orbax's,
one per step under ``<root>/<name>/checkpoints/<step>.pt``, holding only
what ``torch.load(weights_only=True)`` reads back: tensors (on the CPU),
dicts, lists, tuples, ints, strings and None. A :class:`.trainer.TrainState`
is stored as a dict of its fields, its ``OptState`` as a dict too.

:meth:`ExperimentManager.restore` copies a checkpoint into the tensors of a
template in place (a train state's parameters are the model's own, so the
model then holds the restored weights) and returns the template's
structure with the stored step, optimizer count and carry.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import torch

from .optim import OptState
from .trainer import TrainState

_STATE_FIELDS = ("step", "params", "opt_state", "batch_stats", "codebooks", "carry")


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, OptState):
        return {"count": tree.count, "mu": _to_cpu(tree.mu), "nu": _to_cpu(tree.nu)}
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_cpu(v) for v in tree)
    if tree is None or isinstance(tree, (int, float, str, bool)):
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _copy_into(template, stored, where: str = "state"):
    """``stored`` copied into ``template``'s tensors in place, recursively;
    → the template's structure holding them (non-tensor leaves from
    ``stored``)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(stored, torch.Tensor) or stored.shape != template.shape:
            raise ValueError(f"checkpoint {where}: {getattr(stored, 'shape', stored)} "
                             f"does not fit a tensor of shape {tuple(template.shape)}")
        with torch.no_grad():
            template.copy_(stored)
        return template
    if isinstance(template, OptState):
        return OptState(stored["count"], _copy_into(template.mu, stored["mu"], f"{where}/mu"),
                        _copy_into(template.nu, stored["nu"], f"{where}/nu"))
    if isinstance(template, dict):
        if not isinstance(stored, dict) or set(stored) != set(template):
            raise ValueError(f"checkpoint {where}: keys differ from the template's")
        return {k: _copy_into(v, stored[k], f"{where}/{k}") for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        if len(stored) != len(template):
            raise ValueError(f"checkpoint {where}: {len(stored)} entries, template "
                             f"{len(template)}")
        return type(template)(_copy_into(t, s, f"{where}/{i}")
                              for i, (t, s) in enumerate(zip(template, stored)))
    if template is None and stored is not None:
        raise ValueError(f"checkpoint {where}: the template has None")
    return stored


class ExperimentManager:
    """name → (checkpoints, run ledger) under a root directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._registry_path = os.path.join(self.root, "registry.json")
        self._registry = self._load_registry()

    # ---- registry ----
    def _load_registry(self) -> Dict:
        if os.path.exists(self._registry_path):
            with open(self._registry_path) as f:
                return json.load(f)
        return {"models": {}}

    def _flush(self) -> None:
        tmp = self._registry_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._registry, f, indent=2, default=str)
        os.replace(tmp, self._registry_path)

    def add_new_model(self, name: str, config: Optional[Dict] = None) -> None:
        """Register a model."""
        if name in self._registry["models"]:
            raise ValueError(f"model {name!r} already registered")
        self._registry["models"][name] = {
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "config": config or {},
            "runs": [],
            "latest_step": None,
        }
        self._flush()

    def has_model(self, name: str) -> bool:
        return name in self._registry["models"]

    def list_models(self) -> List[str]:
        return sorted(self._registry["models"])

    def record_run(self, name: str, fn: str, kwargs: Dict,
                   results: Optional[Dict] = None) -> None:
        """Append a run record: the function, its arguments, its results."""
        self._registry["models"][name]["runs"].append({
            "fn": fn,
            "kwargs": kwargs,
            "results": results or {},
            "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
        self._flush()

    def get_runs(self, name: str) -> List[Dict]:
        return list(self._registry["models"][name]["runs"])

    def num_training_runs(self, name: str) -> int:
        return len(self._registry["models"][name]["runs"])

    def get_config(self, name: str) -> Dict:
        return dict(self._registry["models"][name]["config"])

    def update_config(self, name: str, config: Dict) -> None:
        """Re-register a model's config (a driver re-run with changed flags
        that retrains rather than resumes)."""
        self._registry["models"][name]["config"] = dict(config)
        self._flush()

    def resume_or_register(self, name: str, config: Dict,
                           volatile: tuple = ("workdir", "quick")) -> bool:
        """True iff a checkpoint trained under the same ``config`` exists
        (the caller should :meth:`restore` it); otherwise (re)registers
        ``config`` and returns False (the caller should train). ``volatile``
        keys (paths, smoke-run switches) are left out of the comparison.

        Resuming by name alone would reuse a checkpoint trained under other
        data, size or schedule flags. When the config changed, the stale
        checkpoint pointer is dropped at once: a retrain interrupted before
        its first save must not leave the next same-config invocation a
        pointer to the old config's checkpoint."""
        cur = {k: v for k, v in config.items() if k not in volatile}
        if self.has_model(name):
            stored = {k: v for k, v in self.get_config(name).items() if k not in volatile}
            if self.latest_step(name) and stored == cur:
                return True
            if stored != cur:
                print(f"[manager] config changed for {name!r}; retraining "
                      "(stale checkpoint ignored)")
                self._registry["models"][name]["latest_step"] = None
            self.update_config(name, config)
            return False
        self.add_new_model(name, config)
        return False

    # ---- checkpoints ----
    def _ckpt_path(self, name: str, step: int) -> str:
        return os.path.join(self.root, name, "checkpoints", f"{step}.pt")

    def save(self, name: str, state, step: int) -> None:
        """Checkpoint ``state`` (a :class:`TrainState`, or a tree of dicts,
        lists and tuples of tensors) at ``step``."""
        if name not in self._registry["models"]:
            raise KeyError(f"unknown model {name!r}; call add_new_model first")
        if isinstance(state, TrainState):
            payload = {"train_state": {f: _to_cpu(getattr(state, f)) for f in _STATE_FIELDS}}
        else:
            payload = {"tree": _to_cpu(state)}
        path = self._ckpt_path(name, step)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(payload, path + ".tmp")
        os.replace(path + ".tmp", path)
        self._registry["models"][name]["latest_step"] = step
        self._flush()

    def latest_step(self, name: str) -> Optional[int]:
        return self._registry["models"][name].get("latest_step")

    def restore(self, name: str, template, step: Optional[int] = None):
        """Restore checkpoint ``step`` (default: the latest) into
        ``template`` (a :class:`TrainState` or the tree that was saved, its
        tensors on the device the result should live on): the stored
        tensors are copied into the template's in place, and a TrainState
        comes back with the stored step, optimizer count and carry."""
        if step is None:
            step = self.latest_step(name)
        if step is None:
            raise FileNotFoundError(f"no checkpoint for model {name!r}")
        payload = torch.load(self._ckpt_path(name, step), map_location="cpu",
                             weights_only=True)
        if isinstance(template, TrainState):
            stored = payload["train_state"]
            return TrainState(**{f: _copy_into(getattr(template, f), stored[f], f)
                                 for f in _STATE_FIELDS})
        return _copy_into(template, payload["tree"])
